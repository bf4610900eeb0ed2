"""Port parity for SCN training: ``segmentation_loss`` and the U-Net's
gradients through the ``reference`` backend (untiled plans, as the JAX
example trains) against ``jax.value_and_grad`` on the CPU, and the port's
own SGD run and example."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.models.scn import segmentation_loss as jsegmentation_loss
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.kernels.sspnna.sspnna import sspnna_fused
from repro_torch.models.scn import (
    SCNUNet,
    UNetConfig,
    miou,
    params_from_jax,
    segmentation_loss,
)
from repro_torch.sparse.tensor import SparseVoxelTensor

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("all_masked", [False, True])
def test_segmentation_loss_matches_jax(all_masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(300, N_CLASSES)) * 3).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 300).astype(np.int32)
    mask = np.zeros(300, bool) if all_masked else rng.random(300) < 0.7
    want = jsegmentation_loss(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(mask))
    got = segmentation_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _param_pairs(model: SCNUNet, tree: dict):
    """(name, port parameter, JAX leaf) for every parameter, walking the
    JAX ``init_unet`` tree as ``params_from_jax`` does."""
    def conv(name, c, t):
        return [(f"{name}.weight", c.weight, t[0]),
                (f"{name}.bias", c.bias, t[1])]

    def block(name, b, t):
        return conv(f"{name}.conv", b.conv, t["conv"]) + [
            (f"{name}.bn_scale", b.bn_scale, t["bn_scale"]),
            (f"{name}.bn_offset", b.bn_offset, t["bn_offset"])]

    pairs = conv("stem", model.stem, tree["stem"])
    for li, (lvl, t) in enumerate(zip(model.levels, tree["levels"],
                                      strict=True)):
        for part in ("enc", "dec"):
            for r, (b, bt) in enumerate(zip(getattr(lvl, part),
                                            t.get(part, []), strict=True)):
                pairs += block(f"levels.{li}.{part}.{r}", b, bt)
        if lvl.down is not None:
            pairs += conv(f"levels.{li}.down", lvl.down, t["down"])
            pairs += conv(f"levels.{li}.up", lvl.up, t["up"])
    pairs += [("head.w", model.head.w, tree["head"]["w"]),
              ("head.b", model.head.b, tree["head"]["b"])]
    return pairs


def test_unet_gradients_match_jax():
    """The JAX example's config (widths 16-48, one block a level, resolution
    32, capacity 4096) on an untiled plan: the loss and accuracy within
    1e-5, and every gradient leaf within 1e-3 of its largest entry (f32
    sums in other orders, and a BatchNorm after every conv, whose backward
    divides by the channel's std), through ``reference`` only. The biases
    of the convs a BatchNorm follows have a gradient of 0; both sides must
    hold only rounding there."""
    kw = dict(widths=(16, 32, 48), reps=1, resolution=32, capacity=4096,
              n_classes=N_CLASSES)
    coords, feats, labels, mask = make_scene(0, 32, 4096)
    jplan = jengine.build_scene_plan(
        JSparseVoxelTensor(jnp.asarray(coords), jnp.asarray(feats),
                           jnp.asarray(mask)), JUNetConfig(**kw),
        plan_tiles=False)
    tree = init_unet(jax.random.PRNGKey(0), JUNetConfig(**kw))

    def jloss(p):
        return jsegmentation_loss(jengine.apply_unet(p, jnp.asarray(feats),
                                                     jplan),
                                  jnp.asarray(labels), jnp.asarray(mask))

    (jl, jacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    cfg = UNetConfig(**kw)
    model = params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu")
    plan = engine.upload_scene_plan(engine.build_scene_plan_host(
        SparseVoxelTensor(coords, feats, mask), cfg, plan_tiles=False),
        device="cpu")
    assert all(lvl.sub.tiles is None for lvl in plan.levels)
    launches = sspnna_fused.launches
    loss, acc = segmentation_loss(
        engine.apply_unet(model, feats, plan, device="cpu"), labels, mask)
    loss.backward()
    assert sspnna_fused.launches == launches
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=1e-5)
    pairs = _param_pairs(model, jgrads)
    assert len(pairs) == len(list(model.parameters()))
    largest = max(np.abs(np.asarray(jg)).max() for _, _, jg in pairs)
    for name, param, jg in pairs:
        jg, g = np.asarray(jg), param.grad.numpy()
        if name.endswith(".conv.bias"):
            # a BatchNorm follows the conv and subtracts each channel's
            # mean, so this gradient is exactly 0: both sides hold only
            # rounding, which no relative error can compare
            assert max(np.abs(g).max(), np.abs(jg).max()) <= 1e-6 * largest
            continue
        err = np.abs(g - jg).max() / np.abs(jg).max()
        assert err <= 1e-3, (name, err)


def test_unet_learns_scene():
    """The port's own 15 SGD steps at lr 0.3 (``tests/test_scn.py``'s run):
    the loss falls by 0.5 and the held-in mIoU passes 0.15."""
    coords, feats, labels, mask = make_scene(0, resolution=24, capacity=3000)
    cfg = UNetConfig(widths=(8, 16, 24), reps=1, resolution=24,
                     capacity=3000, n_classes=N_CLASSES)
    plan = engine.upload_scene_plan(engine.build_scene_plan_host(
        SparseVoxelTensor(coords, feats, mask), cfg, plan_tiles=False),
        device="cpu")
    model = SCNUNet(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    losses = []
    for _ in range(15):
        model.zero_grad()
        loss, _ = segmentation_loss(
            engine.apply_unet(model, feats, plan, device="cpu"), labels, mask)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.3 * p.grad)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.5
    with torch.no_grad():
        pred = engine.apply_unet(model, feats, plan, device="cpu").argmax(-1)
    assert miou(pred.numpy(), labels, mask, cfg.n_classes) > 0.15


@pytest.mark.parametrize("example,args", [
    ("train_scn_torch.py", ["--steps", "4", "--scenes", "2", "--res", "24",
                            "--cap", "3000"]),
    ("lm_train_torch.py", ["--steps", "3"]),
])
def test_training_examples_run_on_the_cpu(example, args):
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device", "cpu",
         *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert ("held-out mIoU" if example == "train_scn_torch.py"
            else "step    2 loss") in res.stdout
