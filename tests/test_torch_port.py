"""Port parity for the slice as a whole: scenes, host plans and U-Net logits
of ``repro_torch`` against ``repro``, plus the port's package rules (no JAX
import, no silent CPU fallback)."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.data.scenes import make_scene as jmake_scene
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles
from repro_torch.models.scn import SCNUNet, UNetConfig, params_from_jax
from repro_torch.sparse.tensor import SparseVoxelTensor

ROOT = Path(__file__).resolve().parents[1]
# the test config: small enough for interpret mode, and a small SPADE
# budget so both levels dispatch to the tiled sspnna path
RES, CAP, BUDGET = 24, 2048, 16 * 1024
CFG = dict(widths=(8, 16), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)


@pytest.mark.parametrize("args", [(0, 24, 2048), (1, 64, 8192),
                                  (2, 32, 4096, 2e5)])
def test_make_scene_byte_equal(args):
    for got, want in zip(make_scene(*args), jmake_scene(*args), strict=True):
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def _host_plans(**kw):
    coords, feats, labels, mask = make_scene(0, resolution=RES, capacity=CAP)
    ours = engine.build_scene_plan_host(
        SparseVoxelTensor(coords, feats, mask), UNetConfig(**CFG), **kw)
    theirs = jengine.build_scene_plan_host(
        JSparseVoxelTensor(coords, feats, mask), JUNetConfig(**CFG), **kw)
    return feats, mask, ours, theirs


@pytest.fixture(scope="module")
def plans():
    return _host_plans(mem_budget=BUDGET)


def _conv_leaves(cp):
    if cp is None:
        return []
    tiles = [] if cp.tiles is None else list(cp.tiles)
    return list(cp.coir) + tiles


@pytest.mark.parametrize("kw", [
    dict(mem_budget=BUDGET), dict(mem_budget=BUDGET, order="raster"),
    dict(mem_budget=BUDGET, order="active", soar_chunk=64), dict(),
    dict(plan_tiles=False)], ids=["soar", "raster", "active", "default",
                                  "untiled"])
def test_host_plan_equal_leaf_for_leaf(kw):
    _, _, ours, theirs = _host_plans(**kw)
    if kw.get("mem_budget") == BUDGET:
        assert any(lvl.sub.dispatch.backend == engine.SSPNNA
                   for lvl in ours.levels)
    assert len(ours.levels) == len(theirs.levels)
    for a, b in zip(ours.levels, theirs.levels):
        leaves_a = [a.coords, a.mask] + sum(
            (_conv_leaves(cp) for cp in (a.sub, a.down, a.up)), [])
        leaves_b = [b.coords, b.mask] + sum(
            (_conv_leaves(cp) for cp in (b.sub, b.down, b.up)), [])
        assert len(leaves_a) == len(leaves_b)
        for x, y in zip(leaves_a, leaves_b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        for cp_a, cp_b in ((a.sub, b.sub), (a.down, b.down), (a.up, b.up)):
            if cp_a is None:
                assert cp_b is None
                continue
            want = dataclasses.asdict(cp_b.dispatch)
            assert want.pop("block_n") == 0  # the port pins no N-block
            assert dataclasses.asdict(cp_a.dispatch) == want


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_apply_unet_matches_jax(plans, backend):
    feats, mask, ours, theirs = plans
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**CFG)))
    want = np.asarray(jengine.apply_unet(
        tree, feats, jengine.upload_scene_plan(theirs), backend=backend))
    model = params_from_jax(tree, UNetConfig(**CFG), device="cpu")
    plan = engine.upload_scene_plan(ours, device="cpu")
    launches = sspnna_fused.launches
    with torch.no_grad():
        got = engine.apply_unet(model, feats, plan, backend=backend,
                                device="cpu")
    assert sspnna_fused.launches == launches  # CPU: no kernel launches
    assert got.shape == (CAP, N_CLASSES)
    # f32 with BatchNorm after every conv, which amplifies reordered sums
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_apply_unet_without_kernel_matches_jax(plans):
    """``use_kernel=False`` runs every tiled conv through the pre-gathered
    plain branch in both packages; the logits agree with JAX's and with the
    port's kernel path, and no kernel wrapper counts a launch."""
    feats, mask, ours, theirs = plans
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**CFG)))
    want = np.asarray(jengine.apply_unet(
        tree, feats, jengine.upload_scene_plan(theirs), use_kernel=False))
    model = params_from_jax(tree, UNetConfig(**CFG), device="cpu")
    plan = engine.upload_scene_plan(ours, device="cpu")
    launches = sspnna_fused.launches, sspnna_tiles.launches
    with torch.no_grad():
        got = engine.apply_unet(model, feats, plan, use_kernel=False,
                                device="cpu")
        auto = engine.apply_unet(model, feats, plan, device="cpu")
    assert (sspnna_fused.launches, sspnna_tiles.launches) == launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-4, atol=1e-4)


def test_registry_falls_back_only_without_tiles(plans):
    _, _, ours, _ = plans
    lvl = ours.levels[0]
    reg = engine.default_registry().view()
    assert reg.resolve(lvl.sub, "auto") == lvl.sub.dispatch.backend
    assert reg.resolve(lvl.down, engine.SSPNNA) == engine.REFERENCE
    assert reg.resolve(lvl.sub, engine.SSPNNA) == engine.SSPNNA
    with pytest.raises(ValueError, match="not one of"):
        reg.resolve(lvl.sub, "nope")


def test_registry_refuses_a_second_backend_of_one_name():
    reg = engine.default_registry().view()
    with pytest.raises(ValueError, match="already registered"):
        reg.register(engine.SSPNNA, reg.get(engine.SSPNNA))
    with pytest.raises(ValueError, match="invalid backend name"):
        reg.register(engine.AUTO, reg.get(engine.REFERENCE))


def test_entry_points_raise_without_a_card(plans):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    feats, _, ours, _ = plans
    cfg = UNetConfig(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.upload_scene_plan(ours)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCNUNet(cfg)
    model = SCNUNet(cfg, device="cpu")
    plan = engine.upload_scene_plan(ours, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.apply_unet(model, feats, plan)


def test_apply_unet_rejects_a_plan_on_another_device(plans):
    feats, _, ours, _ = plans
    model = SCNUNet(UNetConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="upload the plan"):
        engine.apply_unet(model, feats, ours, device="cpu")  # host plan


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package."""
    src = ROOT / "src"
    modules = sorted(
        ".".join(f.relative_to(src).with_suffix("").parts).removesuffix(
            ".__init__")
        for f in (src / "repro_torch").rglob("*.py"))
    assert {"repro_torch.serving.engine", "repro_torch.models.transformer",
            "repro_torch.kernels.flash.flash", "repro_torch.engine.context",
            "repro_torch.serving.graphs", "repro_torch.engine.autotune",
            "repro_torch.serving.scene_engine",
            "repro_torch.training.train_loop"} <= set(modules)
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 30
    for f in files:
        assert not pattern.search(f.read_text()), f
