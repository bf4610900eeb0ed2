"""The references against the program at small sizes on the CPU: the SCN
U-Net's logits through the program's planner and ``apply_unet``, and the
decoder's prefill logits and greedy tokens through its ``Engine``."""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.families import decoder_lm, scn_unet
from portbench.reference import decoder_lm as lm_ref
from portbench.reference import scn_unet as scn_ref
from portbench.tests.conftest import LM, SCN, SMALL

CPU = torch.device("cpu")


def config_of(cell: str) -> dict:
    base = harness.cell_files(harness.load_benchmark(), cell)["config"]
    return {**base, **SMALL[cell][0]}


def test_scn_reference_equals_the_program():
    from repro_torch import engine
    from repro_torch.models.scn import SCNUNet, UNetConfig
    from repro_torch.sparse.tensor import SparseVoxelTensor

    base = config_of(SCN)
    cfg = UNetConfig(resolution=base["spatial_size"],
                     capacity=base["capacity"], **scn_unet.unet_shape(base))
    weights = scn_unet.make_weights(base, 5, CPU)
    model = SCNUNet(cfg, device=CPU)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    mix = {"pool": SMALL[SCN][1]["pool"]}
    shape = scn_unet.unet_shape(base)
    for coords, feats, _, mask in scn_unet.room_pool(base, mix):
        t = SparseVoxelTensor(coords, feats, mask)
        spec = engine.build_plan_spec([t], cfg)
        plan = engine.upload_scene_plan(engine.build_scene_plan_host(
            t, cfg, spec=spec, plan_tiles=True), CPU)
        with torch.inference_mode():
            got = engine.apply_unet(model, torch.from_numpy(feats), plan,
                                    device=CPU).numpy()[mask]
        rb = scn_ref.Rulebooks(torch.from_numpy(coords[mask]),
                               base["spatial_size"], len(shape["widths"]))
        want = scn_ref.forward(weights, rb, torch.from_numpy(feats[mask]),
                               len(shape["widths"]), shape["reps"]).numpy()
        assert scn_unet.rel_err(got, want) < 1e-5


def test_scn_rulebook_pairs_by_hand():
    # two voxels side by side on x: each is the other's neighbour, and one
    # coarse voxel holds both
    rb = scn_ref.Rulebooks(torch.tensor([[0, 0, 0], [1, 0, 0]]), 4, 2)
    assert rb.pairs() == {"sub": [4, 1], "down": [2], "rows": [2, 1]}
    assert rb.plane[0].tolist() == [0, 4]


def test_decoder_reference_equals_the_program_prefill():
    from repro_torch.models.transformer import forward

    config = {**config_of(LM), "torch_dtype": "float32"}
    cfg = decoder_lm.port_config(config)
    weights = decoder_lm.make_weights(config, 3, CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 12))).int()
    with torch.inference_mode():
        got, _, _ = forward(weights, cfg, toks, mode="prefill")
    want = lm_ref.logits_at(weights, decoder_lm.shape(config), toks,
                            slice(0, 12))
    assert torch.allclose(got[..., :512], want, atol=1e-4, rtol=1e-4)


def test_served_tokens_are_the_references_greedy_tokens(small_run):
    r = small_run(LM, seed=99)
    assert r["correct"] and r["checks"]["token_logit_gap"]["value"] < 0.05
