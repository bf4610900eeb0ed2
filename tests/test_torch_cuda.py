"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the paths that launch them.

Needs no JAX, so it runs on a machine with a card and without the JAX
package: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a card every test here skips.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import engine
from repro_torch.configs import get_config
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.kernels import build
from repro_torch.kernels.flash import flash
from repro_torch.kernels.flash.flash import flash_attention, flash_attention_plain
from repro_torch.kernels.flash.ref import FLASH_CASES, FLASH_TOL, random_qkv
from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
from repro_torch.kernels.moe_gemm.ref import (
    MOE_GEMM_CASES,
    grouped_gemm_ref,
    moe_gemm_tol,
    random_moe_inputs,
)
import _dist_worker
from conftest import make_shell_scene
from repro_torch.core import host_meta
from repro_torch.core.soar import soar_order
from repro_torch.core.sparse_conv import (
    SparseConvParams,
    reference_conv_cirf,
    submanifold_coir,
)
from repro_torch.core.tiles import build_tile_plan
from repro_torch.kernels.sspnna.ops import run_sspnna_conv
from repro_torch.kernels.sspnna.ref import (
    TILE_STACK_CASES,
    TILE_STACK_TOL,
    random_tile_stack,
    random_tile_tables,
)
from repro_torch.kernels.sspnna.sspnna import (
    sspnna_fused,
    sspnna_fused_plain,
    sspnna_tiles,
    sspnna_tiles_plain,
)
from repro_torch.data.tokens import TokenStream
from repro_torch.models import common, moe, transformer
from repro_torch.models.scn import SCNUNet, UNetConfig, segmentation_loss
from repro_torch.training import checkpoint, train_loop
from repro_torch.training.optimizer import OptHParams
from repro_torch.training.tree import tree_leaves_with_path, tree_map
from repro_torch.sparse.tensor import SparseVoxelTensor, from_dense

K = 27
# f32 sums of up to K*C products, taken in another order than the other side
TOL = dict(rtol=1e-5, atol=1e-5)


# (v, c, n, t, d_i, d_o): the stem's C=4, N=48 (not a power of two),
# a decoder's C=2N, one-slot tiles
SHAPES = [
    (96, 4, 16, 5, 32, 8),
    (128, 16, 48, 6, 40, 16),
    (160, 64, 32, 4, 64, 32),
    (64, 8, 8, 3, 4, 1),
]
# on the card only: dO=512 (two slots a thread, two chunks), C and N not
# multiples of 4 with a partial last chunk, N=64 at dO=32 (512 threads)
CARD_SHAPES = [
    (16384, 32, 32, 24, 160, 512),
    (8192, 6, 18, 30, 48, 300),
    (4096, 64, 64, 40, 96, 32),
]


@pytest.fixture
def cuda_device():
    """The card, with the flags these tests rely on set for the test and
    restored after it, so no test sees what an earlier one left: f32
    matmuls and convolutions in full f32 (TF32 keeps ~3 digits, and the
    checks hold 1e-4 to 1e-5), and no sync debug mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32,
             torch.cuda.get_sync_debug_mode())
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield torch.device("cuda")
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved[:2]
        torch.cuda.set_sync_debug_mode(saved[2])


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "feats_off_16B"])
@pytest.mark.parametrize("shape", SHAPES + CARD_SHAPES,
                         ids=lambda s: "v{}c{}n{}t{}i{}o{}".format(*s))
def test_cuda_kernel_matches_plain(cuda_device, shape, aligned):
    v, c, n, t, d_i, d_o = shape
    rng = np.random.default_rng(sum(shape))
    arrays = random_tile_tables(rng, v=v, c=c, n=n, t=t, d_i=d_i, d_o=d_o)
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.from_numpy(x).to(cuda_device) for x in arrays)
    if not aligned:  # a contiguous view 4 bytes into its storage
        flat = torch.empty(feats.numel() + 1, device=cuda_device)
        flat[1:] = feats.reshape(-1)
        feats = flat[1:].view(v, c)
    launches = sspnna_fused.launches
    got = sspnna_fused(feats, weights, out_rows, in_rows, local_idx, counts,
                       n_out=v)
    torch.cuda.synchronize()
    assert sspnna_fused.launches == launches + 1
    want = sspnna_fused_plain(feats, weights, out_rows, in_rows, local_idx,
                              counts, n_out=v)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_apply_unet_on_card_matches_cpu(cuda_device):
    """The small test config through the card's kernel and the CPU's plain
    version, with the same seeded weights and the same host plan."""
    cfg = UNetConfig(widths=(8, 16), reps=1, resolution=24, capacity=2048,
                     n_classes=N_CLASSES)
    coords, feats, _, mask = make_scene(0, resolution=24, capacity=2048)
    host = engine.build_scene_plan_host(SparseVoxelTensor(coords, feats, mask),
                                        cfg, mem_budget=16 * 1024)
    n_sspnna = sum(lvl.sub.dispatch.backend == engine.SSPNNA
                   for lvl in host.levels)
    assert n_sspnna == 2
    logits = {}
    launches = sspnna_fused.launches
    for dev in ("cpu", cuda_device):
        model = SCNUNet(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits[str(dev)] = engine.apply_unet(
                model, feats, engine.upload_scene_plan(host, dev),
                device=dev).cpu().numpy()
    torch.cuda.synchronize()
    # stem + enc + dec at level 0, enc at level 1
    assert sspnna_fused.launches - launches == 4
    np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


def tile_case_id(case):
    t, d_i, d_o, k, c, n, dt = case
    return f"t{t}i{d_i}o{d_o}k{k}c{c}n{n}-{str(dt).removeprefix('torch.')}"


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "feats_off_16B"])
@pytest.mark.parametrize("case", TILE_STACK_CASES, ids=tile_case_id)
def test_tiles_kernel_matches_plain(cuda_device, case, aligned):
    """f32 and bf16, K 27 and 8, ragged C and N, all-hole tiles (tile 0),
    and a feature base off the kernel's vector alignment."""
    t, d_i, d_o, k, c, n, dt = case
    feats, idx, w = (x.to(cuda_device) for x in random_tile_stack(
        np.random.default_rng(t * d_i + c), t=t, d_i=d_i, d_o=d_o, k=k, c=c,
        n=n, dtype=dt))
    if not aligned:  # a contiguous view one element into its storage
        flat = torch.empty(feats.numel() + 1, dtype=dt, device=cuda_device)
        flat[1:] = feats.reshape(-1)
        feats = flat[1:].view(t, d_i, c)
    launches = sspnna_tiles.launches
    got = sspnna_tiles(feats, idx, w)
    torch.cuda.synchronize()
    assert sspnna_tiles.launches == launches + 1
    assert got.dtype == dt and not got[0].any()
    want = sspnna_tiles_plain(feats, idx, w)
    tol = TILE_STACK_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_tiles_kernel_rejects_non_contiguous_input(cuda_device):
    feats, idx, w = (x.to(cuda_device) for x in random_tile_stack(
        np.random.default_rng(0), t=2, d_i=16, d_o=8, k=27, c=8, n=16))
    wide = torch.cat([feats, feats], dim=2)[:, :, :8]  # strided view
    assert not wide.is_contiguous()
    launches = sspnna_tiles.launches
    with pytest.raises(ValueError, match="contiguous"):
        sspnna_tiles(wide, idx, w)
    assert sspnna_tiles.launches == launches


@pytest.mark.cuda
def test_plane_split_conv_through_kernel_matches_reference(cuda_device):
    """A shell scene's COIR built on the card (equal to the host twin), an
    unbudgeted plan with delta_i = 16 < 27 that splits rows across plane
    groups, and the accumulating pre-gathered conv through the kernel
    against the reference product (rows masked, no bias)."""
    dense = make_shell_scene(np.random.default_rng(0), 18, 8)
    t = from_dense(dense, device=cuda_device)
    coir = submanifold_coir(t, 18)
    idx, mask = coir.indices.cpu().numpy(), t.mask.cpu().numpy()
    coords = t.coords.cpu().numpy()
    np.testing.assert_array_equal(idx, host_meta.build_cirf_np(
        coords, mask, coords, mask, host_meta.kernel_offsets(3), 18).indices)
    tp = build_tile_plan(idx, soar_order(idx, mask, 64).order, 8, 16)
    assert tp.n_row_splits > 0
    w = (torch.randn((K, 8, 16), generator=torch.Generator().manual_seed(0))
         * 0.1).to(cuda_device)
    tables = [torch.from_numpy(x).to(cuda_device)
              for x in (tp.out_rows, tp.in_rows, tp.local_idx)]
    launches = sspnna_tiles.launches
    got = run_sspnna_conv(t.feats, w, *tables, n_out=t.capacity, fused=False)
    torch.cuda.synchronize()
    assert sspnna_tiles.launches == launches + 1
    ref = reference_conv_cirf(t.feats, coir, SparseConvParams(
        w, torch.zeros(16, device=cuda_device)))
    np.testing.assert_allclose(got.cpu().numpy()[mask],
                               ref.cpu().numpy()[mask], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_kernel_on_a_hierarchical_soar_plan(cuda_device):
    """Level 0 of a small scene (2,412 voxels) in hierarchical SOAR order
    (chunks of 128 inside 2048): its own attributes through ``explore`` and
    ``dispatch_from_dataflow`` give a tiled ``sspnna`` plan, which
    ``conv_plan_for_layer`` builds on the card; the kernel's launch is held
    against its plain version (max abs / max(|want|, 1) within 1e-4, the
    kernel's tolerance) and the conv against the reference backend."""
    from repro_torch.core import spade
    from repro_torch.core.coir import kernel_offsets_np
    from repro_torch.core.soar import soar_hierarchical

    coords, _, _, mask = make_scene(0, resolution=64, capacity=8192)
    sub = host_meta.build_cirf_np(coords, mask, coords, mask,
                                  kernel_offsets_np(3), 64)
    order = soar_hierarchical(sub.indices, mask, [128, 2048]).order
    attrs = spade.extract_attributes(sub.indices, mask, order)
    v, c = int(mask.sum()), 16
    df = spade.explore(spade.LayerSpec("L0", v, v, K, c, c, 2),
                       {"CIRF": attrs, "CORF": attrs}, 64 * 1024)
    d = engine.dispatch_from_dataflow(df, attrs, v)
    assert d.backend == engine.SSPNNA and d.delta_o < v
    cp = engine.conv_plan_for_layer(sub, order, d.delta_o, d.delta_i,
                                    walk=d.walk, device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(len(mask), c, generator=gen)
         * torch.from_numpy(mask)[:, None]).to(cuda_device)
    p = SparseConvParams(*(t.to(cuda_device) for t in (
        torch.randn(K, c, c, generator=gen) / (K * c) ** 0.5,
        torch.randn(c, generator=gen))))
    args = (x, p.weight, *cp.tiles)
    launches = sspnna_fused.launches
    got = sspnna_fused(*args, n_out=len(mask))
    conv = engine.sparse_conv(x, p, cp, backend="sspnna")
    torch.cuda.synchronize()
    assert sspnna_fused.launches == launches + 2
    want = sspnna_fused_plain(*args, n_out=len(mask))
    assert float((got - want).abs().max()
                 / want.abs().max().clamp(min=1.0)) <= 1e-4
    ref = engine.sparse_conv(x, p, engine.reference_plan(cp.coir))
    np.testing.assert_allclose(conv.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# The SSpNNA kernels' edges, on the card only (kept out of
# TILE_STACK_CASES, which the CPU tests also hold against the JAX
# package): (name, t, d_i, d_o, k, c, n, dtype). A block owns 16-128
# consecutive (tile, slot) rows and a slice of N, chosen from T * dO and N,
# and copies rows in 16-, 4- or 2-byte pieces as C, N and the base allow.
SSPNNA_EDGE_CASES = [
    # 128-row blocks spanning 16 tiles of dO=8, dead tiles and pad slots
    ("span", 5000, 16, 8, 27, 8, 16, torch.float32),
    # a tile of dO=512 split over several blocks
    ("d_o512", 6, 200, 512, 27, 32, 16, torch.float32),
    # two planes all holes everywhere, every third plane all holes in
    # the first half of the tiles: whole blocks skip planes
    ("holed", 40, 64, 32, 27, 16, 32, torch.float32),
    # few tiles, wide N (the coarsest level's grid), N split across blocks
    ("few_wide", 4, 96, 32, 27, 64, 64, torch.float32),
    ("split_n", 3, 64, 32, 27, 48, 128, torch.float32),
    # C and N off the product's steps; slots of a tile cut by a block edge
    ("c4n18", 12, 32, 24, 27, 4, 18, torch.float32),
    ("c6n20", 12, 32, 24, 27, 6, 20, torch.float32),
    ("c9n20", 12, 32, 24, 27, 9, 20, torch.float32),
    ("c12n18", 12, 32, 24, 27, 12, 18, torch.float32),
    # bf16 stacks: 4-byte rows, odd N (2-byte weight rows), 16-byte rows
    ("c12n20_bf16", 12, 32, 24, 27, 12, 20, torch.bfloat16),
    ("c4n18_bf16", 12, 32, 24, 8, 4, 18, torch.bfloat16),
    ("c6n9_bf16", 12, 32, 24, 27, 6, 9, torch.bfloat16),
    ("c96n48_bf16", 10, 64, 32, 27, 96, 48, torch.bfloat16),
]
SSPNNA_EDGE_F32 = [x for x in SSPNNA_EDGE_CASES if x[7] == torch.float32]


def edge_tables(case):
    """``random_tile_tables`` for an edge case, as numpy arrays, with the
    "holed" case's planes cleared and its pair counts recounted."""
    name, t, d_i, d_o, k, c, n, _ = case
    v = 2 * t * d_o + d_i
    arrays = list(random_tile_tables(
        np.random.default_rng(t * d_o + c * n), v=v, c=c, n=n, t=t,
        d_i=d_i, d_o=d_o, k=k, dead_p=0.25))
    if name == "holed":
        idx = arrays[4]
        idx[:, :, [0, k - 1]] = -1
        idx[: t // 2, :, 1::3] = -1
        arrays[5] = (idx >= 0).sum(axis=(1, 2)).astype(np.int32)
    return v, arrays


def off_16b(x):
    """A contiguous copy of x that starts one element into its storage."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "feats_off_16B"])
@pytest.mark.parametrize("case", SSPNNA_EDGE_F32, ids=lambda x: x[0])
def test_fused_kernel_edges(cuda_device, case, aligned):
    v, arrays = edge_tables(case)
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.from_numpy(x).to(cuda_device) for x in arrays)
    if not aligned:
        feats = off_16b(feats)
    launches = sspnna_fused.launches
    got = sspnna_fused(feats, weights, out_rows, in_rows, local_idx, counts,
                       n_out=v)
    torch.cuda.synchronize()
    assert sspnna_fused.launches == launches + 1
    want = sspnna_fused_plain(feats, weights, out_rows, in_rows, local_idx,
                              counts, n_out=v)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "feats_off_16B"])
@pytest.mark.parametrize("case", SSPNNA_EDGE_CASES, ids=lambda x: x[0])
def test_tiles_kernel_edges(cuda_device, case, aligned):
    name, t, d_i, d_o, k, c, n, dt = case
    _, arrays = edge_tables(case)
    feats, idx, w = (x.to(cuda_device) for x in random_tile_stack(
        np.random.default_rng(t + d_i + c), t=t, d_i=d_i, d_o=d_o, k=k, c=c,
        n=n, dtype=dt))
    idx = torch.from_numpy(arrays[4]).to(cuda_device)  # the case's holes
    if not aligned:
        feats = off_16b(feats)
    launches = sspnna_tiles.launches
    got = sspnna_tiles(feats, idx, w)
    torch.cuda.synchronize()
    assert sspnna_tiles.launches == launches + 1
    want = sspnna_tiles_plain(feats, idx, w)
    dead = (idx < 0).all(dim=2)
    assert got.dtype == dt and not got[dead].any()
    tol = TILE_STACK_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSPNNA_EDGE_F32, ids=lambda x: x[0])
def test_tiles_on_gathered_stack_equal_fused_bit_for_bit(cuda_device, case):
    """sspnna_tiles on the stack that run_sspnna_conv(fused=False) gathers
    gives every live slot the fused kernel's value exactly: one tile body,
    one launch geometry, one order of sums."""
    v, arrays = edge_tables(case)
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.from_numpy(x).to(cuda_device) for x in arrays)
    fused = sspnna_fused(feats, weights, out_rows, in_rows, local_idx,
                         counts, n_out=v)
    stack = torch.where((in_rows >= 0).unsqueeze(-1),
                        feats[in_rows.clamp(min=0).long()], 0)
    tiles = sspnna_tiles(stack, local_idx, weights)
    torch.cuda.synchronize()
    live = (counts > 0).unsqueeze(1) & (out_rows >= 0)
    assert bool(live.any())
    assert torch.equal(tiles[live], fused[out_rows[live].long()])


def flash_case_id(case):
    b, sq, skv, hq, hkv, d, causal, window, cap, dt = case
    return (f"b{b}q{sq}k{skv}h{hq}x{hkv}d{d}{'c' if causal else 'n'}"
            f"w{window}s{cap}{str(dt).removeprefix('torch.')}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=flash_case_id)
def test_flash_kernel_matches_plain(cuda_device, case):
    b, sq, skv, hq, hkv, d, causal, window, cap, dt = case
    q, k, v = (x.to(cuda_device) for x in random_qkv(
        np.random.default_rng(sq + skv + d), b=b, sq=sq, skv=skv, hq=hq,
        hkv=hkv, d=d, dtype=dt))
    kw = dict(causal=causal, window=window, softcap=cap)
    launches = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q, k, v, **kw)
    tol = FLASH_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_raises_on_what_it_does_not_take(cuda_device):
    """No fallback hides the kernel: a bf16 call at a head dim above the
    largest instantiation or on a strided view raises in the wrapper, and
    the C entry refuses a head dim it has no kernel for (the wrapper pads
    such a dim first)."""
    q, k, v = (x.to(cuda_device) for x in random_qkv(
        np.random.default_rng(0), b=1, sq=64, skv=64, hq=2, hkv=1, d=64,
        dtype=torch.bfloat16))
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="head dim 288"):
        flash_attention(*(torch.cat([x] * 5, -1)[..., :288].contiguous()
                          for x in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q[:, ::2], k[:, ::2], v[:, ::2])
    out = torch.empty_like(q)
    err = flash._library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 1, 64,
        64, 2, 1, 48, 1, 0, 0.0, 48 ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    assert flash_attention.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("d,kd", [(120, 128), (96, 128), (48, 64)])
def test_flash_pads_a_head_dim_to_an_instance_without_spills(cuda_device, d,
                                                             kd):
    """A head dim between instantiations is one launch of the next one up
    (zero-padded q, k, v at the real dim's scale), within bf16's tolerance
    of the plain version, and that instantiation spills nothing."""
    q, k, v = (x.to(cuda_device) for x in random_qkv(
        np.random.default_rng(d), b=2, sq=130, skv=130, hq=8, hkv=2, d=d,
        dtype=torch.bfloat16))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, window=64)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.shape == q.shape and got.is_contiguous()
    want = flash_attention_plain(q, k, v, window=64)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max(
    ).clamp(min=1.0)
    assert float(err) <= FLASH_TOL[torch.bfloat16]
    report = build.ptxas_report(build.ptxas_log(flash.KERNEL).read_text())
    spills = [sp for name, (_, sp) in report.items()
              if "flash_fwd_bf16" in name and f"ILi{kd}E" in name]
    assert spills == [0]


def _prefill_outputs(cfg, toks, dev, attention_fn=None):
    """A reduced prefill's logits and caches, in the order of the
    comparison: logits, then each layer's k and v. ``attention_fn`` stands
    in for the flash wrapper (a CPU reference only)."""
    from repro_torch.models import attention

    params = transformer.init_lm(cfg, device=dev)
    flash_fn = attention.flash_attention_bshd
    if attention_fn is not None:
        attention.flash_attention_bshd = attention_fn
    try:
        with torch.inference_mode():
            logits, cache, _ = transformer.forward(
                params, cfg, toks.to(dev), mode="prefill", cache_pad=4)
    finally:
        attention.flash_attention_bshd = flash_fn
    return [logits] + [c[x] for c in cache["layers"] for x in ("k", "v")]


def _attention_f64(q, k, v, *, causal=True, window=None, softcap=None):
    """The flash kernel's function evaluated in f64 (scores, softmax and
    the PV product), returned in q's dtype."""
    from repro_torch.kernels.flash.ref import attention_mask

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / d ** 0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    p = torch.softmax(s.masked_fill(~mask, -torch.inf), -1).nan_to_num(0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _prefill_diagnosis(cfg, toks, i, got, want, bad) -> str:
    """Which side of a failing prefill comparison departs (ROADMAP queue 3
    item 10): the CPU reference (attention in f64) rerun in this process,
    and the CPU run with the f32 plain attention; the side farther from
    the rerun at the failing positions departs."""
    again = _prefill_outputs(cfg, toks, "cpu", _attention_f64)[i].numpy()
    plain = _prefill_outputs(cfg, toks, "cpu")[i].numpy()
    card_err = float(np.abs(got - again)[bad].max())
    cpu_err = float(np.abs(want - again)[bad].max())
    side = "card" if card_err > cpu_err else "CPU"
    where = [tuple(int(j) for j in ix) for ix in np.argwhere(bad)[:8]]
    return (f"output {i} ({'logits' if i == 0 else 'cache'}): {int(bad.sum())}"
            f" of {bad.size} past 1e-4, at {where}; the CPU reference rerun "
            f"in this process {'equals' if np.array_equal(again, want) else 'differs from'}"
            f" the first (max |diff| {float(np.abs(again - want).max()):.3g}); "
            f"against the rerun at those positions: card {card_err:.3g}, "
            f"CPU {cpu_err:.3g}, so the {side} side departs; the CPU with "
            f"f32 plain attention stands {float(np.abs(plain - again)[bad].max()):.3g}"
            f" from the rerun there")


@pytest.mark.cuda
def test_prefill_launches_flash_once_per_layer(cuda_device):
    """A reduced Gemma-2 prefill (window 32 < prompt 80, so the local
    layers mask the window) on the card: one kernel launch per layer, and
    the logits and caches of the CPU's reference, whose attention runs in
    f64 (the f32 plain attention on the CPU was not reproducible within
    one process after other work). A failure names the side that departs
    and where (``_prefill_diagnosis``)."""
    cfg = get_config("gemma2-2b").reduced()
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 80)))
    out = {}
    for dev in ("cpu", cuda_device):
        launches = flash_attention.launches
        out[str(dev)] = _prefill_outputs(
            cfg, toks, dev, _attention_f64 if dev == "cpu" else None)
        torch.cuda.synchronize()
        n = flash_attention.launches - launches
        assert n == (cfg.n_layers if dev == cuda_device else 0)
    for i, (got, want) in enumerate(zip(out["cuda"], out["cpu"],
                                        strict=True)):
        got, want = got.cpu().numpy(), want.numpy()
        bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
        if bad.any():
            pytest.fail(_prefill_diagnosis(cfg, toks, i, got, want, bad))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "moonshot-v1-16b-a3b"])
def test_lm_prefill_and_decode_step_wait_for_no_host_copy(cuda_device, arch):
    """A reduced prefill and one decode step on the card enqueue without a
    host sync: under sync debug mode "error" a blocking copy or a
    synchronize raises. The rope table starts empty, so its first fill is
    inside too."""
    cfg = get_config(arch).reduced()
    params = transformer.init_lm(cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda_device)
    common.rope_table.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            logits, cache, _ = transformer.forward(
                params, cfg, toks, mode="prefill", cache_pad=4)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
            logits, cache = transformer.decode_step(params, cfg, tok[:, None],
                                                    cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cache["pos"] == 41 and bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_f32_prefill_does_not_depend_on_what_ran_before(cuda_device):
    """A reduced Gemma-2 f32 prefill on the card gives the same logits, bit
    for bit, after a bf16 one as on a cleared rope table: no constant
    cached by one forward leaks into another."""
    cfg = get_config("gemma2-2b").reduced()
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 80))).to(cuda_device)
    params = transformer.init_lm(cfg, device=cuda_device)
    params16 = transformer.init_lm(cfg16, device=cuda_device)
    launches = flash_attention.launches
    with torch.inference_mode():
        common.rope_table.cache_clear()
        want = transformer.forward(params, cfg, toks, mode="prefill")[0]
        common.rope_table.cache_clear()
        transformer.forward(params16, cfg16, toks, mode="prefill")
        got = transformer.forward(params, cfg, toks, mode="prefill")[0]
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 3 * cfg.n_layers
    assert torch.equal(got, want)


def moe_case_id(case):
    e, c, d, f, share, dt, odt = case
    return (f"e{e}c{c}d{d}f{f}v{share}-{str(dt).removeprefix('torch.')}-"
            f"{str(odt).removeprefix('torch.')}")


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "x_off_16B"])
@pytest.mark.parametrize("case", MOE_GEMM_CASES, ids=moe_case_id)
def test_moe_gemm_kernel_matches_plain(cuda_device, case, aligned):
    e, c, d, f, share, dt, odt = case
    xin, w, valid = (x.to(cuda_device) for x in random_moe_inputs(
        np.random.default_rng(c + d + f), e=e, c=c, d=d, f=f,
        valid_share=share, dtype=dt))
    if not aligned:  # a contiguous view one element into its storage
        flat = torch.empty(xin.numel() + 1, dtype=dt, device=cuda_device)
        flat[1:] = xin.reshape(-1)
        xin = flat[1:].view(e, c, d)
    launches = grouped_gemm.launches
    got = grouped_gemm(xin, w, valid, out_dtype=odt)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == launches + 1
    assert got.dtype == odt and not got[~valid].any()
    want = grouped_gemm_ref(xin, w, valid, odt)
    tol = moe_gemm_tol(dt, odt)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_moe_prefill_launches_grouped_gemm_per_moe_layer(cuda_device):
    """A reduced Moonshot prefill on the card: three expert-GEMM launches
    per MoE layer, one flash launch per layer, and the logits, caches and
    aux of the CPU's plain versions."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    for dev in ("cpu", cuda_device):
        params = transformer.init_lm(cfg, device=dev)
        launches = grouped_gemm.launches, flash_attention.launches
        with torch.inference_mode():
            logits, cache, aux = transformer.forward(
                params, cfg, toks.to(dev), mode="prefill", cache_pad=4)
        torch.cuda.synchronize()
        n = (grouped_gemm.launches - launches[0],
             flash_attention.launches - launches[1])
        assert n == ((3 * cfg.n_layers, cfg.n_layers) if dev == cuda_device
                     else (0, 0))
        out[str(dev)] = ([logits] + [c[x] for c in cache["layers"]
                                     for x in ("k", "v")]
                         + [aux[k] for k in sorted(aux)])
    for got, want in zip(out["cuda"], out["cpu"], strict=True):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)


# (e, c, d, f, valid rows, dtype, out dtype), beyond MOE_GEMM_CASES: C on
# both sides of the bf16 kernels' switch at 64 rows (8, 16, 63 | 64, 65)
# and Moonshot's prefill C = 968 (eight 128-row tiles); d and f that are no
# multiple of the 64-deep steps, the 64-column slabs or the 128-column
# tiles (f = 129 and d = 45 also take the 2-byte copies); valid rows as
# the dispatch lays them out ("prefix2": each of two groups fills a prefix
# of its half, one expert none, one all), at random ("random"), with
# expert 0 empty ("empty0"), or all valid ("all").
MOE_EDGE_CASES = [
    (6, 8, 136, 200, "prefix2", torch.bfloat16, torch.float32),
    (5, 16, 72, 264, "empty0", torch.bfloat16, torch.bfloat16),
    (4, 63, 200, 130, "random", torch.bfloat16, torch.float32),
    (4, 63, 45, 77, "empty0", torch.bfloat16, torch.bfloat16),
    (3, 64, 136, 200, "prefix2", torch.bfloat16, torch.float32),
    (3, 65, 200, 136, "empty0", torch.bfloat16, torch.bfloat16),
    (3, 65, 45, 101, "prefix2", torch.bfloat16, torch.float32),
    (4, 968, 264, 392, "prefix2", torch.bfloat16, torch.float32),
    (4, 968, 200, 136, "random", torch.bfloat16, torch.bfloat16),
    (2, 300, 1000, 264, "random", torch.bfloat16, torch.bfloat16),
    (3, 129, 64, 129, "all", torch.bfloat16, torch.float32),
]


def edge_valid(rng, e, c, layout):
    """valid (E, C) bool laid out as ``layout`` (see MOE_EDGE_CASES)."""
    if layout == "all":
        return np.ones((e, c), bool)
    if layout != "prefix2":
        valid = rng.random((e, c)) < 0.6
        if layout == "empty0":
            valid[0] = False
        return valid
    valid = np.zeros((e, c), bool)
    for lo, hi in ((0, c // 2), (c // 2, c)):
        n = rng.integers(0, hi - lo + 1, e)
        n[0], n[-1] = 0, hi - lo
        for i in range(e):
            valid[i, lo:lo + n[i]] = True
    return valid


def edge_inputs(case, dev):
    e, c, d, f, layout, dt, _ = case
    rng = np.random.default_rng(e * c + d + f)
    xin, w, _ = random_moe_inputs(rng, e=e, c=c, d=d, f=f, valid_share=1.0,
                                  dtype=dt)
    valid = torch.from_numpy(edge_valid(rng, e, c, layout))
    return xin.to(dev), w.to(dev), valid.to(dev)


def moe_edge_id(case):
    e, c, d, f, layout, dt, odt = case
    return (f"e{e}c{c}d{d}f{f}-{layout}-{str(dt).removeprefix('torch.')}-"
            f"{str(odt).removeprefix('torch.')}")


def check_moe_gemm(xin, w, valid, odt):
    """One launch against the plain version at the case's tolerance;
    invalid rows exact zeros."""
    launches = grouped_gemm.launches
    got = grouped_gemm(xin, w, valid, out_dtype=odt)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == launches + 1
    assert got.dtype == odt and not got[~valid].any()
    want = grouped_gemm_ref(xin, w, valid, odt)
    tol = moe_gemm_tol(xin.dtype, odt)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "x_off_16B"])
@pytest.mark.parametrize("case", MOE_EDGE_CASES, ids=moe_edge_id)
def test_moe_gemm_edges(cuda_device, case, aligned):
    xin, w, valid = edge_inputs(case, cuda_device)
    check_moe_gemm(xin if aligned else off_16b(xin), w, valid, case[6])


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,odt", [(2048, 1408, torch.float32),
                                     (1408, 2048, torch.bfloat16)],
                         ids=["gate", "down"])
def test_moe_gemm_at_moonshot_prefill_width(cuda_device, d, f, odt):
    """Moonshot's prefill launch: 64 experts, two groups of 484 capacity
    slots each filled as a prefix, bf16 inputs drawn on the card."""
    e, c = 64, 968
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    xin = torch.randn(e, c, d, generator=gen, device=cuda_device).bfloat16()
    w = (0.1 * torch.randn(e, d, f, generator=gen,
                           device=cuda_device)).bfloat16()
    valid = torch.from_numpy(edge_valid(np.random.default_rng(d), e, c,
                                        "prefix2")).to(cuda_device)
    check_moe_gemm(xin, w, valid, odt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (4, 968, 264, 392, "prefix2", torch.bfloat16, torch.float32),
    (4, 63, 200, 130, "random", torch.bfloat16, torch.float32),
    (64, 8, 2048, 1408, "prefix2", torch.bfloat16, torch.float32),
    (16, 8, 1408, 2048, "prefix2", torch.bfloat16, torch.bfloat16),
], ids=moe_edge_id)
def test_moe_gemm_two_launches_equal_bit_for_bit(cuda_device, case):
    """The same inputs give the same sums, bit for bit: no sum depends on
    which block or warp finishes first."""
    xin, w, valid = edge_inputs(case, cuda_device)
    first = grouped_gemm(xin, w, valid, out_dtype=case[6])
    second = grouped_gemm(xin, w, valid, out_dtype=case[6])
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [40, 1], ids=["prefill", "decode"])
def test_apply_moe_waits_for_no_host_copy(cuda_device, tokens):
    """A reduced Moonshot MoE layer in bf16 (64 or 8 expert rows: both bf16
    kernels) enqueues its three expert products without a host sync, and
    agrees with the plain products on the same routing."""
    from repro_torch.models import moe

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    gen = torch.Generator(device=cuda_device).manual_seed(tokens)
    params = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                          "swiglu", torch.bfloat16, cuda_device)
    x = torch.randn(2, tokens, cfg.d_model, generator=gen,
                    device=cuda_device).bfloat16()
    cap = moe.moe_capacity(tokens, cfg.moe.top_k, cfg.moe.n_experts,
                           cfg.moe.capacity_factor)
    kw = dict(top_k=cfg.moe.top_k, capacity=cap, act="swiglu")
    launches = grouped_gemm.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            got, _ = moe.apply_moe(params, x, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert grouped_gemm.launches == launches + 3
    kernel = moe.grouped_gemm
    moe.grouped_gemm = lambda xin, w, valid, *, out_dtype=None: (
        grouped_gemm_ref(xin, w, valid, out_dtype))
    try:
        with torch.inference_mode():
            want, _ = moe.apply_moe(params, x, **kw)
    finally:
        moe.grouped_gemm = kernel
    assert (2 * cap < 64) == (tokens == 1)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= moe_gemm_tol(torch.bfloat16, torch.bfloat16)


# ---------------------------------------------------------------------------
# SCN batched serving and graph decode
# ---------------------------------------------------------------------------

SCN_SERVE_CFG = UNetConfig(widths=(16, 32, 48), reps=1, resolution=32,
                           capacity=4096, n_classes=N_CLASSES)


def _serve_scene(seed, n_active=None) -> SparseVoxelTensor:
    coords, feats, _, mask = make_scene(seed, 32, 4096)
    if n_active is not None:
        mask = mask.copy()
        mask[np.flatnonzero(mask)[n_active:]] = False
    return SparseVoxelTensor(coords, feats, mask)


@pytest.mark.cuda
def test_apply_unet_and_wave_forward_wait_for_no_host_sync(cuda_device):
    """One scene's forward and one wave's (three scenes' plans stacked),
    on the card with tiled convs through the kernel, enqueue without a host
    sync: under sync debug mode "error" a blocking copy, a synchronize or a
    data-dependent shape raises. A CUDA graph capture needs that."""
    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s, n) for s, n in ((300, None), (301, 900),
                                               (302, 1500))]
    spec = engine.build_plan_spec(scenes[:2], cfg)
    plans = [engine.build_scene_plan(t, cfg, spec=spec, device=cuda_device)
             for t in scenes]
    feats = [torch.from_numpy(t.feats).to(cuda_device) for t in scenes]
    model = SCNUNet(cfg, device=cuda_device)
    launches = sspnna_fused.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            one = engine.apply_unet(model, feats[0], plans[0],
                                    device=cuda_device)
            wave = engine.apply_unet(model, torch.cat(feats),
                                     engine.stack_plans(plans),
                                     device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    per_forward = 1 + 2 * (cfg.n_levels - 1) + 1   # stem, enc, dec
    assert sspnna_fused.launches - launches == 2 * per_forward
    assert wave.shape == (3 * cfg.capacity, cfg.n_classes)
    assert bool(torch.isfinite(wave).all()) and bool(torch.isfinite(one).all())


@pytest.mark.cuda
def test_scene_engine_graph_replay_matches_eager_wave(cuda_device):
    """A pinned-spec wave served on the card replays the bucket's CUDA
    graph: its logits match the eager wave forward within 1e-5, a second
    serve of the same scenes gives the same bits, and the launches counted
    at capture equal the eager wave's."""
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s, n) for s, n in ((310, None), (311, 700),
                                               (312, 1300))]
    spec = engine.build_plan_spec(scenes, cfg)
    model = SCNUNet(cfg, device=cuda_device)
    ctx = engine.ExecutionContext(device=cuda_device)

    def serve(sync):
        eng = SceneEngine(cfg, model, 3, spec=spec, ctx=ctx, sync=sync)
        handles = eng.submit([SceneRequest(i, t) for i, t in enumerate(scenes)])
        eng.serve()
        out = np.stack([h.result().logits for h in handles])
        eng.close()
        return eng, out

    eng, first = serve(True)
    assert eng.n_compilations == 1 and len(eng.graphs) == 1
    assert eng.graphs.replays == 1
    _, second = serve(False)   # another engine: its own graph
    np.testing.assert_array_equal(first, second)
    plans = [ctx.plan_cache.get_or_build(t, cfg, device=cuda_device,
                                         spec=spec, plan_tiles=True)
             for t in scenes]
    launches = sspnna_fused.launches
    with torch.inference_mode():
        want = engine.apply_unet(
            model, torch.cat([torch.from_numpy(t.feats) for t in scenes]),
            engine.stack_plans(plans), device=cuda_device)
    eager = sspnna_fused.launches - launches
    assert eager > 0
    key = eng.graph_key(cfg.capacity, plans[0])
    assert eng.graphs.keys() == [key]
    assert eng.graphs.launches(key)["sspnna_fused"] == eager
    assert eng.wave_stats[0].notes["graph_launches"] == {
        "sspnna_fused": eager}
    np.testing.assert_allclose(first.reshape(-1, cfg.n_classes),
                               want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    # a replay into the same buffers twice gives the same bits
    eng.submit([SceneRequest(9 + i, t) for i, t in enumerate(scenes)])
    eng.serve()
    again = np.stack([r.logits for r in eng.scheduler.completed[-3:]])
    np.testing.assert_array_equal(again, second)
    assert eng.graphs.replays == 2 and len(eng.graphs) == 1


class _AtenOps(TorchDispatchMode):
    """The names of the ATen ops dispatched while it is entered (a graph's
    replay dispatches none of the ops it holds)."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_scene_classes_come_from_the_bucket_graph(cuda_device):
    """A graph-replayed wave's classes are the argmax the bucket's graph
    takes: the graph returns the logits and their uint8 argmax, a wave run
    on it calls no argmax outside the graph (the ATen ops dispatched),
    each served scene's classes equal numpy's argmax of its read-back
    logits, and the wave reads back the logits' bytes and a byte a row."""
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s, n) for s, n in ((320, None), (321, 800))]
    spec = engine.build_plan_spec(scenes, cfg)
    ctx = engine.ExecutionContext(device=cuda_device)
    eng = SceneEngine(cfg, SCNUNet(cfg, device=cuda_device), 2, spec=spec,
                      ctx=ctx)
    handles = eng.submit([SceneRequest(i, t) for i, t in enumerate(scenes)])
    eng.serve()
    rows = 2 * cfg.capacity
    for h in handles:
        r = h.result()
        assert r.pred.dtype == np.int64 and r.pred.shape == (cfg.capacity,)
        np.testing.assert_array_equal(r.pred, r.logits.argmax(-1))
    (st,) = eng.wave_stats
    assert st.notes["pred_device_rows"] == rows
    assert st.readback_bytes == rows * cfg.n_classes * 4 + rows
    (key,) = eng.graphs.keys()
    assert eng.graphs.launches(key)["sspnna_fused"] > 0
    plans = [ctx.plan_cache.get_or_build(t, cfg, device=cuda_device,
                                         spec=spec, plan_tiles=True)
             for t in scenes]
    feats = [torch.from_numpy(t.feats).to(cuda_device) for t in scenes]
    with torch.inference_mode():
        with _AtenOps() as replayed:
            logits, pred = eng.run_wave(feats, plans, cfg.capacity)
        with _AtenOps() as eager:
            eng._classify(logits)
    assert eng.graphs.replays == 2 and eng.graphs.keys() == [key]
    assert "argmax" in eager.names and "clone" in replayed.names
    assert "argmax" not in replayed.names, sorted(replayed.names)
    assert pred.dtype == torch.uint8 and pred.shape == (rows,)
    np.testing.assert_array_equal(pred.cpu().numpy(),
                                  logits.cpu().numpy().argmax(-1))
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_serving_waves_time_their_device_work(cuda_device, sync):
    """The engines' own CUDA events on the card: a scene wave's forward
    and, where no later replay re-recorded them, the levels of the
    bucket's graph, which lie inside the forward and miss of it only the
    graph's start on the device, a fixed cost; an LM wave's prefill and
    decode, and each request's first token before its last."""
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s) for s in (310, 311)]
    eng = SceneEngine(cfg, SCNUNet(cfg, device=cuda_device), 2,
                      spec=engine.build_plan_spec(scenes, cfg),
                      ctx=engine.ExecutionContext(device=cuda_device),
                      sync=sync)
    eng.submit([SceneRequest(i, scenes[i % 2]) for i in range(6)])
    eng.serve()
    eng.close()
    segs = {"rows", "stem", "head"} | {f"level{i}"
                                       for i in range(len(cfg.widths))}
    assert eng.graphs.replays == len(eng.wave_stats) == 3
    for st in eng.wave_stats:
        assert st.pending == {}
        # the logits in f32 and a byte a row of classes
        assert st.readback_bytes == 2 * cfg.capacity * (cfg.n_classes * 4 + 1)
        forward = st.event_ms["forward"]
        assert forward > 0
        if len(st.event_ms) > 1:
            assert set(st.event_ms) == segs | {"forward"}
            levels = sum(v for k, v in st.event_ms.items() if k != "forward")
            assert forward - 1.0 <= levels <= forward + 0.005, (levels,
                                                                forward)
    assert len(eng.wave_stats[-1].event_ms) > 1   # the last replay's levels

    lm_cfg = get_config("stablelm-1.6b").reduced()
    params = transformer.init_lm(
        lm_cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    lm = Engine(lm_cfg, params, 2, 16, 4, device=cuda_device, sync=sync)
    rng = np.random.default_rng(2)
    handles = lm.submit([Request(i, rng.integers(1, 100, 9).astype(np.int32))
                         for i in range(4)])
    lm.serve()
    lm.close()
    assert lm.graphs.replays == 3 * len(lm.wave_stats)
    for st in lm.wave_stats:
        assert st.event_ms["prefill"] > 0 and st.event_ms["decode"] > 0
        assert len(st.first_token_ms) == 2
    for h in handles:
        r = h.result()
        (st,) = [w for w in lm.wave_stats if r.rid in w.rids]
        first = st.first_token_ms[st.rids.index(r.rid)]
        assert r.admit_ts - r.submit_ts < first < r.latency_ms


@pytest.mark.cuda
def test_scene_engine_streams_through_the_bucket_graph(cuda_device):
    """Two interleaved LiDAR streams on a pinned spec, served on the card:
    every wave (one frame of each stream) is a replay of the bucket's one
    graph, which runs sspnna_fused; a one-shot scene afterwards replays the
    same graph; each frame's logits match its own ``apply_unet`` on the
    from-scratch plan of the re-packed frame within 1e-4; and a pipelined
    serve on another engine gives the same bits."""
    from repro_torch.core.host_meta import pack_stream_frame_np
    from repro_torch.data.scenes import make_lidar_sweep
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    cfg = SCN_SERVE_CFG
    sweeps = [make_lidar_sweep(s, 3, resolution=32, capacity=4096, step=4)
              for s in (0, 1)]
    spec = engine.build_plan_spec(
        [SparseVoxelTensor(*(sw[0][0][i] for i in (0, 1, 3)))
         for sw in sweeps], cfg)
    model = SCNUNet(cfg, device=cuda_device)

    def serve(sync):
        eng = SceneEngine(cfg, model, 2, spec=spec, sync=sync,
                          planner_threads=2,
                          ctx=engine.ExecutionContext(device=cuda_device))
        streams = [eng.open_stream(f"s{i}") for i in range(2)]
        handles = [[], []]
        for fno in range(3):
            for i, (frames, shifts) in enumerate(sweeps):
                c, f, _, m = frames[fno]
                handles[i].append(streams[i].submit(
                    SparseVoxelTensor(c, f, m), shifts[fno]))
        eng.serve()
        eng.close()
        return eng, [[h.result() for h in hs] for hs in handles]

    eng, by_sync = serve(True)
    assert len(eng.graphs) == 1 and eng.graphs.replays == 3
    (key,) = eng.graphs.keys()
    per_replay = eng.graphs.launches(key)["sspnna_fused"]
    assert per_replay > 0
    assert eng.graphs.replayed["sspnna_fused"] == 3 * per_replay
    for rs in by_sync:
        assert [r.plan_info["mode"] for r in rs] == \
            ["rebuilt", "patched", "patched"]
    for i, rs in enumerate(by_sync):
        for r, (c, f, _, m) in zip(rs, sweeps[i][0]):
            fr = r._frame_rows
            act = np.flatnonzero(m)
            pc = np.full_like(c, -1)
            pm = np.zeros_like(m)
            pc[fr[act]], pm[fr[act]] = c[act], True
            plan = engine.build_scene_plan(SparseVoxelTensor(pc, f, pm), cfg,
                                           spec=spec, device=cuda_device)
            with torch.inference_mode():
                own = engine.apply_unet(
                    model, pack_stream_frame_np(fr, f), plan,
                    device=cuda_device).cpu().numpy()
            want = np.zeros_like(own)
            want[fr >= 0] = own[fr[fr >= 0]]
            err = np.abs(r.logits - want) / np.maximum(np.abs(want), 1.0)
            assert float(err.max()) <= 1e-4, (i, r.frame_no)
    # a one-shot scene of the same capacity replays the same graph
    c, f, _, m = sweeps[0][0][0]
    h = eng.submit(SceneRequest(99, SparseVoxelTensor(c, f, m)))
    eng.serve()
    assert h.result().logits.shape == (cfg.capacity, cfg.n_classes)
    assert len(eng.graphs) == 1 and eng.graphs.replays == 4
    _, by_async = serve(False)
    for a_s, b_s in zip(by_sync, by_async):
        for a, b in zip(a_s, b_s):
            np.testing.assert_array_equal(a.logits, b.logits)


@pytest.mark.cuda
def test_measure_on_the_card_reads_cuda_events(cuda_device):
    """``engine.measure`` times work on the card with CUDA events after a
    synchronize: a call that spins the device ~2 ms reads ~2 ms (the host
    returns at once), with a spread, and the device is inferred from the
    call's result."""
    from repro_torch.engine.autotune import measure

    x = torch.ones(4, device=cuda_device)

    def spin():
        torch.cuda._sleep(int(2e-3 * 1.98e9))  # >= 2 ms at <= 1.98 GHz
        return x + 1

    m = measure(spin, warmup=1, k=5)
    assert m.k == 5 and len(m.times_us) == 5
    assert m.times_us == tuple(sorted(m.times_us))
    assert 1.9e3 <= m.median_us <= 50e3
    assert 0.0 <= m.spread_us < m.median_us
    host = measure(spin, warmup=1, k=5, device="cpu")  # the enqueue only
    torch.cuda.synchronize()
    assert host.median_us < m.median_us


def _tripped_engine(cfg, model, spec, device, **ctx_kw):
    """An engine on ``spec`` whose context board trips ``sspnna`` after one
    attributed failure and never cools down by itself (the clock is the
    caller's list ``now``)."""
    from repro_torch.engine.backends import BreakerBoard
    from repro_torch.serving.scene_engine import SceneEngine

    now = [0.0]
    reg = engine.default_registry().view()
    reg.breakers = BreakerBoard(reg, failure_threshold=1, cooldown_s=60.0,
                                clock=lambda: now[0])
    ctx = engine.ExecutionContext(device=device, registry=reg, **ctx_kw)
    return SceneEngine(cfg, model, 2, spec=spec, ctx=ctx), now


@pytest.mark.cuda
def test_rerouted_signature_captures_a_second_graph(cuda_device):
    """A tripped ``sspnna`` breaker reroutes new plans to ``reference``:
    their waves capture a second graph, which runs no ``sspnna_fused``, and
    each graph's replay matches the eager wave of its plans within 1e-5;
    after the probe closes the breaker, the first graph replays again."""
    from repro_torch.serving.scene_engine import SceneRequest

    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s, n) for s, n in ((320, None), (321, 800))]
    spec = engine.build_plan_spec(scenes, cfg)
    model = SCNUNet(cfg, device=cuda_device)
    eng, now = _tripped_engine(cfg, model, spec, cuda_device)

    def serve(rid0):
        hs = eng.submit([SceneRequest(rid0 + i, t)
                         for i, t in enumerate(scenes)])
        eng.serve()
        return np.stack([h.result().logits for h in hs])

    def eager(backend_of_plans):
        plans = [eng.cache.get_or_build(
            t, cfg, device=cuda_device, topology=eng._topology,
            **eng._plan_kw) for t in scenes]
        assert {lvl.sub.dispatch.backend for p in plans
                for lvl in p.levels} == {backend_of_plans}
        with torch.inference_mode():
            return engine.apply_unet(
                model, torch.cat([torch.from_numpy(t.feats)
                                  for t in scenes]),
                engine.stack_plans(plans), device=cuda_device), plans

    first = serve(0)
    want, plans = eager(engine.SSPNNA)
    np.testing.assert_allclose(first.reshape(-1, cfg.n_classes),
                               want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    sspnna_key = eng.graph_key(cfg.capacity, plans[0])
    assert eng.ctx.registry.breakers.record_failure(engine.SSPNNA)
    rerouted = serve(10)
    want, plans = eager(engine.REFERENCE)
    np.testing.assert_allclose(rerouted.reshape(-1, cfg.n_classes),
                               want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    ref_key = eng.graph_key(cfg.capacity, plans[0])
    assert eng.graphs.keys() == [sspnna_key, ref_key]
    assert eng.n_compilations == 2
    assert eng.graphs.launches(ref_key)["sspnna_fused"] == 0
    assert eng.graphs.launches(sspnna_key)["sspnna_fused"] > 0
    now[0] += 61.0   # the cooldown passes: the next new build probes
    hs = eng.submit([SceneRequest(20, _serve_scene(322, 600))])
    eng.serve()
    hs[0].result()
    assert eng.health()["breakers"]["sspnna"]["state"] == "closed"
    replays = eng.graphs.replays
    again = serve(30)   # rebuilt on sspnna: the first graph replays
    assert eng.graphs.replays == replays + 1 and len(eng.graphs) == 2
    np.testing.assert_array_equal(again, first)
    eng.close()


@pytest.mark.cuda
def test_idle_reprofile_between_replays_keeps_the_bits(cuda_device):
    """The idle hook re-profiles (launching ``sspnna_fused`` on synthetic
    workloads) between two serves; the second serve's graph replay gives
    the first's bits, and the profiled launches tick the counter outside
    any graph."""
    from repro_torch.engine.autotune import CostTable, signature
    from repro_torch.serving.scene_engine import SceneEngine, SceneRequest

    cfg = SCN_SERVE_CFG
    scenes = [_serve_scene(s, n) for s, n in ((330, None), (331, 900))]
    spec = engine.build_plan_spec(scenes, cfg)
    model = SCNUNet(cfg, device=cuda_device)
    table = CostTable(fingerprint="card-test")
    ctx = engine.ExecutionContext(device=cuda_device, autotune=table,
                                  autotune_reprofile_ms=60_000.0)
    eng = SceneEngine(cfg, model, 2, spec=spec, ctx=ctx)

    def serve(rid0):
        hs = eng.submit([SceneRequest(rid0 + i, t)
                         for i, t in enumerate(scenes)])
        eng.serve()
        return np.stack([h.result().logits for h in hs])

    first = serve(0)
    table.note_miss(signature(4096, 4096, 16, 16, density=0.05),
                    delta_o=64, delta_i=256, backend="sspnna")
    launches, replays = sspnna_fused.launches, eng.graphs.replays
    second = serve(10)
    assert eng.scheduler.idle_ticks == 2
    assert table.miss_count == 0 and len(table) == 2
    assert all(e.median_us > 0 for e in table.entries())
    assert eng.graphs.replays == replays + 1 and len(eng.graphs) == 1
    assert sspnna_fused.launches > launches  # the profiler's, not a replay's
    np.testing.assert_array_equal(second, first)
    eng.close()


@pytest.mark.cuda
def test_graph_capture_survives_a_dead_engines_graphs(cuda_device):
    """A ``Graphs`` dropped in a reference cycle (as a dropped engine's
    are) is freed before the next capture, not during it: a collection
    mid-capture that freed its graph would invalidate the capture."""
    import gc

    from repro_torch.serving.graphs import Graphs

    x = torch.arange(8.0, device=cuda_device)
    dead = Graphs(cuda_device)
    dead.capture("a", lambda: x * 2)
    cycle = [dead]
    cycle.append(cycle)
    del dead, cycle
    live = Graphs(cuda_device)

    def fn():
        gc.collect()   # what the collector may do at any allocation
        return x * 3

    live.capture("b", fn)
    np.testing.assert_array_equal(live.replay("b").cpu().numpy(),
                                  np.arange(8.0) * 3)


def _decode_cfg(arch):
    """Two layers at the published widths, in bf16 (Gemma-2's window cut to
    32 so a 40-token prompt fills its ring cache); the recurrent configs
    reduced, in bf16 (RecurrentGemma's 3 layers: two RG-LRU layers and a
    local one whose reduced window of 32 the prompt fills)."""
    if arch in ("rwkv6-7b", "recurrentgemma-9b"):
        return dataclasses.replace(get_config(arch).reduced(),
                                   dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    return (dataclasses.replace(cfg, window=32) if arch == "gemma2-2b"
            else cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "moonshot-v1-16b-a3b",
                                  "rwkv6-7b", "recurrentgemma-9b"])
def test_graph_decode_tokens_equal_eager(cuda_device, arch, sync):
    """The engine's decode-step graphs emit exactly the eager steps' tokens
    over two waves (the second re-fills the static cache: KV buffers and
    recurrent states, which each replay advances in place), and each graph
    recorded the launches of an eager step."""
    from repro_torch.serving.engine import Engine, Request, make_prefill, make_serve_step

    cfg = _decode_cfg(arch)
    batch, prompt_len, max_new = 2, 40, 6
    params = transformer.init_lm(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 17, 33, 40)]
    prefill, step = make_prefill(cfg, cache_pad=max_new), make_serve_step(cfg)
    want, step_launches = {}, []
    with torch.inference_mode():
        for w in range(0, len(prompts), batch):
            toks = np.zeros((batch, prompt_len), np.int32)
            for i, p in enumerate(prompts[w:w + batch]):
                toks[i, -len(p):] = p
            logits, cache = prefill(params, torch.from_numpy(toks).to(
                cuda_device))
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            out = [tok]
            for _ in range(max_new - 1):
                before = grouped_gemm.launches
                tok, _, cache = step(params, tok[:, None], cache)
                step_launches.append(grouped_gemm.launches - before)
                out.append(tok)
            block = torch.stack(out, 1).tolist()
            for i in range(len(prompts[w:w + batch])):
                want[w + i] = block[i]
    eng = Engine(cfg, params, batch, prompt_len, max_new, sync=sync,
                 device=cuda_device)
    handles = eng.submit([Request(i, p, max_new=max_new)
                          for i, p in enumerate(prompts)])
    eng.serve()
    got = {h.request.rid: h.result().out for h in handles}
    eng.close()
    assert got == want
    assert len(eng.graphs) == max_new - 1
    assert eng.graphs.replays == 2 * (max_new - 1)
    per_step = 3 * cfg.n_layers if cfg.is_moe else 0
    assert set(step_launches) == {per_step}
    for i in range(max_new - 1):
        assert eng.graphs.launches(i)["moe_gemm"] == per_step
    for st in eng.wave_stats:
        assert st.notes["graph_launches"].get("moe_gemm", 0) == \
            per_step * (max_new - 1)
    if sync:   # the blocking mode's early EOS exit reads between replays
        eos = want[0][2]
        eng = Engine(cfg, params, batch, prompt_len, max_new, eos=eos,
                     device=cuda_device)
        handles = eng.submit([Request(i, p, max_new=max_new)
                              for i, p in enumerate(prompts)])
        eng.serve()
        cut = {rid: o[:o.index(eos) + 1] if eos in o else o
               for rid, o in want.items()}
        assert {h.request.rid: h.result().out for h in handles} == cut
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-medium"])
def test_vision_and_encdec_graph_decode_tokens_equal_eager(cuda_device, arch):
    """Two layers at the published widths in bf16 (Seamless: two encoder
    layers too), served through ``make_prefill`` with the patch embeddings
    or the source frames and ``Engine.decode``: the step graphs emit the
    eager steps' tokens over two waves (the second re-fills the graphs'
    cache, Seamless's cross keys and values too, from another source), and
    flash launches once a layer in a prefill (Seamless: encoder, self and
    cross) and never in decode."""
    from repro_torch.serving.engine import Engine, make_prefill, make_serve_step

    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              encoder_layers=min(get_config(arch)
                                                 .encoder_layers, 2))
    batch, prompt_len, max_new = 2, 40, 6
    params = transformer.init_lm(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    prefill, step = make_prefill(cfg, cache_pad=max_new), make_serve_step(cfg)
    eng = Engine(cfg, params, batch, prompt_len, max_new, device=cuda_device)
    per_prefill = cfg.encoder_layers + cfg.n_layers * (2 if cfg.is_encdec
                                                       else 1)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rng = np.random.default_rng(5)
    with torch.inference_mode():
        for wave in range(2):
            toks = torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(
                    cuda_device)
            rows = 8 if cfg.frontend == "vision" else 24
            x = torch.randn((batch, rows, cfg.d_model), generator=g,
                            device=cuda_device, dtype=cfg.torch_dtype)
            extra = ({"frontend_embeds": x} if cfg.frontend == "vision"
                     else {"enc_frames": x})
            launches = flash_attention.launches
            logits, cache = prefill(params, toks, **extra)
            assert flash_attention.launches - launches == per_prefill
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            want, c = [tok], cache
            graph = eng.decode(logits, cache).tolist()
            launches = flash_attention.launches
            for _ in range(max_new - 1):
                tok, _, c = step(params, tok[:, None], c)
                want.append(tok)
            assert flash_attention.launches == launches
            assert graph == torch.stack(want, 1).tolist(), wave
    assert len(eng.graphs) == max_new - 1
    assert eng.graphs.replays == 2 * (max_new - 1)
    assert all(not eng.graphs.launches(i)["flash_fwd"]
               for i in range(max_new - 1))
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_forward_on_the_card(cuda_device, n_shards):
    """A scene split over shards, as the loop over them on the card: two
    runs equal bit for bit, within 1e-3 of the unsharded ``reference``
    (relative to the largest logit), and no kernel wrapper launched. At
    capacity 2048 the scene's ~1.9k voxels fill every shard but the last
    of 4."""
    cfg = dataclasses.replace(SCN_SERVE_CFG, capacity=2048)
    coords, feats, _, mask = make_scene(300, cfg.resolution, cfg.capacity)
    t = SparseVoxelTensor(coords, feats, mask)
    model = SCNUNet(cfg, device=cuda_device)
    plan = engine.build_sharded_scene_plan(
        t, cfg, layout=engine.ShardLayout(n_shards=n_shards),
        device=cuda_device)
    assert plan.halo_rows() > 0
    before = kernel_launches()
    with torch.inference_mode():
        a = engine.apply_unet(model, t.feats, plan, device=cuda_device)
        b = engine.apply_unet(model, t.feats, plan, device=cuda_device)
        ref = engine.apply_unet(
            model, t.feats,
            engine.build_scene_plan(t, cfg, plan_tiles=False,
                                    device=cuda_device),
            backend="reference", device=cuda_device)
    torch.cuda.synchronize()
    assert kernel_launches() == before
    assert torch.equal(a, b)
    err = (a - ref).abs().max() / ref.abs().max().clamp(min=1.0)
    assert float(err) <= 1e-3


def kernel_launches() -> tuple[int, int, int, int]:
    return (sspnna_fused.launches, sspnna_tiles.launches,
            flash_attention.launches, grouped_gemm.launches)


@pytest.mark.cuda
def test_scn_train_steps_on_the_card_match_cpu(cuda_device):
    """Two SGD steps of a reduced SCN on an untiled plan (every conv on
    ``reference``, as the trainer runs): no kernel launch on the card, and
    the losses within 1e-4 of the same steps on the CPU."""
    cfg = UNetConfig(widths=(8, 16), reps=1, resolution=24, capacity=2048,
                     n_classes=N_CLASSES)
    coords, feats, labels, mask = make_scene(0, resolution=24, capacity=2048)
    host = engine.build_scene_plan_host(SparseVoxelTensor(coords, feats, mask),
                                        cfg, plan_tiles=False)
    losses = {}
    for side, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        model = SCNUNet(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
        plan = engine.upload_scene_plan(host, dev)
        before = kernel_launches()
        losses[side] = []
        for _ in range(2):
            model.zero_grad()
            loss, _ = segmentation_loss(
                engine.apply_unet(model, feats, plan, device=dev), labels,
                mask)
            loss.backward()
            with torch.no_grad():
                for p in model.parameters():
                    p.sub_(0.3 * p.grad)
            losses[side].append(loss.item())
        assert kernel_launches() == before
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "moonshot-v1-16b-a3b"])
def test_lm_train_steps_on_the_card_match_cpu(cuda_device, arch):
    """Two AdamW steps of a reduced LM with remat and two microbatches:
    neither flash nor the expert GEMM launches, and the loss and grad norm
    are within 1e-4 of the same steps on the CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    hp = OptHParams(lr=1e-3)
    ds = TokenStream(cfg.vocab_size, 4, 32, 3)
    batches = [next(ds), next(ds)]
    metrics = {}
    for side, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        state = train_loop.init_train_state(
            cfg, hp, device=dev, generator=torch.Generator().manual_seed(0))
        step = train_loop.make_train_step(cfg, hp, n_microbatches=2)
        before = kernel_launches()
        metrics[side] = []
        for batch in batches:
            state, m = step(state, batch)
            metrics[side].append([float(m["loss"]),
                                      float(m["grad_norm"])])
        assert kernel_launches() == before
        assert int(state["step"]) == 2
    np.testing.assert_allclose(metrics["card"], metrics["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    """A bf16 train state on the card, saved asynchronously (snapshot to
    host, write in a thread) and restored onto the card, bit for bit; a
    state saved from the CPU restores onto the card equal too."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="bfloat16")
    hp = OptHParams(moment_dtype=torch.bfloat16)
    state = train_loop.init_train_state(cfg, hp, device=cuda_device)
    state, _ = train_loop.make_train_step(cfg, hp)(
        state, next(TokenStream(cfg.vocab_size, 2, 16, 4)))
    checkpoint.save_async(state, str(tmp_path / "card"), 1)
    checkpoint.save(tree_map(lambda t: t.cpu(), state), str(tmp_path / "cpu"),
                    1)
    checkpoint.wait_for_saves()
    for side in ("card", "cpu"):
        restored, _ = checkpoint.restore(str(tmp_path / side), 1, state,
                                         device=cuda_device)
        for (path, x), (_, y) in zip(tree_leaves_with_path(state),
                                     tree_leaves_with_path(restored),
                                     strict=True):
            assert y.device == x.device and y.dtype == x.dtype, path
            assert torch.equal(x, y), path


def _card_moe_case():
    """A reduced Moonshot MoE layer (f32 numpy; the card side casts the
    experts and the input to bf16) over 4 groups of 64 tokens."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                          cfg.d_ff, cfg.moe.n_experts, cfg.act, torch.float32,
                          torch.device("cpu"))
    rng = np.random.default_rng(2)
    return {"params": {k: v.numpy() for k, v in params.items()},
            "x": rng.normal(size=(4, 64, cfg.d_model)).astype(np.float32),
            "kw": dict(top_k=cfg.moe.top_k, act=cfg.act,
                       capacity=moe.moe_capacity(64, cfg.moe.top_k,
                                                 cfg.moe.n_experts,
                                                 cfg.moe.capacity_factor))}


def _spawn_card(target, args_of_rank, n):
    """``n`` spawned processes on the card; their results by rank."""
    results, codes = _dist_worker.spawn(target, args_of_rank, n, 180)
    assert all(err is None for _, _, err in results), results
    assert all(c == 0 for c in codes), codes
    return {rank: res for rank, res, _ in results}


def _card_gather(case, device):
    params = {k: torch.from_numpy(v).to(device).to(torch.bfloat16)
              for k, v in case["params"].items()}
    params["router"] = params["router"].float()
    x = torch.from_numpy(case["x"]).to(device).to(torch.bfloat16)
    with torch.inference_mode():
        y, _ = moe.apply_moe(params, x, **case["kw"])
    torch.cuda.synchronize()
    return y


@pytest.mark.cuda
def test_a2a_moe_on_two_ranks_sharing_the_card(cuda_device):
    """Two processes share the card in a gloo group, each with 2 of the 4
    groups and half the experts: each launches the expert GEMM 3 times, and
    their outputs, concatenated, equal the one-process gather bit for bit
    (each expert's rows reach the kernel in the same order)."""
    case = _card_moe_case()
    port = _dist_worker.free_port()
    results = _spawn_card(_dist_worker.card_a2a_moe,
                          lambda r: (r, port, case), 2)
    want = _card_gather(case, cuda_device)
    assert [results[r]["launches"] for r in range(2)] == [3, 3]
    got = np.concatenate([results[r]["out"] for r in range(2)])
    assert got.tobytes() == want.contiguous().view(torch.uint8).cpu().numpy(
        ).tobytes()


@pytest.mark.cuda
def test_expert_all_to_all_on_a_one_rank_nccl_group(cuda_device):
    """At one rank (an NCCL group on the card) the exchange is the
    identity and the a2a layer equals the gather bit for bit, launching
    the expert GEMM 3 times."""
    case = _card_moe_case()
    port = _dist_worker.free_port()
    res = _spawn_card(_dist_worker.card_nccl_one_rank,
                      lambda r: (port, case), 1)[0]
    want = _card_gather(case, cuda_device)
    assert res["identity"]
    assert res["moe"]["launches"] == 3
    assert res["moe"]["out"].tobytes() == want.contiguous().view(
        torch.uint8).cpu().numpy().tobytes()


@pytest.mark.cuda
def test_modeled_geometry_equals_launch_geometry_on_seed0_convs(cuda_device):
    """``analysis.hlo_gates.geometry`` (H003's Python copy of the tile
    kernels' ``geometry()``) equals the launch the library describes, for
    every tiled conv of seed 0's adaptive plan at the published widths: the
    stem (C=4) and the level's own width, f32 fused and bf16 pre-gathered."""
    from repro_torch.analysis.hlo_gates import geometry
    from repro_torch.kernels.sspnna import sspnna

    cfg = UNetConfig(resolution=64, capacity=16384)
    coords, feats, _, mask = make_scene(0, resolution=64, capacity=16384,
                                        points_per_unit=6e4)
    host = engine.build_scene_plan_host(SparseVoxelTensor(coords, feats, mask),
                                        cfg)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    checked = 0
    for li, lvl in enumerate(host.levels):
        if lvl.sub.tiles is None:
            continue
        t, d_o, k = tuple(np.asarray(lvl.sub.tiles.local_idx).shape)
        w = cfg.widths[li]
        for c, n in ({(w, w)} | ({(cfg.in_channels, w)} if li == 0 else set())):
            for kernel, dtype in ((sspnna.KERNEL, torch.float32),
                                  (sspnna.TILES_KERNEL, torch.bfloat16)):
                launch = sspnna.launch_geometry(kernel, t, d_o, k, c, n, dtype)
                model = geometry(t * d_o, c, n, k, dtype.itemsize, sms)
                assert {key: launch[key] for key in model} == model, (
                    li, kernel, c, n)
                checked += 1
    assert checked >= 4


@pytest.mark.cuda
def test_analysis_hlo_pass_is_clean_on_the_card(cuda_device):
    """The ``hlo`` pass launches the fused conv and finds nothing: no
    gather or scatter op or kernel, no kernel but the fused one and the
    fill, one graph signature, shared memory within the opt-in limit and
    the modeled geometry equal to the launch's."""
    from pathlib import Path

    from repro_torch.analysis.__main__ import run_hlo

    launches = sspnna_fused.launches
    assert run_hlo(Path(__file__).resolve().parents[1]) == []
    assert sspnna_fused.launches > launches
