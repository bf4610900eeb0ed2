"""The port's whole-step dry run (``repro_torch.launch``) against the JAX
package's ``repro.launch`` on the CPU: input specs, model FLOPs, roofline
terms, the op walker's per-rank counts and the kernels' work functions;
the dry run's cells at a fake (2, 2) world; ``grad_shardings=`` in a
2-process gloo step.

The parts that need a process group run in spawned processes
(``tests/_launch_worker.py``). ``repro.launch.dryrun`` is never imported
here: its import rewrites ``XLA_FLAGS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import _dist_worker
import _launch_worker
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.launch.hlo_analysis import analyze as janalyze
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels.abstract import is_abstract
from repro_torch.kernels.flash.ref import attention_mask
from repro_torch.kernels.sspnna.ref import random_tile_tables
from repro_torch.launch import roofline, shapes
from repro_torch.launch.hlo_analysis import analyze

ARCHS = list_configs()
SHAPE_NAMES = list(shapes.SHAPES)
JOIN_S = 300


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _jax_cache_layers(jcache, cfg) -> list[dict]:
    """The JAX stacked cache specs as the port's per-layer flat dicts of
    (shape, dtype) (``tests/test_torch_lm_configs.port_layout_cache``)."""
    def flat(c):
        return {k: v for sub in c.values() for k, v in sub.items()}

    cycle = len(cfg.attn_pattern)
    n_cycles = cfg.n_layers // cycle
    out = [{k: (tuple(v.shape[1:]), str(v.dtype))
            for k, v in flat(jcache["cycles"][j]).items()}
           for _ in range(n_cycles) for j in range(cycle)]
    out += [{k: (tuple(v.shape), str(v.dtype)) for k, v in flat(c).items()}
            for c in jcache["rem"]]
    return out


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    """Every arch x shape: the port's fake-tensor specs have the JAX
    ``ShapeDtypeStruct``s' shapes and dtypes, allocate nothing, and
    ``cell_supported`` agrees."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert shapes.cell_supported(cfg, shape) == jshapes.cell_supported(
        jcfg, shape)
    got = shapes.input_specs(cfg, shape)
    want = jshapes.input_specs(jcfg, shape)
    spec = shapes.SHAPES[shape]
    if spec.kind == "decode":
        assert (tuple(got["token"].shape), _dtype(got["token"])) == (
            want["token"].shape, str(want["token"].dtype))
        layers = [{k: (tuple(v.shape), _dtype(v)) for k, v in layer.items()}
                  for layer in got["cache"]["layers"]]
        assert layers == _jax_cache_layers(want["cache"], jcfg)
        assert got["cache"]["pos"] == spec.seq_len - 1
        leaves = [v for layer in got["cache"]["layers"] for v in layer.values()]
    else:
        got = got.get("batch", got)
        want = want.get("batch", want)
        assert {k: (tuple(v.shape), _dtype(v)) for k, v in got.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in want.items()}
        leaves = list(got.values())
    assert all(is_abstract(x) for x in leaves)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch, shape):
    spec = shapes.SHAPES[shape]
    args = (spec.kind, spec.global_batch, spec.seq_len)
    assert roofline.model_flops(get_config(arch), *args) == \
        jroofline.model_flops(jax_get_config(arch), *args)


def test_roofline_to_dict_matches_jax_with_tpu_constants():
    """The same terms and derived numbers as the JAX ``Roofline`` when it
    is given the TPU constants; by default it holds the H100's."""
    kw = dict(arch="a", shape="s", mesh="16x16", n_devices=256,
              flops_per_device=3.2e12, bytes_per_device=7.5e10,
              coll_bytes_per_device=9e9,
              coll_breakdown={"bytes": {"all-reduce": 4e9,
                                        "all-gather": 5e9},
                              "counts": {"all-reduce": 3, "all-gather": 2}},
              model_flops_global=5e14)
    tpu = dict(peak_flops=jroofline.PEAK_FLOPS, hbm_bw=jroofline.HBM_BW,
               ici_bw=jroofline.ICI_BW)
    got = roofline.Roofline(**kw, **tpu).to_dict()
    assert got == jroofline.Roofline(**kw).to_dict()
    h100 = roofline.Roofline(**kw)
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (989e12, 3.35e12,
                                                           450e9)
    # all-reduce counted twice: (9e9 + 4e9) / 450e9
    assert h100.collective_s == pytest.approx(13e9 / 450e9, rel=1e-15)


def test_walker_exact_on_a_python_loop():
    """The counterpart of ``test_walker_exact_on_scan``: eager runs every
    iteration, so 7 matmul pairs count 7 times, with no trip-count logic."""
    w = torch.ones(128, 64)

    def f(x):
        for _ in range(7):
            x = (x @ w) @ w.T
        return x.sum()

    _, cost = analyze(f, torch.ones(32, 128))
    assert cost.flops == 7 * (2 * 32 * 128 * 64 + 2 * 32 * 64 * 128)
    assert cost.bytes > 0 and cost.coll_bytes == {}


def test_walker_memory_peak_equals_a_hand_count():
    """(a @ b) @ c: arguments, the output, and the first product alive
    while the second is made."""
    m, k, n, p = 8, 16, 32, 4
    a, b, c = torch.ones(m, k), torch.ones(k, n), torch.ones(n, p)
    _, cost = analyze(lambda a, b, c: (a @ b) @ c, a, b, c)
    mem = cost.memory()
    assert mem == {"argument_bytes": 4 * (m * k + k * n + n * p),
                   "output_bytes": 4 * m * p, "temp_bytes": 4 * m * n,
                   "alias_bytes": 0,
                   "peak_bytes_per_device": 4 * (m * k + k * n + n * p
                                                 + m * p + m * n)}
    assert cost.flops == 2 * m * n * k + 2 * m * p * n


def _jax_two_and_row():
    B, D, H = _launch_worker.B, _launch_worker.D, _launch_worker.H
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = jax.sharding.Mesh(devices, ("data", "model"))

    def sh(*spec):
        return JNamedSharding(mesh, P(*spec))

    two = jax.jit(lambda x, w1, w2: (x @ w1) @ w2,
                  in_shardings=(sh("data", None), sh(None, "model"),
                                sh("model", None)),
                  out_shardings=sh("data", None))
    row = jax.jit(lambda x, w: x @ w,
                  in_shardings=(sh(None, "model"), sh("model", None)),
                  out_shardings=sh(None, None))
    c2 = janalyze(two.lower(jnp.ones((B, D)), jnp.ones((D, H)),
                            jnp.ones((H, D))).compile().as_text())
    cr = janalyze(row.lower(jnp.ones((B, H)),
                            jnp.ones((H, D))).compile().as_text())
    return c2, cr


@pytest.fixture(scope="module")
def walker_results():
    results, codes = _dist_worker.spawn(_launch_worker.walker, lambda r: (),
                                        1, JOIN_S)
    res, err = results[0]
    assert err is None and codes == [0], err
    return res


def test_walker_per_rank_flops_match_jax_at_2x2(walker_results):
    """Two matmuls (batch over "data", the hidden dim over "model") at a
    (2, 2) mesh: the port's walker over a fake world of 4 gives JAX
    ``analyze``'s per-device FLOPs over the 4 virtual devices."""
    c2, _ = _jax_two_and_row()
    flops, _, _ = walker_results["two"]
    assert flops == c2.flops
    b, d, h = _launch_worker.B, _launch_worker.D, _launch_worker.H
    assert flops == 2 * (b // 2) * (h // 2) * d * 2


def test_row_parallel_matmul_made_replicated_is_one_all_reduce(walker_results):
    """A row-parallel product whose output is made replicated: one
    all-reduce of the output's bytes in both packages."""
    _, cr = _jax_two_and_row()
    _, coll_bytes, coll_counts = walker_results["row"]
    out_bytes = 4 * _launch_worker.B * _launch_worker.D
    assert coll_counts == {"all-reduce": 1} == {
        k: v for k, v in cr.coll_counts.items() if v}
    assert coll_bytes == {"all-reduce": out_bytes} == {
        k: v for k, v in cr.coll_bytes.items() if v}


def test_wrappers_take_independent_shards_and_raise_on_others(
        walker_results):
    """On ``DTensor``s a kernel wrapper runs on the local shards of the
    dims it treats independently and returns their placements; a shard
    of a dim it sums over, or inputs sharded unlike, raise and name the
    dim (no silent gather)."""
    w = walker_results["wrappers"]
    assert w["flash"] == ("(Shard(dim=0), Shard(dim=2))", (4, 16, 8, 32),
                          (2, 16, 4, 32))
    assert w["gemm"] == ("(Shard(dim=1), Shard(dim=0))", (8, 6, 24),
                         (4, 3, 24))
    assert "'model'" in w["flash_head_dim"] and "dim 0 (batch), dim 2 " \
        "(heads) only" in w["flash_head_dim"]
    assert "shard it alike" in w["flash_unlike"]
    assert "Shard(dim=2)" in w["gemm_summed"] and "'model'" in \
        w["gemm_summed"]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "moonshot-v1-16b-a3b"])
def test_reduced_cells_run_every_kind(arch):
    """Reduced StableLM-2 and Moonshot: train, prefill and decode cells at
    a fake (2, 2) world are ``ok``; prefill reaches the fake flash launch
    (and Moonshot's prefill and decode the fake expert GEMM), their work
    shows in the FLOPs, and no ``launches`` counter moves."""
    results, codes = _dist_worker.spawn(_launch_worker.cells,
                                        lambda r: (arch,), 1, JOIN_S)
    res, err = results[0]
    assert err is None and codes == [0], err
    for kind, r in res.items():
        assert r["status"] == "ok", (kind, r)
        assert not r["launches_moved"], kind
        rf = r["roofline"]
        kernels = rf["coll_breakdown"]["kernels"]
        assert rf["flops_per_device"] >= sum(k["flops"]
                                             for k in kernels.values())
        assert r["memory"]["fits_80GB"] and rf["mesh"] == "2x2"
        assert rf["n_devices"] == 4 and rf["bound"] in ("compute", "memory",
                                                        "collective")
    assert res["prefill"]["roofline"]["coll_breakdown"]["kernels"][
        "flash_fwd"]["launches"] == get_config(arch).reduced().n_layers
    assert "flash_fwd" not in res["train"]["roofline"]["coll_breakdown"][
        "kernels"]
    if arch.startswith("moonshot"):
        for kind in ("prefill", "decode"):
            k = res[kind]["roofline"]["coll_breakdown"]["kernels"]["moe_gemm"]
            assert k["launches"] > 0 and k["flops"] > 0


def test_grad_shardings_keeps_the_values_and_places_the_accumulator():
    """A 2-microbatch step of reduced StableLM-2 (f32) in 2 gloo processes
    over a (1, 2) mesh: with ``grad_shardings`` the accumulator lies on the
    placements asked for, and the new state equals the one without them
    within 1e-6 on both ranks."""
    port = _dist_worker.free_port()
    results, codes = _dist_worker.spawn(
        _launch_worker.grad_step, lambda r: (r, port, 2), 2, JOIN_S)
    assert codes == [0, 0], results
    for rank, res, err in results:
        assert err is None, (rank, err)
        assert res["plain"]
        assert len(res["placements"]) == 2   # one a microbatch
        for step in res["placements"]:
            assert all(got == want for got, want in step)
        assert res["sharded"] > 0
        for a, b in zip(res["with"], res["without"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_grad_shardings_without_microbatches_changes_nothing():
    """One microbatch has no accumulator, so ``grad_shardings`` is unused,
    as in the JAX package: the same state bit for bit (no process group
    needed)."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32")
    hp, state, batch = _launch_worker._state_and_batch(cfg, 1)
    from repro_torch.training import train_loop
    from repro_torch.training.tree import tree_leaves

    got, _ = train_loop.make_train_step(cfg, hp, grad_shardings={})(state,
                                                                   batch)
    want, _ = train_loop.make_train_step(cfg, hp)(state, batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- work


def _old_sspnna_bound(feats, weights, out_rows, in_rows, local_idx, counts,
                      n_out, peak):
    """``chip_smoke.sspnna_bound`` as it read before the work functions
    moved into ``launch.roofline``."""
    c, n = feats.shape[1], weights.shape[2]
    live = counts > 0
    flops = 2.0 * float(counts.sum()) * c * n
    rows_in = int(torch.unique(in_rows[live]).numel())
    nbytes = 4.0 * (rows_in * c + weights.numel() + out_rows.numel()
                    + in_rows.numel() + local_idx.numel() + counts.numel()
                    + n_out * n)
    t_ops, t_bytes = flops / peak, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _old_flash_bound(q, k, v, causal, window):
    b, sq, hq, d = q.shape
    pairs = int(attention_mask(sq, k.shape[1], causal=causal, window=window,
                               device=q.device).sum())
    flops = 4.0 * d * pairs * b * hq
    nbytes = float(q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
    t_ops, t_bytes = flops / 989e12, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _old_tiles_bound(feats, local_idx, weights, peak):
    t, d_o, _ = local_idx.shape
    d_i, c, n = feats.shape[1], feats.shape[2], weights.shape[2]
    live = local_idx >= 0
    pairs = int(live.sum())
    t_index = torch.arange(t, device=local_idx.device).view(t, 1, 1)
    rows_in = int(torch.unique((t_index * d_i + local_idx)[live]).numel())
    flops = 2.0 * pairs * c * n
    nbytes = float(feats.element_size() * (rows_in * c + weights.numel()
                                           + t * d_o * n)
                   + 4 * local_idx.numel())
    t_ops, t_bytes = flops / peak, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _old_moe_gemm_bound(xin, w, valid, out_dtype):
    e, c, d = xin.shape
    f = w.shape[2]
    rows = int(valid.sum())
    live = int(valid.any(1).sum())
    flops = 2.0 * rows * d * f
    peak = 989e12 if xin.dtype == torch.bfloat16 else 67e12
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = float(xin.element_size() * (rows * d + live * d * f)
                   + valid.numel() + e * c * f * out_size)
    t_ops, t_bytes = flops / peak, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


@pytest.mark.parametrize("seed", range(4))
def test_work_functions_give_the_old_bounds_to_the_last_digit(seed):
    """The bounds ``chip_smoke.py`` prints are the same numbers before and
    after its four bound functions became calls of ``launch.roofline``'s
    work functions (exact float equality, at both SSpNNA peaks)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    t, d_i, d_o, c, n = 5 + seed, 24, 8, 4 + 2 * seed, 16 + seed
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.as_tensor(x) for x in random_tile_tables(
            rng, v=40 + seed, c=c, n=n, t=t, d_i=d_i, d_o=d_o))
    for peak in (roofline.PEAK_FP32_FLOPS, roofline.PEAK_TF32X3_FLOPS):
        assert roofline.sspnna_fused_work(
            feats, weights, out_rows, in_rows, local_idx, counts,
            40 + seed).bound(peak) == _old_sspnna_bound(
                feats, weights, out_rows, in_rows, local_idx, counts,
                40 + seed, peak)
        stack = torch.randn(t, d_i, c, generator=g)
        assert roofline.sspnna_tiles_work(stack, local_idx, weights).bound(
            peak) == _old_tiles_bound(stack, local_idx, weights, peak)
    for causal, window, sq, skv in ((True, None, 96, 96), (True, 16, 64, 80),
                                    (False, None, 48, 80),
                                    (True, None, 80, 48)):
        q = torch.randn(2, sq, 4, 32, dtype=torch.bfloat16, generator=g)
        k = torch.randn(2, skv, 2, 32, dtype=torch.bfloat16, generator=g)
        assert roofline.flash_work(q, k, k, causal, window).bound() == \
            _old_flash_bound(q, k, k, causal, window)
    for dt, odt in ((torch.bfloat16, torch.float32),
                    (torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16)):
        xin = torch.randn(4, 12, 16, generator=g).to(dt)
        w = torch.randn(4, 16, 24, generator=g).to(dt)
        valid = torch.rand(4, 12, generator=g) < 0.4
        valid[1] = False
        assert roofline.moe_gemm_work(xin, w, valid, odt).bound() == \
            _old_moe_gemm_bound(xin, w, valid, odt)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 7, 300])
def test_mask_pairs_count_the_mask(causal, window):
    """The closed-form pair count equals the mask's, at Sq below, equal to
    and above Skv."""
    for sq, skv in ((1, 1), (37, 37), (20, 90), (90, 20)):
        assert roofline.mask_pairs(sq, skv, causal=causal, window=window) == \
            int(attention_mask(sq, skv, causal=causal, window=window,
                               device="cpu").sum())


def test_fake_launches_count_work_and_launch_nothing():
    """Each wrapper on fake CPU and CUDA tensors returns an empty output of
    the real one's shape, dtype and device, adds its work function to the
    walker and leaves its ``launches`` as it is; real CPU tensors still
    take the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
    from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles

    before = (flash_attention.launches, grouped_gemm.launches,
              sspnna_fused.launches, sspnna_tiles.launches)
    for device in ("cpu", "cuda"):
        with FakeTensorMode():
            def e(*shape, dtype=torch.float32):
                return torch.empty(shape, dtype=dtype, device=device)

            q, kv = e(2, 64, 4, 32, dtype=torch.bfloat16), \
                e(2, 64, 2, 32, dtype=torch.bfloat16)
            xin, w, valid = e(3, 8, 16), e(3, 16, 24), e(3, 8, dtype=torch.bool)
            tbl = dict(out_rows=e(5, 4, dtype=torch.int32),
                       in_rows=e(5, 6, dtype=torch.int32),
                       local_idx=e(5, 4, 27, dtype=torch.int32),
                       pair_counts=e(5, dtype=torch.int32))

            def run():
                return (flash_attention(q, kv, kv),
                        grouped_gemm(xin, w, valid, out_dtype=torch.float32),
                        sspnna_fused(e(30, 8), e(27, 8, 12), **tbl, n_out=30),
                        sspnna_tiles(e(5, 6, 8), tbl["local_idx"],
                                     e(27, 8, 12)))

            outs, cost = analyze(run)
        assert [(tuple(o.shape), o.dtype, o.device.type) for o in outs] == [
            ((2, 64, 4, 32), torch.bfloat16, device),
            ((3, 8, 24), torch.float32, device),
            ((30, 12), torch.float32, device),
            ((5, 4, 12), torch.float32, device)]
        assert {k: v["launches"] for k, v in cost.kernels.items()} == {
            "flash_fwd": 1, "moe_gemm": 1, "sspnna_fused": 1,
            "sspnna_tiles": 1}
        assert cost.kernels["flash_fwd"]["flops"] == roofline.flash_work(
            q, kv, kv, True, None).flops
        # every slot counts on fake tensors
        assert cost.kernels["moe_gemm"]["flops"] == 2.0 * 3 * 8 * 16 * 24
    assert (flash_attention.launches, grouped_gemm.launches,
            sspnna_fused.launches, sspnna_tiles.launches) == before
    real = torch.randn(1, 8, 2, 16)
    assert not is_abstract(real) and torch.equal(
        flash_attention(real, real, real),
        flash_attention(real, real, real))
