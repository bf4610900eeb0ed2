"""Port parity: the SSpNNA conv of ``repro_torch`` (fused and pre-gathered
paths, plane-split plans, the deprecated shims) against the JAX package's
Pallas kernels, run in interpret mode on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_shell_scene
from repro.core import tiles as jtiles
from repro.kernels.sspnna.ops import run_sspnna_conv as jax_run_sspnna_conv
from repro.kernels.sspnna.ref import sspnna_tile_ref as jax_tile_ref
from repro.kernels.sspnna.sspnna import sspnna_fused as jax_sspnna_fused
from repro_torch.core import soar
from repro_torch.core.sparse_conv import (
    SparseConvParams,
    reference_conv_cirf,
    submanifold_coir,
)
from repro_torch.core.tiles import TilePlan, build_tile_plan, dma_tile_tables
from repro_torch.kernels.sspnna.ops import (
    run_sspnna_conv,
    sspnna_conv,
    sspnna_conv_from_plan,
)
from repro_torch.kernels.sspnna.ref import random_tile_tables, sspnna_tile_ref
from repro_torch.kernels.sspnna.sspnna import (
    sspnna_fused,
    sspnna_fused_plain,
    sspnna_tiles,
)
from repro_torch.sparse.tensor import from_dense
from test_torch_cuda import K, SHAPES, TOL

# whole convs: f32 sums of up to 27*8 products per output, in another order
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["raw", "dma"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "v{}c{}n{}t{}i{}o{}".format(*s))
def test_plain_fused_matches_jax_kernel(shape, layout):
    v, c, n, t, d_i, d_o = shape
    rng = np.random.default_rng(sum(shape))
    feats, weights, out_rows, in_rows, local_idx, counts = random_tile_tables(
        rng, v=v, c=c, n=n, t=t, d_i=d_i, d_o=d_o)
    assert (counts == 0).any() and (counts > 0).any()
    if layout == "dma":
        tp = TilePlan(out_rows, in_rows, local_idx, counts)
        dma = dma_tile_tables(tp, v)
        in_rows, out_rows = dma.in_rows, dma.out_rows
    want = np.asarray(jax_sspnna_fused(
        jnp.asarray(feats), jnp.asarray(weights), jnp.asarray(out_rows),
        jnp.asarray(in_rows), jnp.asarray(local_idx), jnp.asarray(counts),
        n_out=v, interpret=True))
    args = [torch.from_numpy(x) for x in
            (feats, weights, out_rows, in_rows, local_idx, counts)]
    launches = sspnna_fused.launches
    got = sspnna_fused(*args, n_out=v)
    assert sspnna_fused.launches == launches  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), sspnna_fused_plain(*args, n_out=v).numpy())


def test_tile_ref_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(4, 24, 16)).astype(np.float32)
    idx = rng.integers(-1, 24, (4, 8, K)).astype(np.int32)
    w = (rng.normal(size=(K, 16, 48)) * 0.1).astype(np.float32)
    want = np.asarray(jax_tile_ref(jnp.asarray(feats), jnp.asarray(idx),
                                   jnp.asarray(w)))
    got = sspnna_tile_ref(torch.from_numpy(feats), torch.from_numpy(idx),
                          torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_run_sspnna_conv_matches_jax():
    """The engine's entry to the kernel, on the fused path of both packages
    (JAX in interpret mode), with the tile plan's pair counts."""
    rng = np.random.default_rng(5)
    arrays = random_tile_tables(rng, v=80, c=8, n=16, t=4, d_i=16, d_o=8)
    *tables, counts = arrays
    want = np.asarray(jax_run_sspnna_conv(
        *map(jnp.asarray, tables), n_out=80, pair_counts=jnp.asarray(counts),
        interpret=True))
    got = run_sspnna_conv(*map(torch.from_numpy, tables), n_out=80,
                          pair_counts=torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(7)
    feats, weights, out_rows, in_rows, local_idx, counts = (
        torch.from_numpy(x) for x in random_tile_tables(
            rng, v=40, c=4, n=16, t=2, d_i=8, d_o=4))
    with pytest.raises(TypeError, match="float32"):
        sspnna_fused(feats.double(), weights, out_rows, in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(TypeError, match="int32"):
        sspnna_fused(feats, weights, out_rows.long(), in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(ValueError, match="weights"):
        sspnna_fused(feats, weights[:, :2], out_rows, in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(ValueError, match="tile tables"):
        sspnna_fused(feats, weights, out_rows[:1], in_rows, local_idx,
                     counts, n_out=40)
    with pytest.raises(RuntimeError, match="forward-only"):
        sspnna_fused(feats, weights.requires_grad_(), out_rows, in_rows,
                     local_idx, counts, n_out=40)


@pytest.fixture(scope="module")
def shell():
    """A real sphere-shell scene (770 active voxels), its submanifold COIR
    built by the port on the CPU, its SOAR order and a seeded (27, 8, 16)
    weight."""
    dense = make_shell_scene(np.random.default_rng(0), 18, 8)
    t = from_dense(dense, device="cpu")
    coir = submanifold_coir(t, 18, 3)
    order = soar.soar_order(coir.indices.numpy(), t.mask.numpy(), 64).order
    w = (np.random.default_rng(1).normal(size=(K, 8, 16)) * 0.1).astype(np.float32)
    return t, coir, order, w


def _plans_equal(got, want):
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name))


def _budgeted_plan(shell):
    """The real scene's budgeted plan, padded with dead tiles."""
    t, coir, order, _ = shell
    idx = coir.indices.numpy()
    realized = build_tile_plan(idx, order, 32, 128)
    n_tiles = 2 * realized.n_tiles + 2
    tp = build_tile_plan(idx, order, 32, 128, n_tiles=n_tiles)
    _plans_equal(tp, jtiles.build_tile_plan(idx, order, 32, 128,
                                            n_tiles=n_tiles))
    assert int((tp.pair_counts == 0).sum()) > 0
    return tp, dma_tile_tables(tp, t.capacity)


MODES = {
    "fused": dict(use_kernel=True),  # with the plan's pair counts
    "fused_derived_counts": dict(use_kernel=True, fused=True),
    "pregathered": dict(use_kernel=True, fused=False),
    "oracle": dict(use_kernel=False, fused=False),
}


@pytest.mark.parametrize("mode", MODES)
def test_run_sspnna_conv_modes_match_jax_on_real_scene(shell, mode):
    """Every mode of ``run_sspnna_conv`` on a real shell scene with a padded
    budgeted plan, against the same mode of the JAX entry."""
    t, _, _, w = shell
    tp, dma = _budgeted_plan(shell)
    kw = dict(MODES[mode])
    tables = (dma.out_rows, dma.in_rows, tp.local_idx)
    counts = dma.pair_counts if mode == "fused" else None
    want = np.asarray(jax_run_sspnna_conv(
        jnp.asarray(t.feats.numpy()), jnp.asarray(w),
        *map(jnp.asarray, tables), n_out=t.capacity,
        pair_counts=None if counts is None else jnp.asarray(counts),
        interpret=True, **kw))
    launches = sspnna_fused.launches, sspnna_tiles.launches
    got = run_sspnna_conv(
        t.feats, torch.from_numpy(w), *map(torch.from_numpy, tables),
        n_out=t.capacity,
        pair_counts=None if counts is None else torch.from_numpy(counts), **kw)
    assert (sspnna_fused.launches, sspnna_tiles.launches) == launches
    assert got.shape == (t.capacity, 16)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_fused_pregathered_and_oracle_are_bitwise_equal_on_cpu(shell):
    """As the JAX package's ``test_fused_full_conv_path_on_real_scene``: on
    the CPU the accumulate into zeros equals the fused overwrite."""
    t, _, _, w = shell
    tp, dma = _budgeted_plan(shell)
    args = (t.feats, torch.from_numpy(w), torch.from_numpy(dma.out_rows),
            torch.from_numpy(dma.in_rows), torch.from_numpy(tp.local_idx))
    fused = run_sspnna_conv(*args, n_out=t.capacity,
                            pair_counts=torch.from_numpy(dma.pair_counts))
    gathered = run_sspnna_conv(*args, n_out=t.capacity, fused=False)
    oracle = run_sspnna_conv(*args, n_out=t.capacity, use_kernel=False)
    np.testing.assert_array_equal(fused.numpy(), gathered.numpy())
    np.testing.assert_array_equal(fused.numpy(), oracle.numpy())


def test_fused_without_kernel_raises(shell):
    t, _, _, w = shell
    tp, dma = _budgeted_plan(shell)
    with pytest.raises(ValueError, match="use_kernel=True"):
        run_sspnna_conv(t.feats, torch.from_numpy(w),
                        torch.from_numpy(dma.out_rows),
                        torch.from_numpy(dma.in_rows),
                        torch.from_numpy(tp.local_idx), n_out=t.capacity,
                        use_kernel=False, fused=True)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_plane_split_plan_matches_jax_and_reference(shell, use_kernel):
    """An unbudgeted plan with delta_i = 16 < 27 splits rows across plane
    groups: tables equal to JAX's, and the accumulating pre-gathered conv
    equals JAX's and the reference product (no bias, rows masked)."""
    t, coir, order, w = shell
    idx = coir.indices.numpy()
    tp = build_tile_plan(idx, order, 8, 16)
    assert tp.n_row_splits > 0
    _plans_equal(tp, jtiles.build_tile_plan(idx, order, 8, 16))
    want = np.asarray(jax_run_sspnna_conv(
        jnp.asarray(t.feats.numpy()), jnp.asarray(w),
        jnp.asarray(tp.out_rows), jnp.asarray(tp.in_rows),
        jnp.asarray(tp.local_idx), n_out=t.capacity, use_kernel=use_kernel,
        fused=False, interpret=True))
    got = run_sspnna_conv(t.feats, torch.from_numpy(w),
                          torch.from_numpy(tp.out_rows),
                          torch.from_numpy(tp.in_rows),
                          torch.from_numpy(tp.local_idx), n_out=t.capacity,
                          use_kernel=use_kernel, fused=False)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    ref = reference_conv_cirf(t.feats, coir, SparseConvParams(
        torch.from_numpy(w), torch.zeros(16)))
    mask = t.mask.numpy()
    np.testing.assert_allclose(got.numpy()[mask], ref.numpy()[mask], **CONV_TOL)


def test_single_row_overshoot_splits_and_accumulates():
    """The JAX package's ``test_single_row_overshoot_splits_unbudgeted_no_drops``
    on the port: one row with 6 distinct partners and delta_i = 2 splits
    into 3 tiles of one shared row, and the accumulating conv gives the
    dense sum, as JAX's does."""
    k = 6
    cirf = np.array([[10, 11, 12, 13, 14, 15]], np.int32)
    tp = build_tile_plan(cirf, np.array([0]), delta_o=4, delta_i=2)
    _plans_equal(tp, jtiles.build_tile_plan(cirf, np.array([0]), delta_o=4,
                                            delta_i=2))
    assert tp.n_row_splits == 2 and tp.dropped_pairs == 0
    assert int(tp.pair_counts.sum()) == k
    rows = tp.out_rows[tp.out_rows >= 0]
    assert (rows == 0).all() and len(rows) == 3
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(16, 4)).astype(np.float32)
    w = (rng.normal(size=(k, 4, 8)) * 0.1).astype(np.float32)
    dense = np.zeros((16, 8), np.float32)
    dense[0] = sum(feats[cirf[0, p]] @ w[p] for p in range(k))
    tables = (tp.out_rows, tp.in_rows, tp.local_idx)
    for use_kernel in (True, False):
        want = np.asarray(jax_run_sspnna_conv(
            jnp.asarray(feats), jnp.asarray(w), *map(jnp.asarray, tables),
            n_out=16, use_kernel=use_kernel, fused=False, interpret=True))
        got = run_sspnna_conv(torch.from_numpy(feats), torch.from_numpy(w),
                              *map(torch.from_numpy, tables), n_out=16,
                              use_kernel=use_kernel, fused=False).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


def test_deprecated_shims_warn_and_route(shell):
    """``sspnna_conv`` and ``sspnna_conv_from_plan`` warn; the second sends a
    plane-split plan down the accumulating path, as in the JAX package."""
    t, coir, order, w = shell
    tp, dma = _budgeted_plan(shell)
    wt = torch.from_numpy(w)
    tables = [torch.from_numpy(x) for x in (dma.out_rows, dma.in_rows,
                                            tp.local_idx)]
    want = run_sspnna_conv(t.feats, wt, *tables, n_out=t.capacity,
                           pair_counts=torch.from_numpy(dma.pair_counts))
    with pytest.warns(DeprecationWarning, match="sspnna_conv is deprecated"):
        got = sspnna_conv(t.feats, wt, *tables, n_out=t.capacity)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.warns(DeprecationWarning, match="sspnna_conv_from_plan"):
        got = sspnna_conv_from_plan(t.feats, wt, tp, n_out=t.capacity)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    split = build_tile_plan(coir.indices.numpy(), order, 8, 16)
    assert split.n_row_splits > 0
    with pytest.warns(DeprecationWarning, match="sspnna_conv_from_plan"):
        got = sspnna_conv_from_plan(t.feats, wt, split, n_out=t.capacity)
    ref = reference_conv_cirf(t.feats, coir, SparseConvParams(wt, torch.zeros(16)))
    mask = t.mask.numpy()
    np.testing.assert_allclose(got.numpy()[mask], ref.numpy()[mask], **CONV_TOL)
