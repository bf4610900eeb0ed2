"""Port parity for CAROM, the ops-sorted schedulers, offline SPADE and
hierarchical SOAR (``repro_torch.core.carom``, ``core.schedule``,
``core.spade``, ``core.soar``) against the JAX package on the CPU, on
``tests/test_dataflow.py``'s inputs: the shell scene of seed 7 at
resolution 28 (its neighbour and COIR tables built by the JAX package, as
that test builds them, and fed to both packages) and the Pareto work of
seed 3; the offline tables and hierarchical orders also on level 0 of
``make_scene(0, 64, 8192)`` (2,412 voxels, so the recursion meets hundreds
of chunks). These modules are host code on integers and float64 sums in
one order, so every chosen dataflow, order, assignment and makespan is
held equal. The slice as a whole (Fig 24's path: a looked-up dataflow
through ``engine.conv_plan_for_layer`` and ``engine.sparse_conv``) holds
its tile tables equal and its conv within 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_shell_scene
from repro import engine as jengine
from repro.core import carom as jcarom
from repro.core import schedule as jschedule
from repro.core import soar as jsoar
from repro.core import spade as jspade
from repro.core import sparse_conv as jsc
from repro.core.hashgrid import build_neighbor_table, kernel_offsets
from repro.core.host_meta import build_cirf_np
from repro.core.sparse_conv import submanifold_coir
from repro.data.scenes import make_scene as jmake_scene
from repro.sparse.tensor import from_dense
from repro_torch import engine
from repro_torch.core import carom, coir, schedule, soar, spade
from repro_torch.core.sparse_conv import SparseConvParams

LEVELS = [(("L2", 2 << 20, 16, 1024), ("L1", 64 << 10, 64, 1024)),
          (("L2", 1 << 20, 8, 512), ("L1", 32 << 10, 32, 2048),
           ("RF", 4 << 10, 128, 4096))]


@pytest.fixture(scope="module")
def shell():
    rng = np.random.default_rng(7)
    t = from_dense(make_shell_scene(rng, 28, 4))
    nbr = np.asarray(build_neighbor_table(
        t.coords, t.mask, jnp.asarray(kernel_offsets(3)), 28))
    idx = np.asarray(submanifold_coir(t, 28, 3).indices)
    mask = np.asarray(t.mask)
    order = soar.soar_order(nbr, mask, 256).order
    np.testing.assert_array_equal(order,
                                  jsoar.soar_order(nbr, mask, 256).order)
    attrs = spade.extract_attributes(idx, mask, order)
    jattrs = jspade.extract_attributes(idx, mask, order)
    for f in dataclasses.fields(attrs):
        np.testing.assert_array_equal(getattr(attrs, f.name),
                                      getattr(jattrs, f.name))
    return int(t.n_active()), attrs, jattrs


# the offline table's ARF bin edges (``build_offline_table``'s default)
BINS = [2, 4, 6, 8, 10, 13, 16, 20, 27]
# hierarchical SOAR levels, innermost first
CHUNKS = [[64, 512], [128, 2048], [16, 128, 1024]]
# whole convs: f32 sums of up to 27*C products per output, in another order
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    """Both scenes as (name, adjacency, CIRF indices, mask, coords, COIR as
    numpy), every table built by the JAX package: the shell's hashgrid
    neighbour table and COIR, and level 0 of ``make_scene(0, 64, 8192)``,
    whose CIRF is also its adjacency (as the engine's SOAR reads it)."""
    rng = np.random.default_rng(7)
    t = from_dense(make_shell_scene(rng, 28, 4))
    nbr = np.asarray(build_neighbor_table(
        t.coords, t.mask, jnp.asarray(kernel_offsets(3)), 28))
    sub = tuple(np.asarray(x) for x in submanifold_coir(t, 28, 3))
    coords, _, _, mask = jmake_scene(0, 64, 8192)
    sub2 = tuple(np.asarray(x) for x in build_cirf_np(
        coords, mask, coords, mask, kernel_offsets(3), 64))
    return [("shell", nbr, sub[0], np.asarray(t.mask), np.asarray(t.coords),
             sub),
            ("scene", sub2[0], sub2[0], np.asarray(mask), np.asarray(coords),
             sub2)]


def _attrs(idx, mask, order):
    return (spade.extract_attributes(idx, mask, order),
            jspade.extract_attributes(idx, mask, order))


def _dispatch(d):
    """The fields of a ``Dispatch`` both packages have (the port's has no
    N-block)."""
    return (d.backend, d.flavor, d.walk, d.delta_o, d.delta_i, d.n_tiles)


def _same(got, want):
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_surface_ratio_model_and_fit_match_jax(scenes):
    """The Fig 15 fit on each scene's SOAR attributes, and on a constant
    series, whose correlation is nan in both (``np.corrcoef``)."""
    deltas = np.array([1, 8, 64, 512, 4096, 0])
    for alpha in (0.0, 0.5, 4.7):
        for m in (2, 3):
            np.testing.assert_array_equal(
                spade.surface_ratio_model(deltas, alpha, m),
                jspade.surface_ratio_model(deltas, alpha, m))
    for _, adj, idx, mask, *_ in scenes:
        order = soar.soar_order(adj, mask, 256).order
        attrs, jattrs = _attrs(idx, mask, order)
        for m in (2, 3):
            got, want = spade.fit_surface_ratio(attrs, m), \
                jspade.fit_surface_ratio(jattrs, m)
            assert got == want and np.isfinite(got).all()
        flat = dataclasses.replace(attrs, sa_minor_avg=np.full(7, 1.25))
        jflat = dataclasses.replace(jattrs, sa_minor_avg=np.full(7, 1.25))
        with np.errstate(invalid="ignore", divide="ignore"):
            got, want = spade.fit_surface_ratio(flat), \
                jspade.fit_surface_ratio(jflat)
        assert got[0] == want[0] and np.isnan(got[1]) and np.isnan(want[1])
        short = dataclasses.replace(attrs, delta_majors=np.array([64, 128]),
                                    sa_minor_avg=attrs.sa_minor_avg[:2])
        jshort = dataclasses.replace(jattrs, delta_majors=np.array([64, 128]),
                                     sa_minor_avg=jattrs.sa_minor_avg[:2])
        assert spade.fit_surface_ratio(short) == \
            jspade.fit_surface_ratio(jshort)


def _tables(scenes):
    """Offline tables of both packages over the two scenes' SOAR
    attributes (their MSA), for three layers, default bins and one more
    set of edges."""
    ours, theirs = [], []
    for _, adj, idx, mask, *_ in scenes:
        a, ja = _attrs(idx, mask, soar.soar_order(adj, mask, 512).order)
        ours.append(a)
        theirs.append(ja)
    layers = [(f"L{c}", 2000, 2000, 27, c, c, 2) for c in (4, 16, 64)]
    layers.append(("wide", 75000, 75000, 27, 32, 48, 2))
    out = []
    for bins in (None, np.array([3.0, 9.5, 30.0])):
        table = spade.build_offline_table(
            [spade.LayerSpec(*lay) for lay in layers],
            spade.meta_attributes(ours), 64 * 1024, bins)
        jtable = jspade.build_offline_table(
            [jspade.LayerSpec(*lay) for lay in layers],
            jspade.meta_attributes(theirs), 64 * 1024, bins)
        out.append((table, jtable, layers))
    return out


def test_build_offline_table_matches_jax(scenes):
    """Every plan of the table, all ``Dataflow`` fields, equal."""
    for table, jtable, layers in _tables(scenes):
        np.testing.assert_array_equal(table.arf_bins, jtable.arf_bins)
        assert list(table.plans) == list(jtable.plans)
        assert len(table.plans) == len(layers) * len(table.arf_bins)
        for key, plan in table.plans.items():
            _same(plan, jtable.plans[key])
    np.testing.assert_array_equal(_tables(scenes)[0][0].arf_bins, BINS)


@pytest.mark.parametrize("arf", [0.0, 1.5, 2.0, 2.0001, 3.0, 4.0, 12.9, 13.0,
                                 13.5, 26.99, 27.0, 27.01, 40.0, 1e9])
def test_otf_lookup_matches_jax(scenes, arf):
    """Below, on and between bin edges and past the last: left-sided
    search, clamped to the last bin."""
    for table, jtable, layers in _tables(scenes):
        for lay in layers:
            got = spade.otf_lookup(table, spade.LayerSpec(*lay), arf)
            want = jspade.otf_lookup(jtable, jspade.LayerSpec(*lay), arf)
            _same(got, want)
            b = min(int(np.searchsorted(table.arf_bins, arf)),
                    len(table.arf_bins) - 1)
            _same(got, table.plans[(lay[0], b)])


@pytest.mark.parametrize("chunks", CHUNKS, ids=lambda c: "-".join(map(str, c)))
def test_soar_hierarchical_matches_jax(scenes, chunks):
    """The flattened order and the innermost chunk boundaries, equal; the
    order is a permutation of the active rows."""
    for name, adj, _, mask, *_ in scenes:
        got = soar.soar_hierarchical(adj, mask, chunks)
        want = jsoar.soar_hierarchical(adj, mask, chunks)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_array_equal(got.chunk_starts, want.chunk_starts)
        assert got.order.dtype == want.order.dtype
        assert got.chunk_starts.dtype == want.chunk_starts.dtype
        np.testing.assert_array_equal(np.sort(got.order),
                                      np.flatnonzero(mask))
        assert got.n_chunks > (8 if name == "scene" else 2)
    # one level is plain SOAR
    _, adj, _, mask, *_ = scenes[0]
    one = soar.soar_hierarchical(adj, mask, [256])
    np.testing.assert_array_equal(one.order,
                                  soar.soar_order(adj, mask, 256).order)


@pytest.mark.parametrize("tile", [64, 256, 1000])
def test_tiled_unique_input_accesses_match_jax(scenes, tile):
    """Fig 23's cost model for the SOAR, raster and hierarchical orders."""
    for _, adj, idx, mask, coords, _ in scenes:
        orders = [soar.soar_order(adj, mask, 512).order,
                  soar.raster_order(coords, mask),
                  soar.soar_hierarchical(adj, mask, [128, 2048]).order]
        for order in orders:
            got = soar.tiled_unique_input_accesses(order, idx, tile)
            want = jsoar.tiled_unique_input_accesses(order, idx, tile)
            assert got == want and isinstance(got, int)


def test_offline_lookup_through_the_engine_matches_jax(scenes):
    """Fig 24's path (``bench_dataflow.py``) with the looked-up dataflow:
    each scene's SOAR attributes, an offline table of its MSA, the lookup
    at the scene's ARF, ``dispatch_from_dataflow``, then
    ``conv_plan_for_layer`` and ``sparse_conv(backend="sspnna")`` (the JAX
    side with ``use_kernel=False``). Tile tables equal, conv within 1e-4,
    and within 1e-4 of the reference backend."""
    rng = np.random.default_rng(5)
    for name, adj, idx, mask, _, jcoir in scenes:
        order = soar.soar_order(adj, mask, 256).order
        attrs, jattrs = _attrs(idx, mask, order)
        v = int(mask.sum())
        c, n = 16, 32
        layer = spade.LayerSpec("conv", v, v, 27, c, n, 2)
        jlayer = jspade.LayerSpec("conv", v, v, 27, c, n, 2)
        table = spade.build_offline_table([layer],
                                          spade.meta_attributes([attrs]),
                                          64 * 1024)
        jtable = jspade.build_offline_table([jlayer],
                                            jspade.meta_attributes([jattrs]),
                                            64 * 1024)
        arf = float(attrs.arf_avg[0])
        df = spade.otf_lookup(table, layer, arf)
        _same(df, jspade.otf_lookup(jtable, jlayer, arf))
        d = engine.dispatch_from_dataflow(df, attrs, v)
        jd = jengine.dispatch_from_dataflow(df, jattrs, v)
        assert _dispatch(d) == _dispatch(jd)
        assert d.backend == engine.SSPNNA, name  # a tiling, not one tile
        cmask = np.asarray(mask)
        sub = coir.COIR(*jcoir)
        jsub = jsc.COIR(*map(jnp.asarray, jcoir))
        cp = engine.conv_plan_for_layer(sub, order, d.delta_o, d.delta_i,
                                        walk=d.walk, device="cpu")
        jcp = jengine.conv_plan_for_layer(jsub, order, d.delta_o, d.delta_i,
                                          walk=d.walk)
        for a, b in zip(cp.tiles, jcp.tiles, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert _dispatch(cp.dispatch) == _dispatch(jcp.dispatch)
        w = (rng.normal(size=(27, c, n)) / np.sqrt(27 * c)).astype(np.float32)
        bias = rng.normal(size=(n,)).astype(np.float32)
        x = (rng.normal(size=(len(idx), c)) * cmask[:, None]).astype(
            np.float32)
        p = SparseConvParams(torch.from_numpy(w), torch.from_numpy(bias))
        jp = jsc.SparseConvParams(jnp.asarray(w), jnp.asarray(bias))
        got = engine.sparse_conv(torch.from_numpy(x), p, cp, backend="sspnna")
        want = jengine.sparse_conv(jnp.asarray(x), jp, jcp, backend="sspnna",
                                   use_kernel=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
        ref = engine.sparse_conv(torch.from_numpy(x), p,
                                 engine.reference_plan(cp.coir))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **CONV_TOL)


@pytest.mark.parametrize("tiling", ["RST", "SST"])
@pytest.mark.parametrize("levels", LEVELS, ids=["2 levels", "3 levels"])
@pytest.mark.parametrize("c_in,c_out", [(64, 64), (16, 48), (4, 32)])
def test_carom_and_greedy_match_jax(shell, levels, tiling, c_in, c_out):
    v, attrs, jattrs = shell
    layer = spade.LayerSpec("L", v, v, 27, c_in, c_out, 2)
    jlayer = jspade.LayerSpec("L", v, v, 27, c_in, c_out, 2)
    ours = [carom.MemLevel(*lv) for lv in levels]
    theirs = [jcarom.MemLevel(*lv) for lv in levels]
    for search, jsearch in ((carom.carom_search, jcarom.carom_search),
                            (carom.greedy_search, jcarom.greedy_search)):
        got = search(layer, {"CIRF": attrs, "CORF": attrs}, ours, tiling)
        want = jsearch(jlayer, {"CIRF": jattrs, "CORF": jattrs}, theirs,
                       tiling)
        assert [dataclasses.astuple(d) for d in got] == \
            [dataclasses.astuple(d) for d in want]
    plans = carom.carom_search(layer, {"CIRF": attrs, "CORF": attrs}, ours,
                               tiling)
    greedy = carom.greedy_search(layer, {"CIRF": attrs, "CORF": attrs}, ours,
                                 tiling)
    # a level whose capacity no candidate fits ends the search
    assert 1 <= len(plans) <= len(levels) and 1 <= len(greedy) <= len(levels)
    # CAROM may pay more at the outer level, never less than greedy's min
    assert plans[0].da_elems >= greedy[0].da_elems * 0.999


@pytest.mark.parametrize("n_cores", [8, 3])
def test_schedulers_match_jax(n_cores):
    rng = np.random.default_rng(3)
    work = rng.pareto(1.5, 100) * 100 + 10
    xfer = work * 0.1
    for name in ("schedule_naive", "schedule_round_robin_sorted",
                 "schedule_lpt"):
        got = getattr(schedule, name)(work, n_cores)
        want = getattr(jschedule, name)(work, n_cores)
        np.testing.assert_array_equal(got.core_of_tile, want.core_of_tile)
        assert len(got.order_within) == len(want.order_within) == n_cores
        for a, b in zip(got.order_within, want.order_within):
            np.testing.assert_array_equal(a, b)
        assert got.makespan == want.makespan
        np.testing.assert_array_equal(got.per_core_work, want.per_core_work)
        assert schedule.phase_overlap_makespan(got, work, xfer, 1.0, 10.0) \
            == jschedule.phase_overlap_makespan(want, work, xfer, 1.0, 10.0)
    lpt = schedule.schedule_lpt(work, n_cores)
    assert lpt.makespan >= work.sum() / n_cores - 1e-9
    if n_cores == 8:  # the JAX test's order of the three, at its 8 cores
        paper = schedule.schedule_round_robin_sorted(work, n_cores)
        naive = schedule.schedule_naive(work, n_cores)
        assert lpt.makespan <= paper.makespan <= naive.makespan + 1e-9


def test_ops_per_tile_matches_jax():
    pairs = np.random.default_rng(4).integers(0, 500, 64)
    np.testing.assert_array_equal(schedule.ops_per_tile(pairs, 16, 32),
                                  jschedule.ops_per_tile(pairs, 16, 32))
