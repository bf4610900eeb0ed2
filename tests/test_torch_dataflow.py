"""Port parity for CAROM and the ops-sorted schedulers (``repro_torch.core.
carom`` and ``core.schedule``) against the JAX package on the CPU, on
``tests/test_dataflow.py``'s inputs: the shell scene of seed 7 at
resolution 28 (its neighbour and COIR tables built by the JAX package, as
that test builds them, and fed to both packages) and the Pareto work of
seed 3. Both modules are host code on integers and float64 sums in one
order, so every chosen dataflow, assignment and makespan is held equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_shell_scene
from repro.core import carom as jcarom
from repro.core import schedule as jschedule
from repro.core import soar as jsoar
from repro.core import spade as jspade
from repro.core.hashgrid import build_neighbor_table, kernel_offsets
from repro.core.sparse_conv import submanifold_coir
from repro.sparse.tensor import from_dense
from repro_torch.core import carom, schedule, soar, spade

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
