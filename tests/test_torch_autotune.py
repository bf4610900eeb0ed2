"""Port parity for measured dispatch (``repro_torch.engine.autotune``)
against the JAX package's ``repro.engine.autotune``, and the cost table,
cache, profiler and idle hook on their own. Mirrors
``tests/test_autotune.py``.

Signatures, encodings, dispatch overrides and plan tables are compared
exactly (the port's ``Dispatch`` has no ``block_n``; the JAX package's is
0 here). Conv outputs of a tuned plan are compared within 1e-4.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.engine import autotune as jautotune
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.engine.autotune import (
    CostTable,
    Measurement,
    ShapeSig,
    _bin_density,
    _synth_workload,
    default_cache_path,
    density_bin,
    measure,
    measure_backends,
    profile_group,
    reprofile,
    seed_cost_table,
    signature,
)
from repro_torch.engine.backends import Backend, ReferenceBackend
from repro_torch.engine.plan import REFERENCE_DISPATCH, Dispatch
from repro_torch.models.scn import UNetConfig, params_from_jax
from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
from repro_torch.sparse.tensor import SparseVoxelTensor

RES, CAP = 24, 2048
BUDGET = 16 * 1024  # small L1 budget: SPADE picks an actual tiling
CFG = dict(widths=(8, 16), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)
#: (n_in, n_out, c_in, c_out, density) of signatures both packages key
SIGS = [(1800, 1700, 16, 16, 0.011), (500, 500, 8, 8, 0.05),
        (1, 3, 4, 48, 0.0), (131072, 70000, 64, 64, 0.3),
        (0, 0, 8, 8, 1.0), (77000, 77000, 16, 16, 0.0046)]


def _scenes(seed):
    coords, feats, _, mask = make_scene(seed, resolution=RES, capacity=CAP)
    return (SparseVoxelTensor(coords, feats, mask),
            JSparseVoxelTensor(coords, feats, mask))


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**CFG)))
    model = params_from_jax(tree, UNetConfig(**CFG), device="cpu")
    return UNetConfig(**CFG), JUNetConfig(**CFG), model, _scenes(0)


def _fields(d) -> dict:
    """A dispatch's fields, the JAX package's ``block_n`` (0) dropped."""
    out = dataclasses.asdict(d)
    assert out.pop("block_n", 0) == 0
    return out


def _leaves(plan) -> list:
    """A host plan's tables in one order for both packages."""
    out = []
    for lvl in plan.levels:
        out += [lvl.coords, lvl.mask]
        for cp in (lvl.sub, lvl.down, lvl.up):
            if cp is not None:
                out += list(cp.coir) + ([] if cp.tiles is None
                                        else list(cp.tiles))
    return [np.asarray(x) for x in out]


def _assert_plans_equal(ours, theirs):
    a, b = _leaves(ours), _leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for la, lb in zip(ours.levels, theirs.levels):
        for ca, cb in ((la.sub, lb.sub), (la.down, lb.down),
                       (la.up, lb.up)):
            assert (ca is None) == (cb is None)
            if ca is not None:
                assert _fields(ca.dispatch) == _fields(cb.dispatch)


def _both_tables():
    return CostTable(fingerprint="f"), jautotune.CostTable(fingerprint="f")


# -- timing harness ----------------------------------------------------------

def test_measure_median_of_k():
    calls = []
    m = measure(lambda: calls.append(1), warmup=2, k=5)
    assert isinstance(m, Measurement)
    assert len(calls) == 7  # warmup included
    assert m.k == 5 and len(m.times_us) == 5
    assert m.times_us == tuple(sorted(m.times_us))
    assert m.median_us == m.times_us[2]
    assert m.spread_us >= 0.0


def test_measure_on_the_cpu_reads_the_host_clock(monkeypatch):
    """Work whose result lies on the CPU is timed by the host clock: no
    CUDA call is made (a synchronize here would raise without a card)."""
    def no_card(*a, **k):
        raise AssertionError("CUDA timing used for CPU work")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    m = measure(lambda: torch.ones(64) @ torch.ones(64), k=3)
    assert m.k == 3 and m.median_us > 0.0


# -- signatures --------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out,c_in,c_out,density", SIGS)
def test_signature_encodes_as_jax(n_in, n_out, c_in, c_out, density):
    for backend in ("", "reference", "sspnna"):
        ours = signature(n_in, n_out, c_in, c_out, density=density,
                         backend=backend)
        theirs = jautotune.signature(n_in, n_out, c_in, c_out,
                                     density=density, backend=backend)
        assert ours.encode() == theirs.encode()
        assert ShapeSig.decode(theirs.encode()) == ours
        assert ours.group().encode() == theirs.group().encode()
    assert density_bin(density) == jautotune.density_bin(density)


def test_signature_buckets_and_roundtrip():
    a = signature(1800, 1700, 16, 16, density=0.011, backend="sspnna")
    b = signature(2048, 1025, 16, 16, density=0.02, backend="sspnna")
    # row counts bucket to powers of two, densities to log-spaced bins
    assert a == b
    assert a.group() == signature(1100, 1030, 16, 16, density=0.015)
    assert ShapeSig.decode(a.encode()) == a
    with pytest.raises(ValueError):
        ShapeSig.decode("1:2:3")
    assert density_bin(0.0) == 0 and density_bin(1.0) == 8
    for b_ in range(9):
        assert density_bin(_bin_density(b_)) == b_
        assert _bin_density(b_) == jautotune._bin_density(b_)


# -- persistence -------------------------------------------------------------

def _filled_table():
    t = CostTable(fingerprint="test-rig")
    t.record(signature(500, 500, 8, 8, density=0.05, backend="reference"),
             100.0, k=3)
    t.record(signature(500, 500, 8, 8, density=0.05, backend="sspnna"),
             50.0, delta_o=32, delta_i=123, k=3)
    return t


def test_cache_round_trip(tmp_path):
    t = _filled_table()
    path = t.save(str(tmp_path / "sub" / "autotune.json"))
    back = CostTable.load(path, fingerprint="test-rig")
    assert back.load_status == "ok"
    assert len(back) == len(t) == 2
    assert back.generation == t.generation
    best = back.best(signature(512, 512, 8, 8, density=0.05))
    assert best.sig.backend == "sspnna"
    assert (best.delta_o, best.delta_i) == (32, 123)
    assert not list(tmp_path.glob("sub/.autotune-*"))  # no temp file left


def test_cache_missing_and_corrupt(tmp_path):
    missing = CostTable.load(str(tmp_path / "nope.json"), fingerprint="x")
    assert missing.load_status == "missing" and len(missing) == 0

    bad = tmp_path / "bad.json"
    bad.write_text("{truncated")
    t = CostTable.load(str(bad), fingerprint="x")
    assert t.load_status == "corrupt" and len(t) == 0

    # valid JSON, garbled entries: also falls back to an empty table
    payload = _filled_table().to_payload()
    payload["entries"][0]["sig"] = "not-a-sig"
    bad.write_text(json.dumps(payload))
    t = CostTable.load(str(bad), fingerprint="test-rig")
    assert t.load_status == "corrupt" and len(t) == 0


def test_cache_version_and_fingerprint_mismatch(tmp_path):
    src = _filled_table()
    path = src.save(str(tmp_path / "autotune.json"))

    t = CostTable.load(path, fingerprint="another-machine")
    assert t.load_status == "fingerprint-mismatch" and len(t) == 0

    payload = json.loads(open(path).read())
    payload["plan_version"] = -999
    open(path, "w").write(json.dumps(payload))
    t = CostTable.load(path, fingerprint="test-rig")
    assert t.load_status == "version-mismatch" and len(t) == 0

    # a JAX package's cache of the same entries is another schema
    jpath = str(tmp_path / "jax.json")
    jt = jautotune.CostTable(fingerprint="test-rig")
    for e in src.entries():
        jt.record(jautotune.ShapeSig.decode(e.sig.encode()), e.median_us)
    jt.save(jpath)
    t = CostTable.load(jpath, fingerprint="test-rig")
    assert t.load_status == "version-mismatch" and len(t) == 0


def test_env_override_cache_path(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    # the JAX package's variable does not move the port's cache
    assert default_cache_path() != jautotune.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert default_cache_path() == str(tmp_path / "x.json")
    assert _filled_table().save() == str(tmp_path / "x.json")


def test_device_fingerprint_names_torch_and_the_device():
    fp = engine.device_fingerprint()
    assert fp.startswith(f"torch={torch.__version__}|")
    assert fp.endswith("|cpu") or "|cuda|" in fp
    assert CostTable().fingerprint == fp


# -- dispatch consult --------------------------------------------------------

ANALYTICAL = dict(backend="sspnna", flavor="CIRF", walk="OS", delta_o=32,
                  delta_i=123, n_tiles=4)
SHAPE = dict(n_in=500, n_out=500, c_in=8, c_out=8, density=0.05)


def test_adjust_dispatch_cold_is_identity_and_records_miss():
    t, jt = _both_tables()
    analytical = Dispatch(**ANALYTICAL)
    out = t.adjust_dispatch(analytical, **SHAPE)
    assert out is analytical  # unchanged: the very same object
    jt.adjust_dispatch(jengine.Dispatch(**ANALYTICAL), **SHAPE)
    assert t.miss_count == jt.miss_count == 1
    (gk, m), = t.hottest_misses()
    (jgk, jm), = jt.hottest_misses()
    assert gk.encode() == jgk.encode() and m == jm
    assert (m["delta_o"], m["delta_i"], m["backend"]) == (32, 123, "sspnna")


# (recorded (backend, us, delta_o, delta_i) in order, analytical dispatch)
FLIPS = [
    ([("reference", 50.0, 0, 0), ("sspnna", 100.0, 32, 123)], ANALYTICAL),
    ([("reference", 50.0, 0, 0), ("sspnna", 100.0, 32, 123),
      ("sspnna", 10.0, 16, 64)], {}),
    ([("sspnna", 10.0, 0, 0)], {}),                      # nothing to tile
    ([("sspnna", 10.0, 0, 0)], dict(ANALYTICAL, backend="reference")),
    ([("sspnna", 5.0, 16, 64), ("reference", 7.0, 0, 0)], ANALYTICAL),
]


@pytest.mark.parametrize("recorded,analytical", FLIPS)
def test_adjust_dispatch_matches_jax(recorded, analytical):
    """The same measurements in both tables override the same analytical
    decision the same way: cold, to reference, to a tiled sspnna, or kept
    when the winner carries no tile shape."""
    t, jt = _both_tables()
    flips = []
    for backend, us, d_o, d_i in recorded:
        kw = dict(density=SHAPE["density"], backend=backend)
        flips.append((
            t.record(signature(500, 500, 8, 8, **kw), us, delta_o=d_o,
                     delta_i=d_i),
            jt.record(jautotune.signature(500, 500, 8, 8, **kw), us,
                      delta_o=d_o, delta_i=d_i)))
    assert all(a == b for a, b in flips)
    assert t.generation == jt.generation
    out = t.adjust_dispatch(Dispatch(**analytical), **SHAPE)
    want = jt.adjust_dispatch(jengine.Dispatch(**analytical), **SHAPE)
    assert _fields(out) == _fields(want)
    assert t.hits == jt.hits == 1


def test_adjust_dispatch_flips_both_ways():
    t = CostTable(fingerprint="f")
    t.record(signature(500, 500, 8, 8, density=0.05, backend="reference"),
             50.0)
    t.record(signature(500, 500, 8, 8, density=0.05, backend="sspnna"),
             100.0, delta_o=32, delta_i=123)
    out = t.adjust_dispatch(Dispatch(**ANALYTICAL), **SHAPE)
    assert out == REFERENCE_DISPATCH  # measured: reference wins
    t.record(signature(500, 500, 8, 8, density=0.05, backend="sspnna"),
             10.0, delta_o=16, delta_i=64)
    out = t.adjust_dispatch(REFERENCE_DISPATCH, **SHAPE)
    assert out.backend == "sspnna"
    assert (out.delta_o, out.delta_i, out.n_tiles) == (16, 64, 0)


def test_winner_flip_bumps_generation_and_invalidates_plan_cache():
    t = CostTable(fingerprint="f")
    ctx = engine.ExecutionContext(autotune=t, device="cpu")
    ctx.plan_cache._plans["k"] = {"host": None, "device": {}}
    r0 = repr(t)
    sig_r = signature(500, 500, 8, 8, density=0.05, backend="reference")
    sig_s = signature(500, 500, 8, 8, density=0.05, backend="sspnna")
    assert t.record(sig_r, 100.0) is False  # first entry, no prior miss
    assert ctx.plan_cache.invalidations == 0
    assert t.record(sig_s, 50.0) is True    # winner flips
    assert t.generation == 1 and repr(t) != r0
    assert ctx.plan_cache.invalidations == 1
    assert len(ctx.plan_cache) == 0
    # cheaper same-winner sample: no flip, no invalidation
    assert t.record(sig_s, 40.0) is False
    assert ctx.plan_cache.invalidations == 1


def test_first_measurement_after_miss_counts_as_flip():
    t = CostTable(fingerprint="f")
    d = t.adjust_dispatch(REFERENCE_DISPATCH, **SHAPE)
    assert d == REFERENCE_DISPATCH and t.miss_count == 1
    flipped = t.record(
        signature(500, 500, 8, 8, density=0.05, backend="reference"), 9.0)
    assert flipped is True  # plans were built on the analytical fallback
    assert t.miss_count == 0


# -- plan-build integration --------------------------------------------------

def test_cold_table_builds_the_untuned_and_the_jax_plans(setup):
    cfg, jcfg, _, (t, jt) = setup
    table, jtable = _both_tables()
    p0 = engine.build_scene_plan_host(t, cfg, mem_budget=BUDGET)
    p1 = engine.build_scene_plan_host(t, cfg, mem_budget=BUDGET,
                                      autotune=table)
    want = jengine.build_scene_plan_host(jt, jcfg, mem_budget=BUDGET,
                                         autotune=jtable)
    assert any(lvl.sub.dispatch.backend == "sspnna" for lvl in p0.levels)
    _assert_plans_equal(p0, want)
    _assert_plans_equal(p1, want)
    assert [s.get("autotuned") for s in p1.stats] == \
        [s.get("autotuned") for s in want.stats]
    assert table.miss_count == jtable.miss_count > 0
    assert sorted(g.encode() for g, _ in table.hottest_misses()) == \
        sorted(g.encode() for g, _ in jtable.hottest_misses())

    s0 = engine.build_plan_spec([t], cfg, mem_budget=BUDGET)
    s1 = engine.build_plan_spec([t], cfg, mem_budget=BUDGET, autotune=table)
    assert s0 == s1


@pytest.mark.parametrize("winner", ["reference", "sspnna"])
def test_measured_winner_redirects_the_build_as_jax(setup, winner):
    """One fake measurement set in both packages' tables: the adaptive
    builds and the pinned specs they redirect have equal tables and
    dispatches, and the tuned plan computes what the untuned one does."""
    cfg, jcfg, model, (t, jt) = setup
    base = engine.build_scene_plan_host(t, cfg, mem_budget=BUDGET)
    loser = "sspnna" if winner == "reference" else "reference"
    table, jtable = _both_tables()
    for li, lvl in enumerate(base.levels):
        n = int(np.asarray(lvl.mask).sum())
        den = n / float(max(cfg.resolution >> li, 1)) ** 3
        c = cfg.widths[li]
        for name, us in ((winner, 1.0), (loser, 100.0)):
            tiles = dict(delta_o=32, delta_i=123) if name == "sspnna" else {}
            table.record(signature(n, n, c, c, density=den, backend=name),
                         us, **tiles)
            jtable.record(jautotune.signature(n, n, c, c, density=den,
                                              backend=name), us, **tiles)
    tuned = engine.build_scene_plan_host(t, cfg, mem_budget=BUDGET,
                                         autotune=table)
    want = jengine.build_scene_plan_host(jt, jcfg, mem_budget=BUDGET,
                                         autotune=jtable)
    _assert_plans_equal(tuned, want)
    assert all(lvl.sub.dispatch.backend == winner for lvl in tuned.levels)
    assert [s["autotuned"] for s in tuned.stats] == [winner] * 2
    assert table.hits == jtable.hits >= len(tuned.levels)
    # a pinned spec consults the table at the capacity's signature
    spec = engine.build_plan_spec([t], cfg, mem_budget=BUDGET,
                                  autotune=table)
    jspec = jengine.build_plan_spec([jt], jcfg, mem_budget=BUDGET,
                                    autotune=jtable)
    assert [_fields(d) for d in spec.levels] == \
        [_fields(d) for d in jspec.levels]
    # and the tuned plan still computes the same forward
    with torch.no_grad():
        ref = engine.apply_unet(model, t.feats,
                                engine.upload_scene_plan(base, "cpu"),
                                backend="reference", device="cpu")
        got = engine.apply_unet(model, t.feats,
                                engine.upload_scene_plan(tuned, "cpu"),
                                device="cpu")
    m = np.asarray(t.mask)
    np.testing.assert_allclose(got.numpy()[m], ref.numpy()[m],
                               rtol=1e-4, atol=1e-4)


# -- profiling ---------------------------------------------------------------

class _Doubler(ReferenceBackend):
    """A test backend: the reference conv, twice over."""

    name = "doubler"

    def run(self, x, params, plan, *, use_kernel: bool = True):
        super().run(x, params, plan)
        return super().run(x, params, plan)


class _SceneOnly(Backend):
    name = "scene_only"
    scene_level = True

    def run(self, x, params, plan, *, use_kernel: bool = True):
        raise AssertionError("scene-level backends are not profiled")


def test_measure_backends_walks_registry(setup):
    cfg, _, model, (t, _) = setup
    plan = engine.build_scene_plan(t, cfg, mem_budget=BUDGET, device="cpu")
    lvl = next(lvl for lvl in plan.levels
               if lvl.sub.dispatch.backend == "sspnna")
    reg = engine.default_registry().view()
    reg.register("doubler", _Doubler())
    reg.register("scene_only", _SceneOnly())
    times = measure_backends(lvl.sub, torch.from_numpy(t.feats),
                             model.stem.params, registry=reg, k=1)
    assert set(times) == {"reference", "sspnna", "doubler"}
    assert all(m.median_us > 0 and m.k == 1 for m in times.values())
    # the view's registrations never reach the process default
    assert "doubler" not in engine.default_registry()
    assert set(measure_backends(lvl.sub, torch.from_numpy(t.feats),
                                model.stem.params, k=1)) == \
        {"reference", "sspnna"}


@pytest.mark.parametrize("sig,d_o,d_i", [
    (ShapeSig(256, 256, 8, 8, 27, 5), 32, 123),
    (ShapeSig(512, 512, 4, 16, 27, 6), 0, 0),
    (ShapeSig(64, 64, 8, 8, 27, 1), 8, 16),   # plane-split: d_i widens
])
def test_synth_workload_tables_match_jax(sig, d_o, d_i):
    ours = _synth_workload(sig, delta_o=d_o, delta_i=d_i, seed=3,
                           device="cpu")
    theirs = jautotune._synth_workload(
        jautotune.ShapeSig.decode(sig.encode()), delta_o=d_o, delta_i=d_i,
        seed=3)
    (plan, feats, params), (jplan, jfeats, jparams) = ours, theirs
    assert _fields(plan.dispatch) == _fields(jplan.dispatch)
    for x, y in zip(list(plan.coir) + list(plan.tiles),
                    list(jplan.coir) + list(jplan.tiles)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_array_equal(params.weight.numpy(),
                                  np.asarray(jparams.weight))


def test_profile_group_resolves_miss():
    table = CostTable(fingerprint="f")
    sig = signature(256, 256, 8, 8, density=0.05)
    table.note_miss(sig, delta_o=32, delta_i=123, backend="sspnna")
    ctx = engine.ExecutionContext(device="cpu")
    results = profile_group(table, sig, delta_o=32, delta_i=123, k=1,
                            ctx=ctx)
    assert set(results) == {"reference", "sspnna"}
    assert table.miss_count == 0 and len(table) == 2
    best = table.best(sig)
    assert best is not None and (best.delta_o, best.delta_i) == (32, 123)


def test_profile_group_unsynthesizable_drops_miss():
    table = CostTable(fingerprint="f")
    sig = ShapeSig(0, 0, 8, 8, 27, 3)  # zero rows: cannot be realized
    table.note_miss(sig)
    assert profile_group(table, sig,
                         ctx=engine.ExecutionContext(device="cpu")) == {}
    assert table.miss_count == 0 and len(table) == 0


def test_reprofile_budget_gates():
    table = CostTable(fingerprint="f")
    ctx = engine.ExecutionContext(device="cpu")
    for n in (256, 512):
        table.note_miss(signature(n, n, 8, 8, density=0.05),
                        delta_o=32, delta_i=123)
    assert reprofile(table, ctx=ctx, budget_ms=0.0) == 0  # off
    assert table.miss_count == 2
    assert reprofile(table, ctx=ctx, budget_ms=60_000.0, max_sigs=1,
                     k=1) == 1
    assert table.miss_count == 1 and len(table) == 2
    # a spent budget stops before the next signature
    assert reprofile(table, ctx=ctx, budget_ms=1e-9, k=1) == 0
    # then the stalest consulted group once no miss is left
    assert reprofile(table, ctx=ctx, budget_ms=60_000.0, k=1,
                     max_sigs=1) == 1
    assert table.miss_count == 0
    table.best(signature(256, 256, 8, 8, density=0.05))
    (stale,) = table.stalest_groups()
    assert stale == signature(256, 256, 8, 8, density=0.05)
    assert reprofile(table, ctx=ctx, budget_ms=60_000.0, k=1) == 1
    assert table.stalest_groups() == []


# -- serving idle-gap hook ---------------------------------------------------

@pytest.mark.parametrize("budget_ms", [60_000.0, 0.0])
def test_scene_engine_idle_hook(setup, budget_ms):
    cfg, _, model, (t, _) = setup
    table = CostTable(fingerprint="f")
    table.note_miss(signature(256, 256, 8, 8, density=0.05),
                    delta_o=32, delta_i=123, backend="sspnna")
    ctx = engine.ExecutionContext(autotune=table, device="cpu",
                                  autotune_reprofile_ms=budget_ms)
    eng = SceneEngine(cfg, model, batch=1, ctx=ctx)
    try:
        assert (eng.scheduler.on_idle is None) == (budget_ms == 0.0)
        eng.submit([SceneRequest(0, t)])
        eng.serve()
    finally:
        eng.close()
    if budget_ms:
        assert eng.scheduler.idle_ticks >= 1
        assert table.miss_count == 0 and len(table) == 2  # profiled
    else:
        assert table.miss_count == 1 and len(table) == 0


def test_scene_engine_without_a_table_installs_no_idle_hook(setup):
    cfg, _, model, _ = setup
    eng = SceneEngine(cfg, model, batch=1, ctx=engine.ExecutionContext(
        device="cpu", autotune_reprofile_ms=1e3))
    try:
        assert eng.scheduler.on_idle is None
    finally:
        eng.close()


# -- seeding from bench artifacts -------------------------------------------

def test_seed_cost_table_matches_jax(tmp_path):
    rows = [
        # canonical: a row with an explicit sig token
        {"name": "dispatch/r16_c8_reference", "us_per_call": 1000.0,
         "derived": "sig=512:512:8:8:27:7:reference:0 delta_o=128 "
                    "delta_i=225 spread_us=3.0"},
        # sspnna sweep rows: fused -> sspnna, xla -> reference
        {"name": "sspnna/r24_c16_fused", "us_per_call": 900.0,
         "derived": "density=0.0750 T=12 alive=9 dO=32 dI=128 C=16 N=16 "
                    "modeled_hbm_mb=0.50"},
        {"name": "sspnna/r24_c16_xla", "us_per_call": 400.0,
         "derived": "density=0.0750 T=12 alive=9 dO=32 dI=128 C=16 N=16 "
                    "modeled_hbm_mb=0.75"},
        # skipped: no engine backend corresponds to the pre-gathered arm
        {"name": "sspnna/r24_c16_pregathered", "us_per_call": 1800.0,
         "derived": "density=0.0750 dO=32 dI=128 C=16 N=16"},
        # skipped: analytical row
        {"name": "tableIII/L2-like/uops_saving", "us_per_call": 0.0,
         "derived": "512x"},
    ]
    art = tmp_path / "BENCH_x.json"
    art.write_text(json.dumps({"schema": "bench-rows/v1", "rows": rows}))
    table, jtable = _both_tables()
    paths = [str(art), str(tmp_path / "missing.json")]
    assert seed_cost_table(table, paths) == \
        jautotune.seed_cost_table(jtable, paths) == 3
    assert sorted((e.sig.encode(), e.median_us, e.delta_o, e.delta_i)
                  for e in table.entries()) == \
        sorted((e.sig.encode(), e.median_us, e.delta_o, e.delta_i)
               for e in jtable.entries())
    n_active = round(0.075 * 24 ** 3)
    best = table.best(signature(n_active, n_active, 16, 16, density=0.075))
    assert best.sig.backend == "reference"
    d = table.adjust_dispatch(
        Dispatch("sspnna", "CIRF", "OS", 32, 128, 4),
        n_in=n_active, n_out=n_active, c_in=16, c_out=16, density=0.075)
    assert d == REFERENCE_DISPATCH
