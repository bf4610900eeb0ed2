"""Port parity for the backend circuit breakers and the chained registry
(``repro_torch.engine.backends``) against the JAX package's
``repro.engine.backends``, and the scene engine's breaker wiring against
the JAX ``SceneEngine`` under the same injected faults. Mirrors the
breaker part of ``tests/test_faults.py``.

Breaker states and board generations are compared exactly; served logits
within 1e-4 (max |got - want| / max(|want|, 1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.engine import backends as jbackends
from repro.engine.context import ExecutionContext as JExecutionContext
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.serving import faults as jfaults
from repro.serving.api import AdmissionPolicy as JAdmissionPolicy
from repro.serving.scene_engine import SceneEngine as JSceneEngine
from repro.serving.scene_engine import SceneRequest as JSceneRequest
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.engine import backends
from repro_torch.engine.backends import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    Backend,
    BackendRegistry,
    BreakerBoard,
    CircuitBreaker,
    default_registry,
    register_backend,
)
from repro_torch.models.scn import UNetConfig, params_from_jax
from repro_torch.serving.api import AdmissionPolicy
from repro_torch.serving import faults
from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
from repro_torch.sparse.tensor import SparseVoxelTensor

RES, CAP = 16, 1024
CFG = dict(widths=(8, 16), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)
TOL = 1e-4


class _Null(Backend):
    def __init__(self, name, fallback=None):
        self.name, self.fallback = name, fallback

    def run(self, x, params, plan, *, use_kernel: bool = True):
        return x


class _JNull(jbackends.Backend):
    def __init__(self, name, fallback=None):
        self.name, self.fallback = name, fallback

    def run(self, x, params, plan, *, ctx, **kw):
        return x


def _chain(reg, null, links):
    for name, fallback in links:
        reg.register(name, null(name, fallback))
    return reg


# -- circuit breakers (fake clock) -------------------------------------------

def test_circuit_breaker_state_machine():
    now = [0.0]
    br = CircuitBreaker("x", failure_threshold=2, cooldown_s=5.0,
                        clock=lambda: now[0])
    assert br.state == CLOSED and br.allow()
    assert not br.record_failure()         # 1 strike: still closed
    assert br.record_failure()             # 2nd strike: trips
    assert br.state == OPEN and br.trips == 1
    assert not br.allow()                  # cooling
    now[0] = 5.1
    assert br.allow()                      # cooldown passed: one probe
    assert br.state == HALF_OPEN
    assert br.record_failure()             # probe failed: re-open
    assert br.state == OPEN and br.trips == 2
    now[0] = 10.3
    assert br.allow() and br.state == HALF_OPEN
    assert br.record_success()             # probe succeeded: closed
    assert br.state == CLOSED and br.consecutive_failures == 0
    assert br.snapshot() == {"state": CLOSED, "consecutive_failures": 0,
                             "trips": 2}
    with pytest.raises(ValueError):
        CircuitBreaker("x", failure_threshold=0)


# call sequences on a board over a -> b -> c: (op, name) with op in
# fail / ok / allow / route / tick (advance the clock by `name` seconds)
SEQUENCES = {
    "trip_and_recover": [("fail", "a"), ("route", "a"), ("fail", "a"),
                         ("route", "a"), ("tick", 6.0), ("route", "a"),
                         ("ok", "a"), ("route", "a")],
    "chain_walks_past_two": [("fail", "a"), ("fail", "a"), ("fail", "b"),
                             ("fail", "b"), ("route", "a"), ("allow", "c"),
                             ("allow", "a"), ("route", "mystery")],
    "probe_fails_and_reopens": [("fail", "a"), ("fail", "a"),
                                ("tick", 5.5), ("allow", "a"),
                                ("fail", "a"), ("route", "a"),
                                ("tick", 5.5), ("route", "a"), ("ok", "a"),
                                ("ok", "a"), ("fail", "a")],
    "half_open_keeps_the_generation": [("fail", "a"), ("fail", "a"),
                                       ("tick", 9.0), ("route", "a"),
                                       ("route", "a"), ("allow", "a"),
                                       ("ok", "b"), ("fail", "c")],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_board_call_sequences_match_jax(name):
    """The same calls on both packages' boards give the same answers,
    states and generations after every call; HALF_OPEN (a probe allowed)
    changes no generation, so cached plans keep hitting until a probe's
    outcome is recorded."""
    links = [("a", "b"), ("b", "c"), ("c", None)]
    now = [0.0]
    ours = BreakerBoard(_chain(BackendRegistry(), _Null, links),
                        failure_threshold=2, cooldown_s=5.0,
                        clock=lambda: now[0])
    theirs = jbackends.BreakerBoard(
        _chain(jbackends.BackendRegistry(), _JNull, links),
        failure_threshold=2, cooldown_s=5.0, clock=lambda: now[0])
    bumps = ([], [])
    ours.add_hook(lambda: bumps[0].append(ours.generation))
    theirs.add_hook(lambda: bumps[1].append(theirs.generation))
    for op, arg in SEQUENCES[name]:
        if op == "tick":
            now[0] += arg
            continue
        fn = {"fail": "record_failure", "ok": "record_success",
              "allow": "allow", "route": "route"}[op]
        assert getattr(ours, fn)(arg) == getattr(theirs, fn)(arg), (op, arg)
        assert ours.states() == theirs.states()
        assert ours.generation == theirs.generation
        assert repr(ours) == repr(theirs)
    assert bumps[0] == bumps[1]
    if name == "half_open_keeps_the_generation":
        assert ours.states()["a"]["state"] == HALF_OPEN
        assert ours.generation == 1


def test_breaker_board_fallback_cycle_is_safe():
    reg = _chain(BackendRegistry(), _Null, [("a", "b"), ("b", "a")])
    board = BreakerBoard(reg, failure_threshold=1, cooldown_s=99.0)
    board.record_failure("a")
    board.record_failure("b")
    # both blocked and the chain is a cycle: something must still serve
    assert board.route("a") in ("a", "b")


def test_breaker_board_hooks_fire_on_state_change_only():
    reg = _chain(BackendRegistry(), _Null, [("a", None)])
    board = BreakerBoard(reg, failure_threshold=2, cooldown_s=99.0)
    bumps = []
    board.add_hook(lambda: bumps.append(board.generation))
    board.record_failure("a")
    assert bumps == []          # no state change yet
    board.record_failure("a")
    assert bumps == [1]         # trip -> hook (cache invalidation) fires
    board.record_success("x")   # unknown backend: no-op
    assert bumps == [1]
    assert "x" not in board.states()

    def boom():
        raise RuntimeError("observer bug")

    board2 = BreakerBoard(reg, failure_threshold=1, cooldown_s=99.0)
    board2.add_hook(boom)
    assert board2.record_failure("a")  # hook errors never break serving
    assert board2.configure(failure_threshold=4).failure_threshold == 4


# -- the chained registry ----------------------------------------------------

def test_registry_views_chain_and_shadow():
    base = default_registry()
    view = base.view()
    assert view.names() == base.names() == ("reference", "sharded", "sspnna")
    assert "sspnna" in view and "mystery" not in view
    view.register("mystery", _Null("mystery", "reference"))
    assert "mystery" in view and "mystery" not in base
    assert view.names() == ("mystery", "reference", "sharded", "sspnna")
    with pytest.raises(ValueError, match="already registered"):
        view.register("sspnna", _Null("sspnna"))
    shadow = _Null("sspnna", "reference")
    view.register("sspnna", shadow, overwrite=True)
    assert view.get("sspnna") is shadow
    assert base.get("sspnna") is not shadow
    view.unregister("sspnna")   # only this registry's own registration
    assert view.get("sspnna") is base.get("sspnna")
    view.unregister("reference")  # the parent's stays
    assert "reference" in view
    assert view.breakers is not base.breakers
    with pytest.raises(TypeError):
        view.register("broken", object())


def test_register_backend_reaches_every_context():
    ctx = engine.ExecutionContext(device="cpu")
    impl = _Null("process_wide", "reference")
    try:
        assert register_backend("process_wide", impl) is impl
        assert ctx.backend("process_wide") is impl
        assert "process_wide" in engine.available_backends()
        with pytest.raises(ValueError, match="already registered"):
            register_backend("process_wide", impl)
    finally:
        default_registry().unregister("process_wide")
    assert "process_wide" not in ctx.registry
    assert default_registry() is backends.DEFAULT_REGISTRY


def _scene(seed, cap=CAP):
    """Both packages' tensors of one scene; the JAX one on its device, as
    ``tests/test_faults.py`` makes them (a jit cache entry is keyed by the
    arguments' array types too)."""
    coords, feats, _, mask = make_scene(seed, resolution=RES, capacity=cap)
    return (SparseVoxelTensor(coords, feats, mask),
            JSparseVoxelTensor(*map(jnp.asarray, (coords, feats, mask))))


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**CFG)))
    model = params_from_jax(tree, UNetConfig(**CFG), device="cpu")
    reps = [_scene(100), _scene(101)]
    spec = engine.build_plan_spec([t for t, _ in reps], UNetConfig(**CFG),
                                  mem_budget=16 * 1024)
    jspec = jengine.build_plan_spec([j for _, j in reps], JUNetConfig(**CFG),
                                    mem_budget=16 * 1024)
    assert any(d.backend == engine.SSPNNA for d in spec.levels)
    return tree, model, spec, jspec


def test_breaker_trip_invalidates_context_plan_cache():
    ctx = engine.ExecutionContext(device="cpu")
    ctx.registry.breakers.configure(failure_threshold=1, cooldown_s=99.0)
    t, _ = _scene(820)
    ctx.plan_cache.get_or_build(t, UNetConfig(**CFG), plan_tiles=False,
                                device=False)
    assert len(ctx.plan_cache) == 1
    ctx.registry.breakers.record_failure("sspnna")  # trips immediately
    assert len(ctx.plan_cache) == 0  # hook dropped stale-routing plans
    # breakers are context-scoped: the process default board is untouched
    assert "sspnna" not in default_registry().breakers.states()


@pytest.mark.parametrize("pinned", [False, True])
def test_tripped_board_reroutes_the_build_as_jax(setup, pinned):
    """A board with ``sspnna`` tripped reroutes every sspnna level of an
    adaptive or pinned build to reference in both packages: tables,
    dispatches and ``breaker_rerouted`` stats equal, and the board's repr
    in the cache key rotates."""
    _, _, spec, jspec = setup
    t, jt = _scene(300)
    board = BreakerBoard(default_registry(), failure_threshold=1)
    jboard = jbackends.BreakerBoard(jbackends.default_registry(),
                                    failure_threshold=1)
    kw = dict(spec=spec) if pinned else dict(mem_budget=16 * 1024)
    jkw = dict(spec=jspec) if pinned else dict(mem_budget=16 * 1024)
    cfg, jcfg = UNetConfig(**CFG), JUNetConfig(**CFG)
    cache = engine.PlanCache()
    before = cache.key_for(t, cfg, breakers=board, **kw)
    for b in (board, jboard):
        assert b.record_failure("sspnna")
    assert cache.key_for(t, cfg, breakers=board, **kw) != before
    got = engine.build_scene_plan_host(t, cfg, breakers=board, **kw)
    want = jengine.build_scene_plan_host(jt, jcfg, breakers=jboard, **jkw)
    assert all(lvl.sub.dispatch.backend == engine.REFERENCE
               and lvl.sub.tiles is None for lvl in got.levels)
    assert [s.get("breaker_rerouted") for s in got.stats] == \
        [s.get("breaker_rerouted") for s in want.stats]
    assert any(s.get("breaker_rerouted") for s in got.stats)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a.sub.coir.indices,
                                      np.asarray(b.sub.coir.indices))
        assert a.sub.dispatch.backend == b.sub.dispatch.backend


# -- the serving engine under dispatch faults --------------------------------

def _faulted(tree, model, spec, jspec):
    """Both packages' engines on the pinned spec, batch 2, with three
    dispatch faults attributed to sspnna and a retry budget of 4."""
    def inj(mod):
        return mod.FaultInjector(mod.FaultPlan(seed=0, specs=(
            mod.FaultSpec("dispatch", rate=1.0, backend="sspnna",
                          max_fires=3),)))

    now = [0.0]
    reg = default_registry().view()
    reg.breakers = BreakerBoard(reg, failure_threshold=3, cooldown_s=60.0,
                                clock=lambda: now[0])
    ctx = engine.ExecutionContext(device="cpu", registry=reg)
    eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec, ctx=ctx,
                      faults=inj(faults),
                      policy=AdmissionPolicy(max_retries=4,
                                             retry_backoff_ms=1.0))
    jctx = JExecutionContext(plan_cache=jengine.PlanCache())
    jctx.registry.breakers.configure(failure_threshold=3, cooldown_s=60.0)
    jeng = JSceneEngine(JUNetConfig(**CFG), tree, 2, spec=jspec,
                        use_kernel=False, ctx=jctx, faults=inj(jfaults),
                        policy=JAdmissionPolicy(max_retries=4,
                                                retry_backoff_ms=1.0))
    return eng, jeng, now


def _serve(eng, req_cls, scenes, first_rid=0):
    handles = eng.submit([req_cls(first_rid + i, s)
                          for i, s in enumerate(scenes)])
    eng.serve()
    return {h.request.rid: np.asarray(h.result().logits) for h in handles}


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def test_dispatch_faults_trip_breaker_to_fallback_as_jax(setup):
    """Dispatch faults attributed to sspnna trip its breaker in both
    packages after the same three contained failures: every request still
    completes, on plans rerouted to reference, with logits within 1e-4 of
    the JAX engine's and the same number of compiles (graphs)."""
    tree, model, spec, jspec = setup
    eng, jeng, _ = _faulted(tree, model, spec, jspec)
    scenes = [_scene(300 + i) for i in range(4)]
    got = _serve(eng, SceneRequest, [t for t, _ in scenes])
    want = _serve(jeng, JSceneRequest, [j for _, j in scenes])
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for e in (eng, jeng):
        states = e.ctx.registry.breakers.states()
        assert states["sspnna"]["state"] == OPEN
        assert states["sspnna"]["trips"] == 1
        assert e.health()["breakers"] == states
        assert e.scheduler.wave_errors == 3
    assert eng.ctx.registry.breakers.generation == \
        jeng.ctx.registry.breakers.generation == 1
    assert eng.n_compilations == jeng.n_compilations
    (key,) = eng._buckets
    assert all(cp is None or cp[0].backend == engine.REFERENCE
               for cp in key[1][1])  # the rerouted signature
    for rid in got:
        assert _rel(got[rid], want[rid]) <= TOL
    eng.close()
    jeng.close()


def test_half_open_probe_closes_and_returns_to_sspnna(setup):
    """After the trip, cached reference plans keep hitting while the
    breaker cools; past the cooldown a new scene's build probes sspnna
    (HALF_OPEN, no generation bump), its drained wave closes the breaker
    (generation bump, cache invalidated), and the first scenes rebuild on
    sspnna: their logits equal a fault-free sspnna engine's, and the
    engine holds two signatures, one on each backend."""
    tree, model, spec, jspec = setup
    eng, _, now = _faulted(tree, model, spec, jspec)
    board = eng.ctx.registry.breakers
    scenes = [_scene(300 + i)[0] for i in range(2)]
    _serve(eng, SceneRequest, scenes)
    assert board.states()["sspnna"]["state"] == OPEN
    hits = eng.cache.hits
    _serve(eng, SceneRequest, scenes, first_rid=10)  # cooling: cache hits
    assert eng.cache.hits == hits + 2 and eng.n_compilations == 1
    now[0] += 61.0
    gen, invalidations = board.generation, eng.cache.invalidations
    _serve(eng, SceneRequest, [_scene(302)[0]], first_rid=20)  # the probe
    assert board.states()["sspnna"]["state"] == CLOSED
    assert board.generation == gen + 1
    assert eng.cache.invalidations == invalidations + 1
    again = _serve(eng, SceneRequest, scenes, first_rid=30)
    assert eng.n_compilations == 2
    assert {k[1][1][0][0].backend for k in eng._buckets} == \
        {engine.REFERENCE, engine.SSPNNA}
    eng.close()
    clean = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec,
                        ctx=engine.ExecutionContext(device="cpu"))
    want = _serve(clean, SceneRequest, scenes, first_rid=30)
    clean.close()
    assert clean.health()["breakers"] == {}
    for rid in want:
        np.testing.assert_array_equal(again[rid], want[rid])


def test_fault_free_engine_records_no_breaker_state(setup):
    """Without faults a served engine's board stays empty, and its waves'
    successes leave no breaker behind."""
    _, model, spec, _ = setup
    eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec,
                      ctx=engine.ExecutionContext(device="cpu"),
                      policy=AdmissionPolicy(max_retries=2))
    _serve(eng, SceneRequest, [_scene(300 + i)[0] for i in range(3)])
    assert eng.health()["breakers"] == {}
    assert eng.scheduler.wave_errors == 0
    assert eng.ctx.registry.breakers.generation == 0
    eng.close()


def test_wave_of_plans_from_both_sides_of_a_trip_raises(setup):
    """A plan built before a trip and one built after it disagree in
    signature: the wave raises, as the JAX engine's does, and no graph (no
    signature) is pinned for the mixed wave."""
    _, model, spec, _ = setup
    ctx = engine.ExecutionContext(device="cpu")
    ctx.registry.breakers.configure(failure_threshold=1)
    eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec, ctx=ctx)
    (t0, _), (t1, _) = _scene(300), _scene(301)

    def plan(t):
        return ctx.plan_cache.get_or_build(
            t, UNetConfig(**CFG), device="cpu", topology=ctx.topology_key(),
            **eng._plan_kw)

    before = plan(t0)
    ctx.registry.breakers.record_failure(engine.SSPNNA)
    after = plan(t1)
    assert before.levels[0].sub.dispatch.backend == engine.SSPNNA
    assert after.levels[0].sub.dispatch.backend == engine.REFERENCE
    feats = [torch.from_numpy(t.feats) for t in (t0, t1)]
    with pytest.raises(RuntimeError, match="diverged from the wave"):
        eng.run_wave(feats, [before, after], CAP)
    assert eng.n_compilations == 0
    eng.close()
