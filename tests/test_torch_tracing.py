"""The port's serving spans and counters on the CPU: the span tree of a
wave in both scheduler modes, the stage timers read off the spans, the
spans as ``torch.profiler`` ranges (and no range without a profiler), the
bytes a wave moves, queue waits, spans of contained failures, and
``slo_stats``' supported tail."""
import threading
import time

import numpy as np
import pytest
import torch

from portbench.frozen.trace import read_profile
from repro_torch import engine
from repro_torch.configs import get_config
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.engine.api import apply_unet
from repro_torch.engine.plan import build_scene_plan, stack_plans
from repro_torch.models.scn import SCNUNet, UNetConfig
from repro_torch.models.transformer import init_lm
from repro_torch.serving import scheduler
from repro_torch.serving.api import AdmissionPolicy, ServeRequest
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
from repro_torch.sparse.tensor import SparseVoxelTensor

RES, CAP, BATCH = 32, 2048, 2
CFG = dict(widths=(16, 32, 48), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)
PROMPT_LEN, MAX_NEW = 12, 3
SCENE_SPANS = {"serve.dispatch": ["scene.upload", "scene.stage",
                                  "scene.replay"],
               "serve.drain": ["scene.wait", "scene.readback",
                               "scene.finish"]}
LM_SPANS = {"serve.dispatch": ["lm.prefill", "lm.decode"],
            "serve.drain": ["lm.wait", "lm.readback", "lm.finish"]}


def _scene(seed) -> SparseVoxelTensor:
    coords, feats, _, mask = make_scene(seed, RES, CAP)
    return SparseVoxelTensor(coords, feats, mask)


@pytest.fixture(scope="module")
def unet():
    torch.manual_seed(0)
    cfg = UNetConfig(**CFG)
    return cfg, SCNUNet(cfg, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return [_scene(s) for s in (300, 301, 302)]


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("stablelm-1.6b").reduced()
    return cfg, init_lm(cfg, device="cpu")


def _scene_engine(unet, sync=True, **kw):
    cfg, model = unet
    return SceneEngine(cfg, model, BATCH, sync=sync,
                       ctx=engine.ExecutionContext(device="cpu"), **kw)


def _serve_scenes(eng, scenes, rids=range(4)):
    handles = [eng.submit(SceneRequest(i, scenes[i % len(scenes)]))
               for i in rids]
    eng.serve()
    return [h.result() for h in handles]


def _lm_engine(lm, sync=True, **kw):
    cfg, params = lm
    return Engine(cfg, params, BATCH, PROMPT_LEN, MAX_NEW, device="cpu",
                  sync=sync, **kw)


def _serve_prompts(eng, n=4):
    rng = np.random.default_rng(3)
    handles = eng.submit([Request(i, rng.integers(1, 100, 5 + i)
                                  .astype(np.int32), max_new=MAX_NEW)
                          for i in range(n)])
    eng.serve()
    return [h.result() for h in handles]


def _check_tree(st, inner: dict, sync: bool):
    """Names, nesting, wave ids, request ids and order of one wave's
    spans."""
    spans = st.spans
    assert [sp.index for sp in spans] == list(range(len(spans)))
    assert all(sp.wave == st.wave and sp.end_ms is not None
               and sp.start_ms <= sp.end_ms for sp in spans)
    top = [sp for sp in spans if sp.parent == -1]
    stages = [sp.name for sp in top if sp.name != "serve.plan"]
    assert stages == (["serve.admit", "serve.dispatch", "serve.drain"]
                      if sync else ["serve.admit", "serve.plan_wait",
                                    "serve.dispatch", "serve.drain"])
    plans = st.named("serve.plan")
    assert sorted(sp.rid for sp in plans) == sorted(st.rids)
    assert all(sp.parent == -1 for sp in plans)
    admit, dispatch = st.named("serve.admit")[0], st.named("serve.dispatch")[0]
    assert all(admit.end_ms <= sp.start_ms and sp.end_ms <= dispatch.start_ms
               for sp in plans)
    if sync:  # serial: in request order
        assert [sp.rid for sp in plans] == list(st.rids)
    stage_order = [sp.start_ms for sp in top if sp.name != "serve.plan"]
    assert stage_order == sorted(stage_order)
    for parent, names in inner.items():
        (p,) = st.named(parent)
        kids = [sp for sp in spans if sp.parent == p.index]
        assert [sp.name for sp in kids] == names
        assert all(p.start_ms <= k.start_ms <= k.end_ms <= p.end_ms
                   for k in kids)
        assert all(k.rid is None for k in kids)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_scene_wave_span_tree(unet, scenes, sync):
    eng = _scene_engine(unet, sync=sync)
    _serve_scenes(eng, scenes)
    eng.close()
    assert [st.wave for st in eng.wave_stats] == [0, 1]
    for st in eng.wave_stats:
        _check_tree(st, SCENE_SPANS, sync)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_lm_wave_span_tree(lm, sync):
    eng = _lm_engine(lm, sync=sync)
    _serve_prompts(eng)
    eng.close()
    assert len(eng.wave_stats) == 2
    for st in eng.wave_stats:
        _check_tree(st, LM_SPANS, sync)
        # the CPU measures no device time; notes stay the engine's own
        assert st.event_ms == {} and st.first_token_ms == ()
        assert st.notes == {} and st.pending == {}


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_stage_timers_are_read_off_the_spans(unet, scenes, sync):
    eng = _scene_engine(unet, sync=sync)
    _serve_scenes(eng, scenes)
    eng.close()
    for st in eng.wave_stats:
        plans = st.named("serve.plan")
        (dispatch,) = st.named("serve.dispatch")
        (drain,) = st.named("serve.drain")
        assert st.plan_ms == sum(sp.end_ms - sp.start_ms for sp in plans)
        assert st.dispatch_ms == dispatch.end_ms - dispatch.start_ms
        assert st.drain_ms == drain.end_ms - drain.start_ms
        assert st.device_ms == drain.end_ms - dispatch.start_ms
        if sync:
            assert st.plan_span_ms == st.plan_ms == st.plan_wait_ms
        else:
            (wait,) = st.named("serve.plan_wait")
            assert st.plan_span_ms == (max(sp.end_ms for sp in plans)
                                       - min(sp.start_ms for sp in plans))
            assert st.plan_wait_ms == wait.end_ms - wait.start_ms


def test_spans_are_profiler_ranges(unet, scenes):
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = _scene_engine(unet)
    _serve_scenes(eng, scenes, rids=range(2))  # plans built, cache warm
    warm = len(eng.wave_stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            _serve_scenes(eng, scenes, rids=range(2, 6))
    eng.close()
    tr = read_profile(prof, "portbench.window")
    waves = eng.wave_stats[warm:]
    ours = sorted(sp.name for st in waves for sp in st.spans)
    traced = sorted(n for n, _, _ in tr.host
                    if n.startswith(("serve.", "scene.")))
    assert traced == ours and len(waves) == 2
    assert not any(n.startswith(("serve.", "scene.")) for n, *_ in tr.device)


def test_no_profiler_range_without_a_profiler(unet, scenes, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    eng = _scene_engine(unet)
    _serve_scenes(eng, scenes, rids=range(2))
    assert entered == [] and eng.wave_stats[0].spans
    with profile(activities=[ProfilerActivity.CPU]):
        _serve_scenes(eng, scenes, rids=range(2, 4))
    eng.close()
    assert sorted(entered) == sorted(
        sp.name for sp in eng.wave_stats[1].spans)


def test_scene_wave_counters(unet, scenes):
    eng = _scene_engine(unet)
    _serve_scenes(eng, scenes, rids=range(3))  # a full wave, then a short one
    _serve_scenes(eng, scenes, rids=range(3, 5))
    eng.close()
    first, short, again = eng.wave_stats
    assert [len(st.rids) for st in eng.wave_stats] == [2, 1, 2]
    # a short wave is padded to the batch, and the drain copies all of it:
    # the logits in f32 and a byte a row of classes
    for st in eng.wave_stats:
        assert st.readback_bytes == BATCH * CAP * (N_CLASSES * 4 + 1)
        assert st.notes["pred_device_rows"] == BATCH * CAP
        assert st.event_ms == {} and st.pending == {}


def test_lm_wave_counters(lm):
    eng = _lm_engine(lm)
    _serve_prompts(eng, n=3)
    eng.close()
    assert [len(st.rids) for st in eng.wave_stats] == [2, 1]
    for st in eng.wave_stats:
        assert st.readback_bytes == BATCH * MAX_NEW * 4
        assert st.event_ms == {} and st.pending == {}


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_second_wave_waits_the_first_waves_service(sync):
    def dispatch(reqs, payloads, st):
        time.sleep(0.03)
        return payloads

    sched = scheduler.WaveScheduler(
        batch=1, plan=lambda r: r.rid, dispatch=dispatch,
        drain=lambda reqs, h, st: None, sync=sync, depth=1)
    reqs = [ServeRequest(i) for i in range(2)]
    sched.submit(reqs)
    sched.run()
    first, second = sched.stats
    assert all(r.submit_ts <= r.admit_ts for r in reqs)
    assert first.queue_wait_ms == (reqs[0].admit_ts - reqs[0].submit_ts,)
    (wait,) = second.queue_wait_ms
    assert wait == reqs[1].admit_ts - reqs[1].submit_ts
    assert wait >= first.device_ms >= 30.0


class _Flaky:
    """A dispatch that fails for request 1 on its first two tries, and
    that hangs once past the watchdog on its first call with ``hang``."""

    def __init__(self, hang: bool):
        self.hang, self.tries = hang, 0
        self.release = threading.Event()

    def __call__(self, reqs, payloads, st):
        self.tries += 1
        if self.hang and self.tries == 1:
            self.release.wait(5.0)
        elif not self.hang and 1 in [r.rid for r in reqs] and self.tries < 4:
            raise RuntimeError("poisoned")
        return payloads


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("hang", [False, True], ids=["bisect", "watchdog"])
def test_contained_failures_leave_no_span_open(sync, hang):
    flaky = _Flaky(hang)
    policy = AdmissionPolicy(max_retries=2, retry_backoff_ms=1.0,
                             stage_timeout_s=0.2 if hang else None)
    sched = scheduler.WaveScheduler(
        batch=2, plan=lambda r: r.rid, dispatch=flaky,
        drain=lambda reqs, h, st: None, sync=sync, policy=policy)
    reqs = [ServeRequest(i) for i in range(2)]
    sched.submit(reqs)
    sched.run()
    # the hung stage's thread is still asleep here, its span closed
    assert sched.failed_stats and sched.wave_errors == len(sched.failed_stats)
    flaky.release.set()
    assert all(r.status == scheduler.COMPLETED for r in reqs)
    for st in sched.failed_stats + sched.stats:
        assert st.spans and all(sp.end_ms is not None for sp in st.spans)
        assert st.pending == {}
    failed = sched.failed_stats[0]
    (dispatch,) = failed.named("serve.dispatch")
    assert dispatch.end_ms >= dispatch.start_ms
    if hang:
        assert dispatch.end_ms - dispatch.start_ms >= 190.0
    else:  # bisected: both requests end in solo waves
        assert len(failed.rids) == 2
        assert sorted(len(st.rids) for st in sched.stats) == [1, 1]


def test_spans_from_many_threads_keep_their_places():
    """Planner threads append spans to one wave at once: every span's index
    is its place in the list and its parent is its own thread's outer
    span."""
    import sys

    st = scheduler.WaveStats(0, (), False)
    n_threads, n_spans = 16, 200
    start = threading.Barrier(n_threads)

    def work(t):
        start.wait(10.0)
        for i in range(n_spans):
            with st.span("outer", rid=(t, i)) as outer:
                with st.span("inner", rid=(t, i)) as inner:
                    assert inner.parent == outer.index

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,), daemon=True,
                                    name=f"span-{t}")
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(st.spans) == 2 * n_threads * n_spans
    assert [sp.index for sp in st.spans] == list(range(len(st.spans)))
    for sp in st.spans:
        parent = st.spans[sp.parent] if sp.parent >= 0 else None
        if sp.name == "inner":
            assert parent.name == "outer" and parent.rid == sp.rid
        else:
            assert parent is None
        assert sp.end_ms is not None
    assert all(stack == [] for stack in st._open.values())


def _completed(n):
    out = []
    for i in range(n):
        r = ServeRequest(i)
        r.submit_ts, r.done_ts = 0.0, float(i + 1)
        out.append(r)
    return out


@pytest.mark.parametrize("n,q", [(0, None), (19, None), (20, "p50"),
                                 (99, "p50"), (100, "p90"), (999, "p90"),
                                 (1000, "p99")])
def test_slo_tail_has_ten_completions_beyond_it(n, q):
    sched = scheduler.WaveScheduler(batch=1, plan=lambda r: r,
                                    dispatch=lambda *a: None,
                                    drain=lambda *a: None)
    sched.completed.extend(_completed(n))
    slo = sched.slo_stats()
    assert slo["tail_q"] == q and slo["tail_n"] == n
    if q is None:
        assert slo["tail_ms"] is None
    else:
        frac = {"p50": 0.5, "p90": 0.9, "p99": 0.99}[q]
        want = 1.0 + (n - 1) * frac
        assert slo["tail_ms"] == pytest.approx(want)
        assert sum(1 for r in sched.completed
                   if r.latency_ms > slo["tail_ms"]) >= 10


def test_apply_unet_marks_its_level_boundaries(unet, scenes):
    cfg, model = unet
    plan = stack_plans([build_scene_plan(scenes[0], cfg, device="cpu")])
    seen = []
    with torch.inference_mode():
        want = apply_unet(model, scenes[0].feats, plan, device="cpu")
        got = apply_unet(model, scenes[0].feats, plan, device="cpu",
                         mark=seen.append)
    assert torch.equal(got, want)
    n = len(cfg.widths)
    assert seen == (["start", "rows", "stem"]
                    + [f"enc{i}" for i in range(n)]
                    + [f"dec{i}" for i in range(n - 2, -1, -1)] + ["head"])
