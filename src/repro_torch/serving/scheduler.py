"""Shared wave scheduler: the queueing/batching core of the engines (the
port's copy of ``repro.serving.scheduler``; pure Python, same lock names).

AccSS3D's headline move is overlapping the offline pass (AdMAC metadata +
SOAR reordering + SPADE selection) with accelerator execution. Serving-side
that means a three-stage pipeline over request *waves* of up to ``batch``:

* **plan** — per-request host work (plan-cache builds, prompt packing) runs
  on a small thread pool, up to ``depth`` waves ahead of the device;
* **dispatch** — one wave's device work, enqueued without a host sync
  (CUDA's stream ordering: the host gets device tensors back before the
  compute finishes);
* **drain** — result readback, which only blocks for wave *k−depth* while
  wave *k* is planning and wave *k−1* is executing.

``WaveScheduler`` owns the request deque, admission, completion plumbing
and per-wave timing; the engines plug in the three stage callbacks:

    plan(request) -> payload               # host-only, thread-safe
    dispatch(requests, payloads, stats) -> h  # enqueue device work, no block
    drain(requests, h, stats) -> None      # block on h, fill request results

``stats`` is the wave's ``WaveStats``; dispatch may record engine-specific
observations in ``stats.notes`` (e.g. the sharded scene engine records the
per-shard plan builds and halo rows of each wave) — they ride along with
the timing rows in ``scheduler.stats``.

Admission is FIFO by default. Passing an :class:`AdmissionPolicy` (and/or a
``bucket_of`` compatibility hook) turns on *continuous batching with
SLO-aware admission* — the vLLM-style idea transplanted onto scene waves:

* each wave is filled greedily from the most urgent **compatible** queued
  requests (same ``bucket_of`` key — e.g. the scene engine's capacity
  bucket), so a straggler at the head of the queue is preempted to a later
  wave instead of head-of-line blocking everything behind it;
* urgency is strict ``priority`` first, then weighted per-tenant fairness
  (stride scheduling over ``tenant_weights`` — a one-tenant flood cannot
  starve the others), then earliest deadline, then arrival order;
* requests whose ``deadline_ms`` has already expired are **shed** at
  admission time — surfaced on ``scheduler.shed`` with ``status="shed"``
  and a ``shed_reason``, never silently dropped — and ``max_queue``
  bounds the queue with explicit overload shedding at submit time
  (backpressure instead of unbounded buffering).

``sync=True`` degenerates to the classic blocking wave loop (same stages,
run back-to-back on the caller's thread) — numerics are identical in both
modes because the stages are *and* admission is: both modes admit from the
same queue state with the same policy, so the same admitted wave order
produces bitwise-identical results. Any stage exception re-queues every
admitted but uncompleted request at the front of the queue (in-flight
device waves are drained first), so a poisoned wave neither deadlocks the
pipeline nor drops requests.

**Failure containment.** With ``AdmissionPolicy.max_retries > 0`` the
scheduler *contains* stage failures instead of propagating them:

* a failed multi-request wave is **bisected** — every member's wave cap is
  halved and the wave re-queued, so within ``log2(batch)`` rounds a single
  poisoned request is isolated into a solo wave without charging its
  innocent wave-mates a retry;
* a failed **solo** wave charges the request one retry; past the budget it
  lands terminally on ``scheduler.failed`` with ``status="failed"`` /
  ``shed_reason="error"`` (counted by ``slo_stats()`` under
  ``shed_by_reason["error"]``), otherwise it backs off exponentially
  (``retry_backoff_ms * 2**(n-1)``) before re-admission;
* ``stage_timeout_s`` arms a watchdog on the plan and dispatch stages —
  a hung stage raises :class:`StageTimeout`, which is contained like any
  other stage error;
* injected :class:`~repro_torch.serving.faults.WorkerDeath` (a BaseException,
  simulating a dying worker thread) is contained too; real
  ``KeyboardInterrupt``/``SystemExit`` still propagate.

With ``max_retries == 0`` (the default) the legacy requeue-and-raise
behavior is preserved exactly.

Per-wave ``WaveStats`` make the overlap *and* the admission measurable:
``plan_ms`` is the host plan work (summed over requests), ``plan_span_ms``
its wall-clock span, ``plan_wait_ms`` the span remainder the dispatcher
actually had to wait for, ``overlap_frac = 1 - wait/span`` the fraction
hidden behind device execution (0 in sync mode by construction);
``queue_depth`` / ``bucket`` / ``fill_frac`` / ``n_shed`` describe what
admission saw and decided. ``slo_stats()`` aggregates the per-request
view: p50/p99 latency, the highest quantile the sample supports, deadline
goodput, shed counts.

**Spans.** Each wave's stages are :class:`Span` s on its ``WaveStats``
(``spans``, in the order they opened), on the host's clock: ``serve.admit``
(the admission pass that formed the wave), ``serve.plan`` (one a request,
on whichever thread planned it), ``serve.plan_wait`` (async mode: the
dispatcher waiting on the wave's plan futures), ``serve.dispatch`` and
``serve.drain``; the engines open theirs inside the last two
(``scene.*``, ``lm.*``). A span's parent is the innermost span of the same
wave open on the same thread. The stage timers are read off the spans:
``plan_ms`` sums the ``serve.plan`` spans, ``plan_span_ms`` is their
envelope, ``dispatch_ms``/``drain_ms`` are those spans, ``device_ms`` runs
from the dispatch's start to the drain's end. While a ``torch.profiler``
records, each span is also a ``record_function`` range of its name, so it
lies in the device trace on the profiler's clock;
otherwise a span costs two clock reads. A failed wave's open spans are
closed when the failure is handled (a stage abandoned by the watchdog
included), and its ``WaveStats`` lands on ``failed_stats``.

Besides the spans, a wave keeps ``readback_bytes`` (device to host in the
drain) and per request ``queue_wait_ms`` (``submit_ts`` to ``admit_ts``,
which admission stamps). The engines put the device times they measure
with their own CUDA events in ``event_ms`` (empty on the CPU).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from collections.abc import Callable, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.analysis.runtime import ordered_lock
from repro_torch.serving.faults import WorkerDeath

# request lifecycle states (mirrored by serving.api.ServeRequest.status)
QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
SHED = "shed"
FAILED = "failed"


class StageTimeout(RuntimeError):
    """A plan/dispatch stage exceeded ``AdmissionPolicy.stage_timeout_s``."""


def overlap_fraction(plan_span_ms: float, plan_wait_ms: float) -> float:
    """Fraction of the plan stage's wall-clock span hidden behind device
    execution. The span (first build start -> last build end), not the sum
    of per-thread build times, is the denominator, so planner-thread
    parallelism within a wave doesn't masquerade as pipeline overlap."""
    if plan_span_ms <= 0.0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - plan_wait_ms / plan_span_ms))


@dataclass(frozen=True)
class AdmissionPolicy:
    """SLO-aware admission knobs for :class:`WaveScheduler`.

    ``max_queue`` is the backpressure bound: a submit beyond it is shed
    immediately with ``shed_reason="overload"`` (the caller gets the
    request back with ``status="shed"``, never a silent drop).
    ``shed_expired`` sheds requests whose ``submit_ts + deadline_ms`` has
    passed at admission time with ``shed_reason="deadline"``.
    ``tenant_weights`` drive stride-scheduled weighted fairness between
    tenants (missing tenants get ``default_weight``); a tenant with twice
    the weight gets twice the admitted share under contention.

    ``max_retries`` caps how many times a *solo* failed wave is retried
    before the request fails terminally (``status="failed"``,
    ``shed_reason="error"``); 0 (the default) preserves the legacy
    requeue-and-raise behavior. ``retry_backoff_ms`` is the base of the
    exponential backoff between retries. ``stage_timeout_s`` arms a
    watchdog on the plan and dispatch stages (None disables it).
    """

    max_queue: int | None = None
    shed_expired: bool = True
    tenant_weights: Mapping[str, float] | None = None
    default_weight: float = 1.0
    max_retries: int = 0
    retry_backoff_ms: float = 10.0
    stage_timeout_s: float | None = None

    def weight(self, tenant: str) -> float:
        w = (self.tenant_weights or {}).get(tenant, self.default_weight)
        return max(float(w), 1e-9)


@dataclass(eq=False)
class Span:
    """One stage of one wave on the host's clock (``time.perf_counter``,
    ms). ``parent`` is the index in ``WaveStats.spans`` of the innermost
    span of the wave open on the same thread when this one opened (-1 at
    the top); ``rid`` is the request's id where the span belongs to one
    request. ``end_ms`` is None while the span is open."""

    name: str
    start_ms: float
    end_ms: float | None = None
    parent: int = -1
    wave: int = -1
    rid: object = None
    index: int = field(default=-1, repr=False)
    thread: int = field(default=0, repr=False)
    _range: object = field(default=None, repr=False)

    @property
    def ms(self) -> float:
        return self.end_ms - self.start_ms

    def end(self) -> None:
        """End the span now (if still open); on its own thread, also exit
        its profiler range."""
        if self.end_ms is None:
            self.end_ms = _now_ms()
        if self._range is not None and self.thread == threading.get_ident():
            self._range.__exit__(None, None, None)
            self._range = None


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a
    ``torch.profiler`` records, else None. The check is torch's own flag for
    it (``torch.autograd.profiler._is_profiler_enabled``); no profiler can
    record before torch is loaded, so the scheduler never imports it."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rng = prof.record_function(name)
    rng.__enter__()
    return rng


def _open_span(name: str, rid=None) -> Span:
    """A span opened now on the calling thread (a ``record_function``
    range too while a profiler records)."""
    sp = Span(name, 0.0, rid=rid, thread=threading.get_ident(),
              _range=_profiler_range(name))
    sp.start_ms = _now_ms()
    return sp


@dataclass
class WaveStats:
    """Timing of one wave through the plan/dispatch/drain stages (ms),
    plus what admission saw when it formed the wave, its spans and its
    counters (module docstring)."""

    wave: int
    rids: tuple
    sync: bool
    plan_ms: float = 0.0       # host plan-stage work, summed over requests
    plan_span_ms: float = 0.0  # wall-clock span of this wave's plan builds
    plan_wait_ms: float = 0.0  # span remainder the dispatcher waited on
    dispatch_ms: float = 0.0   # host time enqueueing the wave's device work
    device_ms: float = 0.0     # dispatch call -> results drained
    drain_ms: float = 0.0      # time blocked in readback
    queue_depth: int = 0       # queue length when admission ran
    n_shed: int = 0            # requests shed by this admission pass
    bucket: object = None      # bucket_of key the wave was filled from
    fill_frac: float = 1.0     # admitted / batch (padding slots are waste)
    #: engine-specific observations the dispatch stage records (e.g. the
    #: sharded scene engine's per-shard plan builds / halo rows)
    notes: dict = field(default_factory=dict)
    #: the wave's stages, in the order they opened
    spans: list = field(default_factory=list)
    readback_bytes: int = 0    # device -> host bytes the drain brought back
    #: per admitted request (wave order): submit_ts -> admit_ts (ms)
    queue_wait_ms: tuple = ()
    #: device ms the engine timed with its own CUDA events, read in the
    #: drain after its wait (empty on the CPU)
    event_ms: dict = field(default_factory=dict)
    #: LM, per request (wave order): submit_ts -> the first token on the
    #: host's clock (ms; empty on the CPU)
    first_token_ms: tuple = ()
    #: the engine's CUDA events between its dispatch and its drain
    pending: dict = field(default_factory=dict, repr=False)
    _open: dict = field(default_factory=dict, repr=False)
    # planner threads add spans at once
    _lock: object = field(default_factory=threading.Lock, repr=False,
                          compare=False)

    @property
    def overlap_frac(self) -> float:
        """Fraction of plan wall-clock hidden behind device execution."""
        return overlap_fraction(self.plan_span_ms, self.plan_wait_ms)

    def _adopt(self, sp: Span, stack: list | None) -> None:
        sp.wave = self.wave
        sp.parent = stack[-1].index if stack else -1
        with self._lock:
            sp.index = len(self.spans)
            self.spans.append(sp)

    @contextmanager
    def span(self, name: str, rid=None):
        """``with stats.span(name):`` a span of this wave around the
        block, on the calling thread."""
        sp = _open_span(name, rid)
        stack = self._open.setdefault(sp.thread, [])
        self._adopt(sp, stack)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.remove(sp)
            sp.end()

    def add_span(self, sp: Span) -> None:
        """End ``sp`` (opened before the wave existed, by
        :func:`_open_span`) as a top-level span of this wave."""
        self._adopt(sp, None)
        sp.end()

    def close_open(self) -> None:
        """End every span still open now: a failed stage's, including one
        a watchdog abandoned on its thread (that thread still exits the
        span's profiler range when it returns)."""
        now = _now_ms()
        for sp in self.spans:
            if sp.end_ms is None:
                sp.end_ms = now

    def span_ms(self, name: str) -> float:
        """Summed ms of the closed spans named ``name``, in span order."""
        return sum(sp.end_ms - sp.start_ms for sp in self.spans
                   if sp.name == name and sp.end_ms is not None)

    def named(self, name: str) -> list[Span]:
        return [sp for sp in self.spans if sp.name == name]


def _now_ms() -> float:
    return time.perf_counter() * 1e3


def _queue_waits(reqs: list) -> tuple:
    """submit_ts -> admit_ts (ms) of each request that carries both."""
    out = []
    for r in reqs:
        t0 = getattr(r, "submit_ts", None)
        t1 = getattr(r, "admit_ts", None)
        if t0 is not None and t1 is not None:
            out.append(t1 - t0)
    return tuple(out)


#: (name, quantile) of the tail quantiles ``slo_stats`` may report, highest
#: first
_TAILS = (("p99", 0.99), ("p90", 0.90), ("p50", 0.50))


def _tail(sorted_vals: list[float]) -> dict:
    """The highest quantile of ``_TAILS`` that has at least ten values
    beyond it, with the number of values."""
    n = len(sorted_vals)
    for name, q in _TAILS:
        if n * (1.0 - q) >= 10.0 - 1e-9:
            return {"tail_q": name, "tail_ms": _percentile(sorted_vals, q),
                    "tail_n": n}
    return {"tail_q": None, "tail_ms": None, "tail_n": n}


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending list (numpy-free so
    the scheduler core stays dependency-light)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class WaveScheduler:
    """Wave admission + async pipeline shared by the LM and 3D engines."""

    def __init__(
        self,
        *,
        batch: int,
        plan: Callable,
        dispatch: Callable,
        drain: Callable,
        sync: bool = True,
        depth: int = 2,
        planner_threads: int = 2,
        policy: AdmissionPolicy | None = None,
        bucket_of: Callable | None = None,
        on_shed: Callable | None = None,
        on_idle: Callable | None = None,
        faults=None,
        on_wave_error: Callable | None = None,
    ):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if planner_threads < 1:
            raise ValueError(
                f"planner_threads must be >= 1, got {planner_threads}")
        self.batch = batch
        self.sync = sync
        self.depth = depth
        self.planner_threads = planner_threads
        self.policy = policy
        self.bucket_of = bucket_of
        #: optional observer called on every shed request (e.g. the scene
        #: engine unblocks a stream whose frame was shed mid-sequence)
        self.on_shed = on_shed
        #: optional idle-gap worker, called as ``on_idle(self)`` after a
        #: ``run()`` drains the queue — strictly between ticks, never on
        #: the serving hot path (the scene engine wires the autotune
        #: re-profiler here when the context opts in with a budget)
        self.on_idle = on_idle
        self.idle_ticks = 0
        #: optional FaultInjector (serving.faults) exercising the plan /
        #: dispatch / slow-wave / worker-death seams; None = zero cost
        self.faults = faults
        #: optional observer called as ``on_wave_error(exc, reqs, stage)``
        #: whenever a wave fails in contained mode (the scene engine feeds
        #: backend circuit breakers from here)
        self.on_wave_error = on_wave_error
        self._plan, self._dispatch, self._drain = plan, dispatch, drain
        self.queue: deque = deque()
        self.completed: list = []
        self.shed: list = []
        self.failed: list = []
        self.stats: list[WaveStats] = []
        #: ``WaveStats`` of the waves that failed, their spans closed
        self.failed_stats: list[WaveStats] = []
        self.retries_charged = 0   # total solo-wave retries granted
        self.wave_errors = 0       # total contained wave failures
        self.last_wave_ts: float | None = None  # monotonic, last _finish
        #: set by ServingBase.serve_forever: a resident thread owns run(),
        #: so RequestHandle.result() must wait instead of driving
        self.resident = False
        #: signals the resident serving thread that work arrived
        self._work = threading.Event()
        #: mode of the run in progress (stages may consult it to trade
        #: host syncs for pipelining); None outside ``run``
        self.running_sync: bool | None = None
        self._wave = 0
        self._seq = 0
        self._pool: ThreadPoolExecutor | None = None  # lazy, persists runs
        self._pool_lock = ordered_lock("scheduler.pool")
        self._idle = threading.Event()  # cleared while run() is on a thread
        self._idle.set()
        # stride-scheduling state: per-tenant virtual pass + global floor
        self._tenant_pass: dict[str, float] = {}
        self._vt = 0.0
        self._admit_info: dict = {}

    # -- queue plumbing ------------------------------------------------------

    @property
    def running(self) -> bool:
        """True while a ``run()`` is in progress on some thread."""
        return not self._idle.is_set()

    def enqueue(self, r, *, shed: str | None = None):
        """Admit one request into the queue: stamps ``submit_ts`` / ``seq``
        / ``status`` (on requests that carry them), applies the policy's
        backpressure bound, and returns the request. ``shed=`` lets a
        caller surface a request it already knows cannot be served (e.g.
        no capacity bucket fits) through the same shed plumbing."""
        self._stamp(r)
        if shed is not None:
            self.shed_request(r, shed)
            return r
        pol = self.policy
        if (pol is not None and pol.max_queue is not None
                and len(self.queue) >= pol.max_queue):
            self.shed_request(r, "overload")
            return r
        self.queue.append(r)
        self._work.set()
        return r

    def submit(self, reqs: Sequence) -> None:
        for r in reqs:
            self.enqueue(r)

    def __len__(self) -> int:
        return len(self.queue)

    def _stamp(self, r) -> None:
        """Give a request its arrival metadata; tolerate bare objects that
        don't carry the ServeRequest fields (legacy scheduler users)."""
        try:
            if getattr(r, "submit_ts", None) is None:
                r.submit_ts = _now_ms()
            if getattr(r, "seq", -1) < 0:
                r.seq = self._seq
                self._seq += 1
            if getattr(r, "_event", None) is None:
                r._event = threading.Event()
            r.status = QUEUED
        except (AttributeError, TypeError):
            pass

    def _set_status(self, r, status: str) -> None:
        try:
            r.status = status
        except (AttributeError, TypeError):
            return
        if status == RUNNING:
            try:
                r.admit_ts = _now_ms()
            except (AttributeError, TypeError):
                pass
        if status in (COMPLETED, SHED, FAILED):
            try:
                r.done_ts = _now_ms()
            except (AttributeError, TypeError):
                pass
            ev = getattr(r, "_event", None)
            if ev is not None:
                ev.set()

    def shed_request(self, r, reason: str) -> None:
        """Shed ``r`` with ``shed_reason=reason``: the request is surfaced
        on ``self.shed`` (and its completion event fires) — load shedding
        is explicit, never a silent drop."""
        try:
            r.shed_reason = reason
        except (AttributeError, TypeError):
            pass
        self._set_status(r, SHED)
        self.shed.append(r)
        if self.on_shed is not None:
            self.on_shed(r)

    def fail_request(self, r, exc) -> None:
        """Terminally fail ``r`` (retry budget exhausted): surfaced on
        ``self.failed`` with ``status="failed"`` / ``shed_reason="error"``
        and the causing exception on ``r.error``; the completion event
        fires so waiters wake (``RequestHandle.result()`` raises
        ``RequestFailedError``)."""
        try:
            r.error = exc
            r.shed_reason = "error"
        except (AttributeError, TypeError):
            pass
        self._set_status(r, FAILED)
        self.failed.append(r)
        if self.on_shed is not None:
            self.on_shed(r)

    @staticmethod
    def _expired(r, now: float) -> bool:
        deadline = getattr(r, "deadline_ms", None)
        submit_ts = getattr(r, "submit_ts", None)
        return (deadline is not None and submit_ts is not None
                and now > submit_ts + deadline)

    def _admit_key(self, r):
        """Urgency ordering: strict priority, then weighted tenant
        fairness, then earliest deadline, then arrival order."""
        deadline = getattr(r, "deadline_ms", None)
        submit_ts = getattr(r, "submit_ts", None) or 0.0
        expires = (submit_ts + deadline) if deadline is not None \
            else float("inf")
        tenant = getattr(r, "tenant", "default")
        return (-getattr(r, "priority", 0),
                self._tenant_pass.get(tenant, self._vt),
                expires, getattr(r, "seq", 0))

    def _charge_tenant(self, r) -> None:
        pol = self.policy
        if pol is None:
            return
        tenant = getattr(r, "tenant", "default")
        p = self._tenant_pass.get(tenant, self._vt)
        self._tenant_pass[tenant] = p + 1.0 / pol.weight(tenant)
        self._vt = max(self._vt, p)

    @staticmethod
    def _stream_heads(avail: list) -> list:
        """Restrict candidates to each stream's earliest queued frame.

        Stream requests (carrying ``_stream_key`` / ``_stream_frame``) are
        order-dependent: frame *t+1*'s incremental plan patches frame
        *t*'s, so admitting frames out of order would stall the plan stage
        on a frame that hasn't been planned yet. Non-stream requests pass
        through untouched, and the policy's urgency ordering still picks
        *between* streams — this only pins the order *within* one."""
        heads: dict = {}
        for r in avail:
            k = getattr(r, "_stream_key", None)
            if k is None:
                continue
            f = getattr(r, "_stream_frame", 0)
            if k not in heads or f < heads[k]:
                heads[k] = f
        if not heads:
            return avail
        return [r for r in avail
                if getattr(r, "_stream_key", None) is None
                or getattr(r, "_stream_frame", 0) == heads[r._stream_key]]

    def _admit(self) -> list:
        """Form the next wave. FIFO without a policy/bucket hook; with one,
        greedy continuous batching: shed expired requests, then fill from
        the most urgent compatible (same-bucket) candidates, preempting
        stragglers to later waves (stream requests are additionally held
        to per-stream FIFO frame order). May return ``[]`` when shedding
        emptied the queue — the caller skips the wave without a
        dispatch."""
        depth0 = len(self.queue)
        if self.policy is None and self.bucket_of is None:
            reqs = [self.queue.popleft()
                    for _ in range(min(self.batch, len(self.queue)))]
            for r in reqs:
                self._set_status(r, RUNNING)
            self._admit_info = dict(queue_depth=depth0, n_shed=0,
                                    bucket=None, n_admitted=len(reqs))
            return reqs
        now = _now_ms()
        n_shed = 0
        keep: list = []     # survivors, original queue order
        pending: list = []  # survivors that are also ready (not backing off)
        next_ready: float | None = None
        for r in self.queue:
            if (self.policy is not None and self.policy.shed_expired
                    and self._expired(r, now)):
                self.shed_request(r, "deadline")
                n_shed += 1
                continue
            keep.append(r)
            nb = getattr(r, "_not_before", None)
            if nb is not None and nb > now:
                # retry backoff: stays queued but is not a candidate yet
                next_ready = nb if next_ready is None else min(next_ready, nb)
            else:
                pending.append(r)
        admitted: list = []
        bucket = None
        limit = self.batch
        avail = list(pending)
        while avail and len(admitted) < limit:
            # bisection wave caps: a request whose cap is already filled
            # waits for a later (smaller) wave
            cands = [r for r in self._stream_heads(avail)
                     if (getattr(r, "_wave_cap", None) or self.batch)
                     > len(admitted)]
            if not cands:
                break
            best = min(cands, key=self._admit_key)
            if not admitted and self.bucket_of is not None:
                # first pick fixes the wave's signature bucket; everything
                # incompatible waits for a later wave instead of blocking
                bucket = self.bucket_of(best)
                avail = [r for r in avail
                         if self.bucket_of(r) == bucket]
            limit = min(limit, getattr(best, "_wave_cap", None) or self.batch)
            admitted.append(best)
            avail.remove(best)
            self._charge_tenant(best)
            self._set_status(best, RUNNING)
        admitted_ids = {id(r) for r in admitted}
        self.queue.clear()
        self.queue.extend(r for r in keep if id(r) not in admitted_ids)
        self._admit_info = dict(queue_depth=depth0, n_shed=n_shed,
                                bucket=bucket, n_admitted=len(admitted),
                                next_ready_ms=next_ready)
        return admitted

    def _requeue(self, waves: list[list]) -> None:
        """Put admitted-but-uncompleted waves back at the queue front."""
        pending = [r for wave in waves for r in wave]
        for r in pending:
            self._set_status(r, QUEUED)
        self.queue.extendleft(reversed(pending))
        if pending:
            self._work.set()

    # -- failure containment -------------------------------------------------

    @property
    def _contained(self) -> bool:
        """True when stage failures are handled in-loop (retry budgets,
        bisection) instead of the legacy requeue-and-raise."""
        pol = self.policy
        return pol is not None and pol.max_retries > 0

    @staticmethod
    def _containable(exc) -> bool:
        """Which exceptions containment may swallow: every ``Exception``
        plus the injected ``WorkerDeath`` BaseException — but never a real
        ``KeyboardInterrupt`` / ``SystemExit``."""
        return isinstance(exc, (Exception, WorkerDeath))

    def _handle_wave_failure(self, reqs: list, exc, stage: str) -> None:
        """Contained-mode response to a failed wave: bisect multi-request
        waves (halve every member's wave cap, requeue), charge solo waves
        a retry with exponential backoff, and fail terminally past the
        budget. Innocent wave-mates are never charged a retry — only a
        solo failure is attributable to its request."""
        self.wave_errors += 1
        if self.on_wave_error is not None:
            try:
                self.on_wave_error(exc, reqs, stage)
            except Exception:
                pass  # observers must not take down containment
        if len(reqs) > 1:
            for r in reqs:
                cap = getattr(r, "_wave_cap", None) or self.batch
                try:
                    r._wave_cap = max(1, cap // 2)
                except (AttributeError, TypeError):
                    pass
            self._requeue([reqs])
            return
        r = reqs[0]
        n = getattr(r, "retries", 0) + 1
        try:
            r.retries = n
            r.error = exc
        except (AttributeError, TypeError):
            pass
        self.retries_charged += 1
        pol = self.policy
        if n > pol.max_retries:
            self.fail_request(r, exc)
            return
        backoff = pol.retry_backoff_ms * (2.0 ** (n - 1))
        try:
            r._not_before = _now_ms() + backoff
        except (AttributeError, TypeError):
            pass
        self._requeue([reqs])

    def _idle_wait(self) -> None:
        """Sleep briefly when the queue holds only backing-off requests,
        so the run loop doesn't spin while waiting out a retry backoff."""
        ready = self._admit_info.get("next_ready_ms")
        delay_s = 0.001 if ready is None \
            else max(0.0, (ready - _now_ms()) / 1e3)
        time.sleep(min(delay_s, 0.05) + 1e-4)

    def _with_timeout(self, fn, args, budget_s, stage: str):
        """Watchdog: run ``fn(*args)`` bounded by ``budget_s``. The stage
        runs on a daemon thread so a genuine hang is abandoned (the thread
        leaks until it returns — the price of a watchdog in-process) and
        :class:`StageTimeout` is raised for containment to handle."""
        if budget_s is None:
            return fn(*args)
        box: dict = {}

        def _target():
            try:
                box["result"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["error"] = e

        t = threading.Thread(target=_target, daemon=True,
                             name=f"wave-watchdog-{stage}")
        t.start()
        t.join(budget_s)
        if t.is_alive():
            raise StageTimeout(
                f"{stage} stage exceeded {budget_s:.3f}s watchdog")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _new_stats(self, reqs: list, sync: bool,
                   admit: Span | None = None) -> WaveStats:
        info = self._admit_info
        st = WaveStats(self._wave, tuple(getattr(r, "rid", None)
                                         for r in reqs), sync,
                       queue_depth=info.get("queue_depth", len(reqs)),
                       n_shed=info.get("n_shed", 0),
                       bucket=info.get("bucket"),
                       fill_frac=len(reqs) / self.batch,
                       queue_wait_ms=_queue_waits(reqs))
        if admit is not None:
            st.add_span(admit)
        self._wave += 1
        return st

    def _admit_wave(self) -> tuple[list, Span]:
        """``_admit`` inside a ``serve.admit`` span (kept by the wave it
        forms)."""
        sp = _open_span("serve.admit")
        try:
            return self._admit(), sp
        except BaseException:
            sp.end()
            raise

    def _failed(self, st: WaveStats) -> None:
        """Keep a failed wave's stats, every span of it closed."""
        st.close_open()
        st.pending.clear()
        self.failed_stats.append(st)

    def _finish(self, reqs: list, st: WaveStats) -> None:
        st.pending.clear()
        self.stats.append(st)
        self.last_wave_ts = time.monotonic()
        for r in reqs:
            self._set_status(r, COMPLETED)
        self.completed.extend(reqs)

    def timings(self) -> dict:
        """Aggregate pipeline timings over every wave served so far."""
        span = sum(s.plan_span_ms for s in self.stats)
        wait = sum(s.plan_wait_ms for s in self.stats)
        return {
            "waves": len(self.stats),
            "plan_ms": sum(s.plan_ms for s in self.stats),
            "plan_span_ms": span,
            "plan_wait_ms": wait,
            "device_ms": sum(s.device_ms for s in self.stats),
            "drain_ms": sum(s.drain_ms for s in self.stats),
            "overlap_frac": overlap_fraction(span, wait),
        }

    def slo_stats(self) -> dict:
        """Per-request SLO view over everything served (or shed) so far:
        p50/p99 end-to-end latency (submit -> drain, ms), deadline goodput
        (completions that met their deadline, as a fraction of everything
        submitted and as completions/s), and shed counts by reason.

        Over few completions ``p99_ms`` is in effect their maximum, so
        ``tail_q`` / ``tail_ms`` give the highest of p50, p90 and p99 with
        at least ten completions beyond it (p99 from 1000 completions, p90
        from 100, p50 from 20; None below that), and ``tail_n`` the number
        of latencies it was read from. The JAX scheduler reports p50/p99
        only."""
        lats = []
        met = 0
        for r in self.completed:
            t0 = getattr(r, "submit_ts", None)
            t1 = getattr(r, "done_ts", None)
            if t0 is None or t1 is None:
                continue
            lats.append(t1 - t0)
            deadline = getattr(r, "deadline_ms", None)
            if deadline is None or (t1 - t0) <= deadline:
                met += 1
        lats.sort()
        shed_by_reason: dict[str, int] = {}
        for r in list(self.shed) + list(self.failed):
            reason = getattr(r, "shed_reason", None) or "unknown"
            shed_by_reason[reason] = shed_by_reason.get(reason, 0) + 1
        n_total = len(self.completed) + len(self.shed) + len(self.failed)
        ts = [getattr(r, "submit_ts", None) for r in self.completed]
        te = [getattr(r, "done_ts", None) for r in self.completed]
        ts = [t for t in ts if t is not None]
        te = [t for t in te if t is not None]
        wall_s = (max(te) - min(ts)) / 1e3 if ts and te else 0.0
        return {
            "n_completed": len(self.completed),
            "n_shed": len(self.shed),
            "n_failed": len(self.failed),
            "n_retries": self.retries_charged,
            "wave_errors": self.wave_errors,
            "shed_by_reason": shed_by_reason,
            "p50_ms": _percentile(lats, 0.50),
            "p99_ms": _percentile(lats, 0.99),
            **_tail(lats),
            "goodput_frac": met / n_total if n_total else 0.0,
            "goodput_rps": met / wall_s if wall_s > 0 else 0.0,
        }

    # -- execution -----------------------------------------------------------

    def run(self, sync: bool | None = None,
            max_waves: int | None = None) -> list:
        """Serve the queue (to empty, or at most ``max_waves`` admitted
        waves — the tick-driven mode arrival simulators use); returns the
        completed-request list. Only one ``run`` may be active at a time.

        When the queue drains completely, ``on_idle(self)`` (if set) runs
        *after* the pipeline is done — the idle gap between ticks, where
        background work (autotune re-profiling) can spend its budget
        without touching a serving wave."""
        if not self._idle.is_set():
            raise RuntimeError("run() already in progress on another thread")
        self._idle.clear()
        self.running_sync = self.sync if sync is None else sync
        try:
            if self.running_sync:
                self._run_sync(max_waves)
            else:
                self._run_async(max_waves)
        finally:
            self.running_sync = None
            self._idle.set()
        if self.on_idle is not None and not self.queue:
            self.idle_ticks += 1
            self.on_idle(self)
        return self.completed

    def _timed_plan(self, req, st: WaveStats):
        rid = getattr(req, "rid", None)
        with st.span("serve.plan", rid=rid) as sp:
            inj = self.faults
            if inj is not None:
                inj.maybe_fail("worker_death", rid=rid)
                inj.maybe_fail("plan", rid=rid)
            payload = self._plan(req)
        return payload, sp

    def _dispatch_with_faults(self, reqs, payloads, st):
        with st.span("serve.dispatch"):
            inj = self.faults
            if inj is not None:
                stall = inj.stall_ms(key=("wave", st.wave))
                if stall > 0:
                    time.sleep(stall / 1e3)
                inj.maybe_fail("dispatch", key=("wave", st.wave))
            return self._dispatch(reqs, payloads, st)

    def _drain_timed(self, reqs, handle, st: WaveStats) -> None:
        """The drain in its span; sets ``drain_ms`` and ``device_ms``."""
        with st.span("serve.drain") as sp:
            self._drain(reqs, handle, st)
        st.drain_ms = sp.ms
        st.device_ms = sp.end_ms - st.named("serve.dispatch")[0].start_ms

    def _run_sync(self, max_waves: int | None = None) -> None:
        waves_left = max_waves if max_waves is not None else float("inf")
        budget = self.policy.stage_timeout_s if self.policy is not None \
            else None
        while self.queue and waves_left > 0:
            reqs, admit = self._admit_wave()
            if not reqs:  # everything shed, or every request backing off
                admit.end()
                if self.queue:
                    self._idle_wait()
                continue
            waves_left -= 1
            st = self._new_stats(reqs, sync=True, admit=admit)
            stage = "plan"
            try:
                payloads = []
                for r in reqs:
                    payload, _ = self._with_timeout(
                        self._timed_plan, (r, st), budget, "plan")
                    payloads.append(payload)
                st.plan_ms = st.span_ms("serve.plan")
                st.plan_span_ms = st.plan_ms   # serial builds
                st.plan_wait_ms = st.plan_span_ms  # nothing hidden in sync
                stage = "dispatch"
                handle = self._with_timeout(
                    self._dispatch_with_faults, (reqs, payloads, st),
                    budget, "dispatch")
                st.dispatch_ms = st.span_ms("serve.dispatch")
                stage = "drain"
                self._drain_timed(reqs, handle, st)
            except BaseException as e:
                self._failed(st)
                if self._contained and self._containable(e):
                    self._handle_wave_failure(reqs, e, stage)
                    continue
                self._requeue([reqs])
                raise
            self._finish(reqs, st)

    def _pool_or_start(self) -> ThreadPoolExecutor:
        # lazy and persistent: paced workloads call run() per arrival group
        # and should not pay thread churn every time
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.planner_threads,
                    thread_name_prefix="wave-planner")
            return self._pool

    def close(self) -> None:
        """Shut down the planner thread pool (idempotent; a later run()
        lazily recreates it). Waits for any in-flight ``run`` — and with
        it every planner-thread future — to drain first, so a close racing
        an async run can neither cancel its plan builds nor leave the pool
        half-down."""
        self._idle.wait()
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    @staticmethod
    def _settle(futs) -> None:
        """Cancel-or-wait every future so no planner thread is still
        mutating a request we are about to requeue; stage errors of an
        already-failed wave are deliberately swallowed here."""
        for f in futs:
            if f.cancel():
                continue
            try:
                f.result()
            except BaseException:  # noqa: BLE001 - wave already handled
                pass

    def _run_async(self, max_waves: int | None = None) -> None:
        pool = self._pool_or_start()
        waves_left = max_waves if max_waves is not None else float("inf")
        contained = self._contained
        budget = self.policy.stage_timeout_s if self.policy is not None \
            else None
        planned: deque = deque()   # (reqs, stats, [plan futures])
        inflight: deque = deque()  # (reqs, stats, handle)
        failed: list = []          # requests of the wave that blew up
        futs: list = []            # plan futures of the wave being gathered
        try:
            while (self.queue and waves_left > 0) or planned or inflight:
                progressed = False
                # keep up to `depth` waves in the plan stage
                while (self.queue and waves_left > 0
                       and len(planned) < self.depth):
                    reqs, admit = self._admit_wave()
                    if not reqs:
                        admit.end()
                        # shedding emptied the queue, or every queued
                        # request is backing off — don't spin the fill loop
                        break
                    progressed = True
                    waves_left -= 1
                    failed = reqs  # cover the gap until safely planned
                    st = self._new_stats(reqs, sync=False, admit=admit)
                    wave_futs = [pool.submit(self._timed_plan, r, st)
                                 for r in reqs]
                    planned.append((reqs, st, wave_futs))
                    failed = []
                # dispatch the oldest planned wave (waits only for the
                # *remaining* plan time — the hidden part ran while the
                # previous wave was executing on the device)
                if planned:
                    progressed = True
                    reqs, st, futs = planned.popleft()
                    failed = reqs
                    stage = "plan"
                    try:
                        payloads, spans = [], []
                        with st.span("serve.plan_wait") as wait:
                            for f in futs:
                                try:
                                    payload, sp = f.result(timeout=budget)
                                except (_FutureTimeout, TimeoutError) as te:
                                    raise StageTimeout(
                                        f"plan stage exceeded {budget:.3f}s "
                                        f"watchdog") from te
                                payloads.append(payload)
                                spans.append(sp)
                        st.plan_ms = sum(sp.ms for sp in spans)
                        if spans:
                            st.plan_span_ms = (
                                max(sp.end_ms for sp in spans)
                                - min(sp.start_ms for sp in spans))
                        st.plan_wait_ms = wait.ms
                        stage = "dispatch"
                        handle = self._with_timeout(
                            self._dispatch_with_faults, (reqs, payloads, st),
                            budget, "dispatch")
                        st.dispatch_ms = st.span_ms("serve.dispatch")
                        inflight.append((reqs, st, handle))
                    except BaseException as e:
                        if not (contained and self._containable(e)):
                            self._failed(st)
                            raise
                        self._settle(futs)
                        self._failed(st)
                        self._handle_wave_failure(reqs, e, stage)
                    failed = []
                    futs = []
                # drain once the device pipeline is `depth` deep, or
                # unconditionally when there is nothing left to feed it
                while inflight and (
                        len(inflight) >= self.depth
                        or not ((self.queue and waves_left > 0) or planned)):
                    progressed = True
                    item = inflight.popleft()
                    failed = item[0]
                    try:
                        self._drain_one(item)
                    except BaseException as e:
                        self._failed(item[1])
                        if not (contained and self._containable(e)):
                            raise
                        self._handle_wave_failure(item[0], e, "drain")
                    failed = []
                if not progressed:
                    # queue holds only backing-off requests: wait out the
                    # shortest backoff instead of spinning
                    self._idle_wait()
        except BaseException:
            # salvage device work already in flight, then put every
            # unfinished request back so nothing is dropped; cancel queued
            # plan builds (of the failed wave and the lookahead waves) so
            # the exception isn't stalled behind them
            for f in futs:
                f.cancel()
            leftovers = []
            for item in inflight:
                try:
                    self._drain_one(item)
                except BaseException:
                    self._failed(item[1])
                    leftovers.append(item[0])
            leftovers.append(failed)
            for reqs, _, wave_futs in planned:
                for f in wave_futs:
                    f.cancel()
                leftovers.append(reqs)
            self._requeue(leftovers)
            raise

    def _drain_one(self, item) -> None:
        reqs, st, handle = item
        self._drain_timed(reqs, handle, st)
        self._finish(reqs, st)
