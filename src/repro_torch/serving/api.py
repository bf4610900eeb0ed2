"""One serving surface for the engines: requests, handles, engine base
(the port's copy of ``repro.serving.api``).

* :class:`ServeRequest` — the request base every payload subclass extends
  (the LM ``Request`` adds a prompt). Carries the SLO fields admission
  schedules on: ``tenant``, ``priority``, ``deadline_ms``, plus the
  lifecycle ``status`` ∈ {``queued``, ``running``, ``completed``,
  ``shed``, ``failed``} and timestamps the scheduler stamps
  (``submit_ts`` at submit, ``admit_ts`` at admission, ``done_ts`` at
  drain/shed).
* :class:`RequestHandle` — what ``submit()`` returns: a future-like view
  (``.done()``, ``.result(timeout=)``, ``.status``). ``result()`` drives
  the engine on the calling thread when nothing else is, or waits for the
  active run; a shed request raises :class:`RequestShedError` (shedding is
  surfaced, never silent).
* :class:`ServingBase` — the engine mixin owning the driver API: typed
  ``submit() -> RequestHandle``, ``serve()`` (pump the queue), a resident
  ``serve_forever()`` front door (background serving thread with graceful
  drain on ``close()`` and a ``health()`` liveness snapshot), and stats
  plumbing. The JAX package's deprecated list-returning ``run()`` and
  ``.completed`` shims are not carried over.

A request that exhausts its retry budget (``AdmissionPolicy.max_retries``)
ends in the terminal ``status="failed"`` / ``shed_reason="error"`` —
``result()`` raises :class:`RequestFailedError`, a subclass of
:class:`RequestShedError`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.analysis.runtime import ordered_lock
from repro_torch.serving.faults import WorkerDeath

from repro_torch.serving.scheduler import (
    COMPLETED,
    FAILED,
    QUEUED,
    RUNNING,
    SHED,
    AdmissionPolicy,
    WaveScheduler,
    WaveStats,
)

__all__ = [
    "COMPLETED", "FAILED", "QUEUED", "RUNNING", "SHED",
    "AdmissionPolicy", "RequestFailedError", "RequestHandle",
    "RequestShedError", "ServeRequest", "ServingBase", "WaveScheduler",
    "WaveStats",
]


@dataclass
class ServeRequest:
    """Base serving request: identity + SLO fields + lifecycle state.

    Engines subclass this with their payload (scene, prompt, ...). The
    SLO fields are keyword-only so payload subclasses keep their natural
    positional signatures (``SceneRequest(rid, scene)``).

    ``priority`` is strict (higher = more urgent); ``deadline_ms`` is
    relative to ``submit_ts``; ``tenant`` feeds weighted fairness. All
    three are only acted on when the scheduler runs an
    :class:`~repro_torch.serving.scheduler.AdmissionPolicy`.
    """

    rid: int
    tenant: str = field(default="default", kw_only=True)
    priority: int = field(default=0, kw_only=True)
    deadline_ms: float | None = field(default=None, kw_only=True)
    status: str = field(default=QUEUED, kw_only=True)
    shed_reason: str | None = field(default=None, kw_only=True)
    submit_ts: float | None = field(default=None, kw_only=True)
    #: when admission last put the request into a wave
    admit_ts: float | None = field(default=None, kw_only=True)
    done_ts: float | None = field(default=None, kw_only=True)
    seq: int = field(default=-1, kw_only=True)
    #: retries charged so far (solo-wave failures only; see scheduler)
    retries: int = field(default=0, kw_only=True)
    #: the exception that failed the request terminally (status="failed")
    #: or caused its most recent retry
    error: BaseException | None = field(
        default=None, kw_only=True, repr=False, compare=False)
    _event: threading.Event | None = field(
        default=None, kw_only=True, repr=False, compare=False)

    @property
    def latency_ms(self) -> float | None:
        """End-to-end submit -> drain latency, once completed/shed."""
        if self.submit_ts is None or self.done_ts is None:
            return None
        return self.done_ts - self.submit_ts


class RequestShedError(RuntimeError):
    """Raised by ``RequestHandle.result()`` for a shed request; carries
    the request (``.request``) with its ``shed_reason``."""

    def __init__(self, request: ServeRequest):
        self.request = request
        super().__init__(
            f"request {request.rid} was shed "
            f"({request.shed_reason or 'unknown'})")


class RequestFailedError(RequestShedError):
    """Raised by ``RequestHandle.result()`` for a terminally failed
    request (retry budget exhausted); subclasses
    :class:`RequestShedError` so pre-existing ``except RequestShedError``
    callers keep working. ``.request.error`` carries the last cause."""

    def __init__(self, request: ServeRequest):
        self.request = request
        cause = request.error
        RuntimeError.__init__(
            self,
            f"request {request.rid} failed after {request.retries} "
            f"retries ({type(cause).__name__ if cause else 'unknown'}: "
            f"{cause})")


class RequestHandle:
    """Future-like view of one submitted request."""

    __slots__ = ("request", "_scheduler")

    def __init__(self, request: ServeRequest, scheduler: WaveScheduler):
        self.request = request
        self._scheduler = scheduler

    @property
    def status(self) -> str:
        return self.request.status

    def done(self) -> bool:
        """True once the request reached a terminal state (completed,
        shed, or failed)."""
        return self.request.status in (COMPLETED, SHED, FAILED)

    def result(self, timeout: float | None = None) -> ServeRequest:
        """The fulfilled request (results filled in by the engine's drain
        stage). Drives the scheduler on the calling thread if no run (and
        no resident serving thread) is active; otherwise waits up to
        ``timeout`` seconds for the active run to complete it. Raises
        :class:`RequestShedError` if the request was shed,
        :class:`RequestFailedError` if it failed terminally,
        ``TimeoutError`` on timeout."""
        r = self.request
        if not self.done():
            if self._scheduler.running or self._scheduler.resident:
                ev = r._event
                if ev is None or not ev.wait(timeout):
                    raise TimeoutError(
                        f"request {r.rid} still {r.status} after "
                        f"{timeout}s")
            else:
                self._scheduler.run()
        if r.status == FAILED:
            raise RequestFailedError(r)
        if r.status == SHED:
            raise RequestShedError(r)
        if r.status != COMPLETED:
            raise TimeoutError(f"request {r.rid} still {r.status}")
        return r

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.request.rid}, "
                f"status={self.request.status!r})")


#: guards resident-thread creation (ServingBase is a mixin with no
#: __init__, so per-instance state starts as class-attribute defaults)
_SERVE_LOCK = ordered_lock("serving.serve")


class ServingBase:
    """Driver surface of the port's engines (the LM ``Engine`` so far).

    Subclasses build ``self.scheduler`` (a :class:`WaveScheduler` wired
    with their plan/dispatch/drain stages) in ``__init__`` and may
    override :meth:`_prepare` to classify a request before admission
    (e.g. the scene engine's capacity-bucket assignment; returning a
    string sheds the request with that reason)."""

    scheduler: WaveScheduler
    # resident-serving state (class-attr defaults: ServingBase is a mixin
    # without an __init__; instances shadow these once serve_forever runs)
    _serve_thread: threading.Thread | None = None
    _serve_stop: threading.Event | None = None
    _draining: bool = False

    # -- submission ----------------------------------------------------------

    def _prepare(self, req: ServeRequest) -> str | None:
        """Pre-admission hook; return a shed reason to reject ``req``."""
        return None

    def submit(self, reqs):
        """Submit one request (or a sequence) for serving; returns a
        :class:`RequestHandle` per request (a single handle for a single
        request). Requests the policy sheds at submit time (backpressure,
        no compatible bucket) come back with ``status="shed"``."""
        single = isinstance(reqs, ServeRequest)
        rlist = [reqs] if single else list(reqs)
        handles = []
        for r in rlist:
            shed = "shutdown" if self._draining else self._prepare(r)
            self.scheduler.enqueue(r, shed=shed)
            handles.append(RequestHandle(r, self.scheduler))
        return handles[0] if single else handles

    # -- driving -------------------------------------------------------------

    def serve(self, sync: bool | None = None,
              max_waves: int | None = None) -> None:
        """Pump the queue (to empty, or ``max_waves`` waves) on the
        calling thread; results land on the submitted requests/handles.
        ``sync=None`` keeps the constructor mode; a stage failure
        re-queues the affected waves and re-raises."""
        self.scheduler.run(sync=sync, max_waves=max_waves)

    def serve_forever(self, *, sync: bool | None = None,
                      poll_s: float = 0.02) -> threading.Thread:
        """Start (or return) the resident serving thread: a background
        daemon that pumps the queue whenever work arrives, so ``submit``
        alone is enough to get served. Idempotent — a second call while
        the thread is alive returns it unchanged. ``close()`` performs
        the graceful drain: in-queue requests are served (or, if the
        backlog cannot make progress, shed with
        ``shed_reason="shutdown"`` — explicitly, never silently) before
        the thread exits. Serving-loop exceptions are recorded on
        ``self.serve_errors`` and surfaced by :meth:`health`."""
        with _SERVE_LOCK:
            t = self._serve_thread
            if t is not None and t.is_alive():
                return t
            stop = threading.Event()
            self._serve_stop = stop
            if not hasattr(self, "serve_errors"):
                self.serve_errors: list = []
            sched = self.scheduler
            sched.resident = True

            def _loop():
                while True:
                    sched._work.clear()
                    if sched.queue:
                        try:
                            sched.run(sync=sync)
                        except (Exception, WorkerDeath) as e:
                            self.serve_errors.append(e)
                            del self.serve_errors[:-100]
                            if stop.is_set():
                                # drain cannot make progress (legacy
                                # max_retries=0 with a poisoned backlog):
                                # shed what's left, explicitly
                                while sched.queue:
                                    sched.shed_request(
                                        sched.queue.popleft(), "shutdown")
                                break
                            stop.wait(poll_s)
                    elif stop.is_set():
                        break
                    else:
                        sched._work.wait(poll_s)

            t = threading.Thread(target=_loop, daemon=True,
                                 name=f"{type(self).__name__}-serve")
            self._serve_thread = t
            t.start()
            return t

    def close(self) -> None:
        """Graceful shutdown: if a resident serving thread is running,
        reject new submits (``shed_reason="shutdown"``), drain the queue,
        and join the thread; then release the planner thread pool. The
        engine stays usable afterwards (a later ``serve``/
        ``serve_forever`` restarts cleanly). Idempotent."""
        t = self._serve_thread
        if t is not None:
            self._draining = True
            stop = self._serve_stop
            if stop is not None:
                stop.set()
            self.scheduler._work.set()  # wake an idle serving loop
            t.join()
            self._serve_thread = None
            self._serve_stop = None
            self.scheduler.resident = False
            self._draining = False
        self.scheduler.close()

    # -- introspection -------------------------------------------------------

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def shed(self) -> list:
        """Requests shed by admission/backpressure (surfaced, not
        dropped)."""
        return self.scheduler.shed

    @property
    def wave_stats(self) -> list[WaveStats]:
        return self.scheduler.stats

    @property
    def failed(self) -> list:
        """Requests that exhausted their retry budget (terminal
        ``status="failed"``)."""
        return self.scheduler.failed

    def timings(self) -> dict:
        return self.scheduler.timings()

    def slo_stats(self) -> dict:
        return self.scheduler.slo_stats()

    def health(self) -> dict:
        """Liveness/readiness snapshot for external monitors: resident
        thread state, queue depth, terminal-state counts, retry/error
        counters, and the age of the last completed wave. Engines add
        their own signals (e.g. circuit-breaker states) via
        :meth:`_health_extra`."""
        sched = self.scheduler
        t = self._serve_thread
        last = sched.last_wave_ts
        h = {
            "alive": bool(t is not None and t.is_alive()),
            "ready": not self._draining,
            "resident": sched.resident,
            "draining": self._draining,
            "queue_depth": len(sched.queue),
            "n_completed": len(sched.completed),
            "n_shed": len(sched.shed),
            "n_failed": len(sched.failed),
            "n_retries": sched.retries_charged,
            "wave_errors": sched.wave_errors,
            "serve_errors": len(getattr(self, "serve_errors", ())),
            "last_wave_age_s": (None if last is None
                                else time.monotonic() - last),
        }
        h.update(self._health_extra())
        return h

    def _health_extra(self) -> dict:
        """Engine-specific health signals merged into :meth:`health`."""
        return {}
