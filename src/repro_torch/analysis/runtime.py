"""Runtime lock-order assertions (opt-in via ``REPRO_LOCK_CHECK=1``); the
port's own copy of ``repro.analysis.runtime``, with the same lock names.

Every lock in the serving/engine stack is created through
``ordered_lock``/``ordered_rlock``/``ordered_condition`` with a canonical
name from :data:`LOCK_ORDER` — the repo's single documented global lock
order (enforced statically for the JAX package by
``repro.analysis.concurrency``). With
``REPRO_LOCK_CHECK`` unset the factories return plain ``threading``
primitives: zero overhead, identical semantics. With ``REPRO_LOCK_CHECK=1``
they return checked wrappers that raise :class:`LockOrderViolation` the
moment any thread acquires a lock while holding one that ranks *after* it
— turning a would-be deadlock into a deterministic, attributable failure
at the acquisition site.

The environment variable is read at lock-creation time, so module-level
locks (``serving.api._SERVE_LOCK``) are only checked when the variable is
set before the first ``repro_torch.serving`` import; per-instance locks
(the scheduler's pool) are checked for any object created while it is
set. The order keeps the names of locks the port does not have yet (plan
cache, streams, breakers, autotune, faults), so ported modules take their
ranks unchanged. This module must stay dependency-free
(``os``/``threading`` only).
"""
from __future__ import annotations

import os
import threading

#: The documented global lock order. A thread holding lock at rank *i* may
#: only acquire locks at rank > *i*. Outer (coarse, long-lived scopes)
#: first, inner (leaf, short critical sections) last.
LOCK_ORDER = (
    "serving.serve",     # serving.api._SERVE_LOCK (one resident loop/proc)
    "scheduler.pool",    # WaveScheduler._pool_lock (planner pool lifecycle)
    "stream.handle",     # StreamHandle._lock (per-stream frame numbering)
    "stream.plan",       # StreamPlanState._cond (per-stream frame gating)
    "plan_cache",        # PlanCache._lock (entry map + coalescing table)
    "plan_cache.dev",    # per-entry device-upload memo lock
    "breakers",          # BreakerBoard._lock (per-backend breaker state)
    "autotune",          # CostTable._lock (measured-cost table)
    "faults.injector",   # FaultInjector._lock (seeded trial counters)
    "faults.install",    # serving.faults._ACTIVE_LOCK (ambient injector)
)

_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}


class LockOrderViolation(RuntimeError):
    """A thread acquired locks against :data:`LOCK_ORDER`."""


def enabled() -> bool:
    return os.environ.get("REPRO_LOCK_CHECK", "") == "1"


def lock_rank(name: str) -> int:
    try:
        return _RANK[name]
    except KeyError:
        raise ValueError(
            f"unknown lock name {name!r}; register it in "
            f"repro_torch.analysis.runtime.LOCK_ORDER") from None


_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


class _CheckedLock:
    """Lock/RLock wrapper asserting :data:`LOCK_ORDER` on every acquire.

    Implements ``_is_owned`` so ``threading.Condition`` can wrap it (the
    condition's ``wait`` releases and re-acquires through the wrapper, so
    held-lock bookkeeping stays correct across waits).
    """

    def __init__(self, name: str, *, reentrant: bool = False):
        self.name = name
        self.rank = lock_rank(name)
        self._reentrant = reentrant
        self._lk = threading.RLock() if reentrant else threading.Lock()
        self._owner: int | None = None
        self._count = 0

    def _check(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            if not self._reentrant:
                raise LockOrderViolation(
                    f"non-reentrant lock {self.name!r} re-acquired by the "
                    f"holding thread (self-deadlock)")
            return
        for other in _held():
            if other.rank > self.rank or (
                    other.rank == self.rank and other is not self):
                raise LockOrderViolation(
                    f"acquired {self.name!r} (rank {self.rank}) while "
                    f"holding {other.name!r} (rank {other.rank}); "
                    f"documented order: {' < '.join(LOCK_ORDER)}")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check()
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self._count += 1
            _held().append(self)
        return ok

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        h = _held()
        for i in range(len(h) - 1, -1, -1):
            if h[i] is self:
                del h[i]
                break
        self._lk.release()

    # threading.Condition picks this up, avoiding its try-acquire probe
    # (which would trip the re-acquire check on a non-reentrant lock)
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._count > 0

    def __enter__(self) -> "_CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<ordered {self.name!r} rank={self.rank}>"


def ordered_lock(name: str):
    """A ``threading.Lock`` registered at ``name``'s rank in the global
    order (checked wrapper when ``REPRO_LOCK_CHECK=1``)."""
    lock_rank(name)  # unknown names fail fast even when disabled
    if enabled():
        return _CheckedLock(name)
    return threading.Lock()


def ordered_rlock(name: str):
    """Reentrant variant of :func:`ordered_lock`."""
    lock_rank(name)
    if enabled():
        return _CheckedLock(name, reentrant=True)
    return threading.RLock()


def ordered_condition(name: str):
    """A ``threading.Condition`` whose underlying lock participates in the
    global order. ``wait()`` releases the lock, so waiting never holds a
    rank (matching the static checker's condvar-wait exemption)."""
    lock_rank(name)
    if enabled():
        return threading.Condition(_CheckedLock(name))
    return threading.Condition()
