"""Deterministic, seeded fault injection for the serving runtime (port of
the injector half of ``repro.serving.faults``; the circuit breakers come
with a later slice).

The serving stack (scheduler waves, plan builds, backend dispatch,
stream frames) has a handful of *seams* where production failures show
up: a plan build raises, a device kernel errors, a wave stalls, a LiDAR
frame arrives corrupted, a worker thread dies. ``FaultPlan`` describes
*what* to inject (per-seam rates, optional backend/rid targeting) and
``FaultInjector`` decides *when* — with hash-based rolls keyed on
``(seed, spec, seam, key, attempt)`` so outcomes are reproducible and
independent of thread interleaving: the Nth attempt at a given key
always rolls the same number, no matter which worker gets there first.
The rolls are the JAX package's (the same sha256 of the same repr), so a
plan fires on the same keys in both packages.

Usage::

    plan = FaultPlan(seed=7, specs=(FaultSpec("dispatch", rate=0.05),))
    inj = FaultInjector(plan)
    eng = SceneEngine(cfg, model, 2, faults=inj)   # explicit wiring, or:
    with inject_faults(inj):                       # ambient (reaches plan.py)
        ...

The ambient injector is a plain module global (NOT a contextvar): plan
builds run on scheduler worker threads, and contextvars don't cross
thread boundaries.

Everything here is a no-op at zero cost when no injector is installed —
the hardened runtime paths check ``faults is None`` / ``active() is
None`` first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

import numpy as np

from repro_torch.analysis.runtime import ordered_lock

#: Named injection points. Handlers exist for each: scheduler retry
#: budget, PlanCache error propagation, watchdogs, stream gap recovery
#: (the JAX package also routes ``dispatch`` faults to circuit breakers).
SEAMS = (
    "plan",             # scheduler plan stage (worker thread)
    "plan_build",       # PlanCache.get_or_build builder call
    "dispatch",         # scheduler dispatch stage / device error
    "backend_resolve",  # BackendRegistry.resolve
    "slow_wave",        # dispatch stall (delay_ms), exercises watchdogs
    "corrupt_frame",    # stream frame coords garbage
    "worker_death",     # BaseException from the plan stage
)


class FaultError(RuntimeError):
    """Base class for injected faults (carries seam + optional rid)."""

    def __init__(self, msg, *, seam=None, rid=None):
        super().__init__(msg)
        self.seam = seam
        self.rid = rid


class PlanFaultError(FaultError):
    """Injected plan-build failure."""


class DeviceFaultError(FaultError):
    """Injected dispatch/device failure; ``backend`` names the culprit."""

    def __init__(self, msg, *, seam=None, rid=None, backend=None):
        super().__init__(msg, seam=seam, rid=rid)
        self.backend = backend


class WorkerDeath(BaseException):
    """Simulates a worker thread dying: deliberately NOT an Exception,
    so naive ``except Exception`` handlers don't contain it — only the
    scheduler's explicit containment path does."""

    def __init__(self, msg, *, seam=None, rid=None):
        super().__init__(msg)
        self.seam = seam
        self.rid = rid


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault source: a seam, a probability, and optional targeting.

    ``rate`` is the per-opportunity probability in [0, 1]. ``backend``
    attributes dispatch faults to a named backend (for breaker tests).
    ``delay_ms`` is the stall for ``slow_wave`` specs. ``max_fires``
    bounds total injections from this spec; ``after`` skips the first N
    opportunities; ``rids`` restricts to specific request ids.
    """

    seam: str
    rate: float = 0.0
    backend: str | None = None
    delay_ms: float = 0.0
    max_fires: int | None = None
    after: int = 0
    rids: tuple | None = None

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; known: {SEAMS}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus a tuple of :class:`FaultSpec`. Hashable, printable,
    and fully determines injector behaviour (given the same sequence of
    opportunities per key)."""

    seed: int = 0
    specs: tuple = ()

    @staticmethod
    def random(seed: int, *, max_specs: int = 3, max_rate: float = 0.3):
        """A small random plan for chaos/property tests: ``seed`` picks
        1..max_specs specs over the error-injecting seams with rates in
        (0, max_rate]."""
        rng = np.random.default_rng(seed)
        pool = ["plan", "plan_build", "dispatch", "slow_wave",
                "worker_death"]
        n = int(rng.integers(1, max_specs + 1))
        specs = []
        for _ in range(n):
            seam = pool[int(rng.integers(0, len(pool)))]
            rate = float(rng.uniform(0.02, max_rate))
            delay = float(rng.uniform(1.0, 5.0)) if seam == "slow_wave" else 0.0
            specs.append(FaultSpec(seam, rate=rate, delay_ms=delay))
        return FaultPlan(seed=seed, specs=tuple(specs))


class FaultInjector:
    """Deterministic executor for a :class:`FaultPlan`.

    Thread-safe. Tracks per-seam opportunity and fire counts in
    ``self.fires`` / ``self.opportunities`` so tests can assert that a
    seam was actually exercised.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = ordered_lock("faults.injector")
        # per-spec-index counters
        self._opps = [0] * len(plan.specs)
        self._fired = [0] * len(plan.specs)
        # per (spec_idx, key) attempt counters: the Nth attempt at a key
        # rolls deterministically regardless of global ordering.
        self._attempts: dict = {}
        self.fires: dict[str, int] = {}
        self.opportunities: dict[str, int] = {}

    # -- deterministic rolls -------------------------------------------------

    def _roll(self, spec_idx: int, seam: str, key, attempt: int) -> float:
        h = hashlib.sha256(
            repr((self.plan.seed, spec_idx, seam, key, attempt)).encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / float(2 ** 64)

    def _should_fire(self, spec_idx: int, spec: FaultSpec, key, rid) -> bool:
        with self._lock:
            self._opps[spec_idx] += 1
            self.opportunities[spec.seam] = (
                self.opportunities.get(spec.seam, 0) + 1)
            if spec.rids is not None and rid not in spec.rids:
                return False
            if self._opps[spec_idx] <= spec.after:
                return False
            if (spec.max_fires is not None
                    and self._fired[spec_idx] >= spec.max_fires):
                return False
            akey = (spec_idx, key)
            attempt = self._attempts.get(akey, 0)
            self._attempts[akey] = attempt + 1
            if self._roll(spec_idx, spec.seam, key, attempt) >= spec.rate:
                return False
            self._fired[spec_idx] += 1
            self.fires[spec.seam] = self.fires.get(spec.seam, 0) + 1
            return True

    # -- seam entry points ---------------------------------------------------

    def maybe_fail(self, seam: str, *, rid=None, key=None):
        """Raise an injected error at ``seam`` if a spec fires.

        ``key`` scopes the deterministic roll (e.g. ``("wave", n)`` or a
        plan-cache key); defaults to ``rid``.
        """
        if key is None:
            key = rid
        for i, spec in enumerate(self.plan.specs):
            if spec.seam != seam:
                continue
            if not self._should_fire(i, spec, key, rid):
                continue
            if seam == "worker_death":
                raise WorkerDeath(
                    f"injected worker death (rid={rid})", seam=seam, rid=rid)
            if seam in ("dispatch", "backend_resolve"):
                raise DeviceFaultError(
                    f"injected device fault (rid={rid}, "
                    f"backend={spec.backend})",
                    seam=seam, rid=rid, backend=spec.backend)
            raise PlanFaultError(
                f"injected {seam} fault (rid={rid})", seam=seam, rid=rid)

    def stall_ms(self, *, key=None) -> float:
        """Total injected stall (ms) for ``slow_wave`` specs at this
        opportunity; the caller sleeps."""
        total = 0.0
        for i, spec in enumerate(self.plan.specs):
            if spec.seam != "slow_wave":
                continue
            if self._should_fire(i, spec, key, None):
                total += spec.delay_ms
        return total

    def corrupt_coords(self, coords, *, rid=None):
        """Return a corrupted copy of ``coords`` if a ``corrupt_frame``
        spec fires, else ``coords`` unchanged. Corruption scribbles
        seeded garbage (including negatives) over ~1/8 of the rows."""
        for i, spec in enumerate(self.plan.specs):
            if spec.seam != "corrupt_frame":
                continue
            if not self._should_fire(i, spec, rid, rid):
                continue
            c = np.array(coords, copy=True)
            if c.shape[0] == 0:
                return c
            rng = np.random.default_rng(
                (self.plan.seed * 1000003 + i) & 0xFFFFFFFF)
            n = max(1, c.shape[0] // 8)
            rows = rng.choice(c.shape[0], size=n, replace=False)
            garbage = rng.integers(-64, 4096, size=(n,) + c.shape[1:])
            c[rows] = garbage.astype(c.dtype)
            return c
        return coords

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.plan.seed,
                "fires": dict(self.fires),
                "opportunities": dict(self.opportunities),
            }


# -- ambient injector --------------------------------------------------------
#
# A module global, not a contextvar: plan builds run on scheduler worker
# threads and must see the injector installed by the test's main thread.

_ACTIVE: FaultInjector | None = None
_ACTIVE_LOCK = ordered_lock("faults.install")


def active() -> FaultInjector | None:
    """The ambient injector, or None (the common, zero-cost case)."""
    return _ACTIVE


def install(inj: FaultInjector | None) -> FaultInjector | None:
    """Set the ambient injector; returns the previous one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev = _ACTIVE
        _ACTIVE = inj
        return prev


@contextlib.contextmanager
def inject_faults(inj: FaultInjector):
    """Install ``inj`` as the ambient injector for the block."""
    prev = install(inj)
    try:
        yield inj
    finally:
        install(prev)
