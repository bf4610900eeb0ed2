"""Backend registry and circuit breakers (port of ``repro.engine.backends``).

SPADE records a backend *name* in each conv's ``Dispatch``; a
``BackendRegistry`` resolves the name to an implementation, following the
backend's declared ``fallback`` when a plan lacks what it needs. The one
fallback on the main path is the JAX planner's own: an ``sspnna`` decision
whose plan carries no tile tables (the down and up convs, plane-split
plans) runs on ``reference``. ``run`` takes the JAX package's
``use_kernel`` keyword: ``sspnna`` with ``use_kernel=False`` runs the
pre-gathered oracle branch of ``run_sspnna_conv`` (the caller's explicit
choice, never a fallback); ``reference`` ignores it. ``resolve`` carries
the ``backend_resolve`` seam of the ambient fault injector
(``serving.faults``).

Registries chain: ``registry.view()`` makes a scoped child whose reads go
through to the parent and whose writes stay local, so an
``ExecutionContext`` can overlay backends without touching the process
default (``default_registry()``; ``register_backend`` writes there).

**Circuit breakers.** Every registry carries a :class:`BreakerBoard`
(``registry.breakers``): per-backend :class:`CircuitBreaker` state
machines fed by the serving layer (``N`` consecutive dispatch failures
attributed to a backend trip it OPEN). A tripped breaker makes the
*planner* reroute new plans along the backend's ``fallback`` chain
(``BreakerBoard.route``): the reroute lands in the plan's dispatch, and so
in its signature, which keys the serving engine's CUDA graphs. Each state
change bumps the board's ``generation``, which plan-cache keys mix in
(through the board's ``repr``), and fires hooks (``ExecutionContext``
wires ``plan_cache.invalidate``). After ``cooldown_s`` the breaker goes
HALF_OPEN and lets one probe plan through; a success closes it, a
failure re-opens it.
"""
from __future__ import annotations

import time

from repro_torch.analysis.runtime import ordered_rlock
from repro_torch.core.sparse_conv import SparseConvParams, reference_conv_cirf
from repro_torch.engine.plan import REFERENCE, SSPNNA, ConvPlan
from repro_torch.kernels.sspnna.ops import run_sspnna_conv
from repro_torch.serving import faults

AUTO = "auto"

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-backend consecutive-failure circuit breaker.

    CLOSED counts consecutive failures; at ``failure_threshold`` it trips
    OPEN (the board stops routing plans to the backend). After
    ``cooldown_s`` the next ``allow()`` moves it HALF_OPEN, admitting one
    probe: ``record_success`` closes it again, ``record_failure``
    re-opens it (and restarts the cooldown). ``clock`` is injectable for
    tests. Not thread-safe on its own — :class:`BreakerBoard` serializes
    access.
    """

    def __init__(self, name: str, *, failure_threshold: int = 5,
                 cooldown_s: float = 1.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0           # total CLOSED/HALF_OPEN -> OPEN transitions
        self._opened_at: float | None = None

    def allow(self) -> bool:
        """May a *new plan* route to this backend right now? OPEN flips
        to HALF_OPEN (one probe allowed) once the cooldown has passed."""
        if self.state == OPEN:
            if (self._opened_at is not None
                    and self._clock() - self._opened_at >= self.cooldown_s):
                self.state = HALF_OPEN
                return True
            return False
        return True

    def record_failure(self) -> bool:
        """Count one attributed failure; returns True when the breaker
        state changed (tripped or re-opened)."""
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self.state = OPEN
            self.trips += 1
            self._opened_at = self._clock()
            return True
        return False

    def record_success(self) -> bool:
        """Count one success; returns True when the state changed (a
        HALF_OPEN probe succeeded and the breaker closed)."""
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self._opened_at = None
            return True
        return False

    def snapshot(self) -> dict:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips}

    def __repr__(self):
        return (f"<CircuitBreaker {self.name!r} {self.state} "
                f"fails={self.consecutive_failures}>")


class BreakerBoard:
    """All circuit breakers of one registry, plus the routing logic.

    ``record_failure``/``record_success`` are fed by the serving layer
    with backend *names* (lazily creating breakers on first failure).
    ``route(name)`` is consulted by the planner: it follows the
    registry's fallback chain past backends whose breaker is not
    ``allow()``-ing traffic. Every state change bumps ``generation`` —
    mixed into plan-cache keys through ``repr(board)`` — and fires the
    registered hooks (``ExecutionContext`` wires
    ``plan_cache.invalidate`` here).
    """

    def __init__(self, registry: "BackendRegistry", *,
                 failure_threshold: int = 5, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        self._registry = registry
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.generation = 0
        self._breakers: dict[str, CircuitBreaker] = {}
        self._hooks: list = []
        self._lock = ordered_rlock("breakers")

    def configure(self, *, failure_threshold: int | None = None,
                  cooldown_s: float | None = None) -> "BreakerBoard":
        """Adjust defaults for breakers created after this call."""
        with self._lock:
            if failure_threshold is not None:
                self.failure_threshold = failure_threshold
            if cooldown_s is not None:
                self.cooldown_s = cooldown_s
        return self

    def add_hook(self, hook) -> None:
        """``hook()`` fires (outside the lock) on every generation bump."""
        self._hooks.append(hook)

    def breaker(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(
                    name, failure_threshold=self.failure_threshold,
                    cooldown_s=self.cooldown_s, clock=self._clock)
                self._breakers[name] = br
            return br

    def _bump(self) -> None:
        for hook in list(self._hooks):
            try:
                hook()
            except Exception:
                pass  # observers must not take down serving

    def record_failure(self, name: str) -> bool:
        """Attribute one failure to ``name``; True if its breaker state
        changed (hooks fire and the generation bumps)."""
        with self._lock:
            changed = self.breaker(name).record_failure()
            if changed:
                self.generation += 1
        if changed:
            self._bump()
        return changed

    def record_success(self, name: str) -> bool:
        with self._lock:
            br = self._breakers.get(name)
            changed = br.record_success() if br is not None else False
            if changed:
                self.generation += 1
        if changed:
            self._bump()
        return changed

    def allow(self, name: str) -> bool:
        """True unless ``name`` has a tripped (still-cooling) breaker.
        Doesn't create breakers: unknown names are allowed."""
        with self._lock:
            br = self._breakers.get(name)
            return True if br is None else br.allow()

    def route(self, name: str) -> str:
        """The backend new plans should target: ``name`` itself when its
        breaker admits traffic, else the first allowed backend along the
        registry's fallback chain (cycle-safe; the chain's last resort is
        returned even when itself blocked — something must serve)."""
        with self._lock:
            seen = set()
            current = name
            while current not in seen:
                seen.add(current)
                br = self._breakers.get(current)
                if br is None or br.allow():
                    return current
                try:
                    impl = self._registry.get(current)
                except ValueError:
                    return current
                if impl.fallback is None:
                    return current
                current = impl.fallback
            return current

    def states(self) -> dict:
        """Snapshot for ``health()``: name -> breaker state dict."""
        with self._lock:
            return {n: b.snapshot() for n, b in self._breakers.items()}

    def __repr__(self):
        # repr participates in plan-cache keys: the generation is the
        # only state that must rotate them
        return f"<BreakerBoard gen={self.generation}>"


class Backend:
    """One execution path for plan-driven sparse convolution.

    Subclasses set ``name`` (the key ``Dispatch.backend`` refers to),
    optionally ``plan_requirements`` (plan attributes that must be non-None
    for ``run`` to serve the plan) and ``fallback`` (the name resolution
    degrades to when ``supports`` says no). ``scene_level`` marks backends
    that run whole scenes through ``run_unet`` (``engine.shard``'s); the
    profiler skips them.
    """

    name: str = ""
    plan_requirements: tuple[str, ...] = ()
    fallback: str | None = None
    scene_level: bool = False

    def supports(self, plan: ConvPlan) -> bool:
        return all(getattr(plan, req, None) is not None
                   for req in self.plan_requirements)

    def run(self, x, params: SparseConvParams, plan: ConvPlan, *,
            use_kernel: bool = True):
        raise NotImplementedError(f"backend {self.name!r} has no run()")

    def run_unet(self, model, feats, plan, *, ctx, **kw):
        raise NotImplementedError(
            f"backend {self.name!r} does not implement scene-level "
            "run_unet()")

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class BackendRegistry:
    """Name -> Backend mapping with parent chaining and fallback resolution.

    Lookup walks ``self`` then ``parent``; registration always writes to
    ``self``, so a ``view()`` child can shadow or extend the process
    default without mutating it (an ``ExecutionContext`` holds such a
    view).
    """

    def __init__(self, parent: "BackendRegistry | None" = None):
        self._impls: dict[str, Backend] = {}
        self._parent = parent
        #: per-registry circuit breakers (views get their own board, so
        #: a context's breaker trips stay scoped to that context)
        self.breakers = BreakerBoard(self)

    def register(self, name: str, impl: Backend, *,
                 overwrite: bool = False) -> Backend:
        if not name or name == AUTO:
            raise ValueError(f"invalid backend name {name!r}")
        if not overwrite and name in self:
            raise ValueError(
                f"backend {name!r} already registered; pass overwrite=True "
                "to replace it")
        if not callable(getattr(impl, "run", None)):
            raise TypeError(f"backend impl {impl!r} has no run() hook")
        self._impls[name] = impl
        return impl

    def unregister(self, name: str) -> None:
        """Remove a registration made on *this* registry (not the parent)."""
        self._impls.pop(name, None)

    def get(self, name: str) -> Backend:
        reg: BackendRegistry | None = self
        while reg is not None:
            impl = reg._impls.get(name)
            if impl is not None:
                return impl
            reg = reg._parent
        raise ValueError(
            f"backend {name!r} not one of {(AUTO,) + self.names()}")

    def names(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        reg: BackendRegistry | None = self
        while reg is not None:
            for n in reg._impls:
                seen.setdefault(n)
            reg = reg._parent
        return tuple(sorted(seen))

    def __contains__(self, name: str) -> bool:
        reg: BackendRegistry | None = self
        while reg is not None:
            if name in reg._impls:
                return True
            reg = reg._parent
        return False

    def view(self) -> "BackendRegistry":
        """A scoped child registry: reads chain to this one, writes stay
        local. This is what a fresh ``ExecutionContext`` holds."""
        return BackendRegistry(parent=self)

    def resolve(self, plan: ConvPlan, backend: str = AUTO) -> str:
        """The backend name a call will actually run: ``"auto"`` reads the
        planner's decision in ``plan.dispatch``; a backend that cannot serve
        the plan degrades along its declared ``fallback`` chain."""
        if backend == AUTO:
            backend = plan.dispatch.backend
        inj = faults.active()
        if inj is not None:
            inj.maybe_fail("backend_resolve", key=backend)
        impl = self.get(backend)
        seen = {backend}
        while not impl.supports(plan):
            if impl.fallback is None or impl.fallback in seen:
                raise ValueError(
                    f"backend {backend!r} cannot serve this plan and "
                    "declares no (acyclic) fallback")
            backend = impl.fallback
            seen.add(backend)
            impl = self.get(backend)
        return backend


class ReferenceBackend(Backend):
    """Gather + one product over all weight planes: the coarse single
    dispatch and the numerical oracle (``core.sparse_conv``)."""

    name = REFERENCE

    def run(self, x, params, plan, *, use_kernel: bool = True):
        del use_kernel  # no kernel on the gather + product path
        return reference_conv_cirf(x, plan.coir, params)


class SSpNNABackend(Backend):
    """The fused gather-GEMM-scatter CUDA kernel driven by the plan's
    ``TileArrays`` (``use_kernel=False``: the pre-gathered plain branch);
    plans without tile tables fall back to reference."""

    name = SSPNNA
    plan_requirements = ("tiles",)
    fallback = REFERENCE

    def run(self, x, params, plan, *, use_kernel: bool = True):
        raw = run_sspnna_conv(
            x, params.weight, plan.tiles.out_rows, plan.tiles.in_rows,
            plan.tiles.local_idx, n_out=plan.coir.mask.shape[0],
            pair_counts=plan.tiles.pair_counts, use_kernel=use_kernel)
        out = raw.to(x.dtype) + params.bias.to(x.dtype)
        return out * plan.coir.mask.unsqueeze(-1).to(out.dtype)


#: the process-wide registry ``reference`` and ``sspnna`` live on
DEFAULT_REGISTRY = BackendRegistry()
DEFAULT_REGISTRY.register(REFERENCE, ReferenceBackend())
DEFAULT_REGISTRY.register(SSPNNA, SSpNNABackend())


def default_registry() -> BackendRegistry:
    """The process-wide registry (``DEFAULT_REGISTRY``) every context's
    registry is a view of."""
    return DEFAULT_REGISTRY


def register_backend(name: str, impl: Backend, *,
                     overwrite: bool = False) -> Backend:
    """Register an execution backend process-wide.

    After this, any plan whose ``Dispatch.backend`` names ``name`` (or any
    explicit ``backend=name`` call) routes to ``impl``. Scoped alternative:
    register on ``ExecutionContext.registry`` to confine the backend to one
    context.
    """
    return default_registry().register(name, impl, overwrite=overwrite)
