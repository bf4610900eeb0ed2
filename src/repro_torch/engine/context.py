"""ExecutionContext: the object that owns the device, the backends, the
plan cache and the measured-dispatch table (port of
``repro.engine.context``).

``ExecutionContext`` bundles what the serving engines share:

* ``device`` — where plans are uploaded and forwards run: the card unless
  the caller asks for the CPU;
* ``registry`` — a scoped :class:`~repro_torch.engine.backends.
  BackendRegistry` view chained to the process default
  (``default_registry().view()``), so ``register_backend`` reaches every
  context while a context's overlays and circuit-breaker trips stay its
  own;
* ``plan_cache`` — the content-keyed :class:`~repro_torch.engine.plan.
  PlanCache`; keys mix in :meth:`topology_key`;
* ``autotune`` / ``autotune_reprofile_ms`` — an optional measured cost
  table (``engine.autotune.CostTable``) that plan builds consult, and the
  idle-gap re-profiling budget serving engines give it;
* scheduler defaults (``sync`` / ``depth`` / ``planner_threads`` /
  ``admission``) that ``serving.scene_engine.SceneEngine`` picks up.

A measured-winner flip or a breaker state change invalidates
``plan_cache`` (hooks wired in ``__post_init__``). A device mesh
(``mesh=``) comes with the sharded-scene slice and raises until then.
``current_context()`` resolves the innermost ``use_context(...)`` block,
else the module default.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch

from repro_torch.engine.backends import (
    AUTO,
    Backend,
    BackendRegistry,
    default_registry,
)
from repro_torch.engine.plan import PlanCache


@dataclass
class ExecutionContext:
    """Device + backend registry + plan cache + scheduler defaults."""

    #: device mesh sharded scene plans execute on: slice 9 brings it
    mesh: object | None = None
    #: mesh axis the scene capacity axis is sharded over
    shard_axis: str = "shard"
    #: scoped backend registry (chains to the process default)
    registry: BackendRegistry = field(
        default_factory=lambda: default_registry().view())
    #: content-keyed scene-plan cache (topology mixed into every key)
    plan_cache: PlanCache = field(default_factory=PlanCache)
    #: serving defaults picked up by engines built from this context
    sync: bool = True
    depth: int = 2
    planner_threads: int = 2
    #: default ``serving.AdmissionPolicy`` of engines built from this
    #: context; None = FIFO admission
    admission: object | None = None
    #: measured-dispatch cost table (``engine.autotune.CostTable``). When
    #: set, plan builds under this context consult measured winners before
    #: the analytical model, and a winner flip invalidates ``plan_cache``
    autotune: object | None = None
    #: idle-gap re-profiling budget per scheduler tick, in ms; 0 (the
    #: default) installs no idle hook
    autotune_reprofile_ms: float = 0.0
    #: where plans are uploaded and forwards run
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh= comes with ROADMAP.md, queue 1, slice 9 (sharded "
                "scenes)")
        # plans cached under a measured decision or a breaker routing must
        # not outlive it: keys rotate (the table's and the board's
        # generations are repr'd into them) and the cache is dropped
        if self.autotune is not None:
            self.autotune.add_flip_hook(self.plan_cache.invalidate)
        self.registry.breakers.add_hook(self.plan_cache.invalidate)

    def topology_key(self) -> str:
        """The execution topology mixed into plan-cache keys: ``"host"``
        (one device, no mesh)."""
        return "host"

    def resolve_backend(self, plan, backend: str = AUTO) -> str:
        """The backend name a call under this context will actually run."""
        return self.registry.resolve(plan, backend)

    def backend(self, name: str) -> Backend:
        return self.registry.get(name)


_DEFAULT: ExecutionContext | None = None
#: innermost use_context() override, if any
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_engine_active_ctx", default=None)


def default_context() -> ExecutionContext:
    """The module-level default context."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ExecutionContext()
    return _DEFAULT


def set_default_context(ctx: ExecutionContext) -> ExecutionContext | None:
    """Replace the module-level default; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, ctx
    return prev


def current_context() -> ExecutionContext:
    """The ambient context: innermost ``use_context`` block, else the
    module default."""
    active = _ACTIVE.get()
    return active if active is not None else default_context()


@contextlib.contextmanager
def use_context(ctx: ExecutionContext):
    """Make ``ctx`` the ambient context for the dynamic extent of the block
    (thread- and task-local)."""
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)
