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
``plan_cache`` (hooks wired in ``__post_init__``). ``mesh=`` names the
axis sharded scenes split over and its size: a ``torch.distributed``
``DeviceMesh`` with ``mesh_dim_names``, whose ``shard_axis`` group runs
one shard a process (``engine.shard``); ``mesh=None`` runs sharded plans
as a loop over the shards on ``device``.
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


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and
    its ``shape``); a mesh with unnamed dims raises."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"mesh {mesh!r} names no dims: build it with "
                         "mesh_dim_names=(..., 'shard', ...)")
    return dict(zip(names, (int(n) for n in mesh.shape)))


@dataclass
class ExecutionContext:
    """Device + backend registry + plan cache + scheduler defaults."""

    #: device mesh sharded scene plans execute on (one process a shard);
    #: None runs them as a loop over the shards on ``device``
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
            mesh_axes(self.mesh)  # a mesh without dim names raises here
        # plans cached under a measured decision or a breaker routing must
        # not outlive it: keys rotate (the table's and the board's
        # generations are repr'd into them) and the cache is dropped
        if self.autotune is not None:
            self.autotune.add_flip_hook(self.plan_cache.invalidate)
        self.registry.breakers.add_hook(self.plan_cache.invalidate)

    @property
    def n_shards(self) -> int:
        """Size of the shard axis (1 without a mesh or without the axis)."""
        if self.mesh is None:
            return 1
        return mesh_axes(self.mesh).get(self.shard_axis, 1)

    def topology_key(self) -> str:
        """The execution topology mixed into plan-cache keys, the JAX
        package's strings: ``"host"`` without a mesh, else
        ``"mesh(a=n,...)|shard_axis=..."``, so a plan built for one mesh
        or shard axis is never served to another."""
        if self.mesh is None:
            return "host"
        axes = ",".join(f"{a}={n}" for a, n in mesh_axes(self.mesh).items())
        return f"mesh({axes})|shard_axis={self.shard_axis}"

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
