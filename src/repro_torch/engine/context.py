"""ExecutionContext: the object that owns the device, the backends and the
plan cache (port of ``repro.engine.context``).

``ExecutionContext`` bundles what the serving engines share:

* ``device`` — where plans are uploaded and forwards run: the card unless
  the caller asks for the CPU;
* ``registry`` — the :class:`~repro_torch.engine.backends.BackendRegistry`
  a forward dispatches through (a fresh ``make_registry()`` by default);
* ``plan_cache`` — the content-keyed :class:`~repro_torch.engine.plan.
  PlanCache`; keys mix in :meth:`topology_key`;
* scheduler defaults (``sync`` / ``depth`` / ``planner_threads`` /
  ``admission``) that ``serving.scene_engine.SceneEngine`` picks up.

A device mesh (``mesh=``) comes with the sharded-scene slice and measured
dispatch (``autotune=``) with the self-tuning slice; both raise until then.
``current_context()`` resolves the innermost ``use_context(...)`` block,
else the module default.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch

from repro_torch.engine.backends import BackendRegistry, make_registry
from repro_torch.engine.plan import PlanCache


@dataclass
class ExecutionContext:
    """Device + backend registry + plan cache + scheduler defaults."""

    #: device mesh sharded scene plans execute on: slice 9 brings it
    mesh: object | None = None
    #: mesh axis the scene capacity axis is sharded over
    shard_axis: str = "shard"
    #: backend registry forwards under this context dispatch through
    registry: BackendRegistry = field(default_factory=make_registry)
    #: content-keyed scene-plan cache (topology mixed into every key)
    plan_cache: PlanCache = field(default_factory=PlanCache)
    #: serving defaults picked up by engines built from this context
    sync: bool = True
    depth: int = 2
    planner_threads: int = 2
    #: default ``serving.AdmissionPolicy`` of engines built from this
    #: context; None = FIFO admission
    admission: object | None = None
    #: measured-dispatch cost table: slice 7 brings it
    autotune: object | None = None
    #: where plans are uploaded and forwards run
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh= comes with ROADMAP.md, queue 1, slice 9 (sharded "
                "scenes)")
        if self.autotune is not None:
            raise NotImplementedError(
                "autotune= comes with ROADMAP.md, queue 1, slice 7 "
                "(self-tuning and hardening)")

    def topology_key(self) -> str:
        """The execution topology mixed into plan-cache keys: ``"host"``
        (one device, no mesh)."""
        return "host"


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
