"""``repro_torch.analysis`` — static analysis over the port's own
invariants (port of ``repro.analysis``).

Four passes, one CLI (``python -m repro_torch.analysis``), all returning
:class:`~repro_torch.analysis.findings.Finding` lists:

* ``lint`` — repo-specific AST rules over the port (deprecated shims,
  host syncs in hot paths and timed closures, unnamed or non-daemon
  threads, contextvars on serving seams).
* ``concurrency`` — AST lock-graph extraction over ``src/repro_torch``
  checked against :data:`repro_torch.analysis.runtime.LOCK_ORDER`, plus
  blocking-call-under-lock detection; the runtime counterpart is
  ``REPRO_LOCK_CHECK=1``.
* ``plan_check`` — structural validation of the port's built
  ``ScenePlan``/``ShardedScenePlan``/``StreamPlanState`` objects and its
  ``PlanCache`` keys.
* ``hlo_gates`` — gates on the port's artifacts: forbidden ops in a
  dispatched-op or profiler trace, signature budgets, and the fused
  SSpNNA kernel's modeled shared memory.

Submodules are imported lazily: lock-owning modules import
``repro_torch.analysis.runtime`` at module load, and the passes import
those same modules.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding, render

_SUBMODULES = ("concurrency", "findings", "hlo_gates", "lint",
               "plan_check", "runtime")

__all__ = ["Finding", "render", *_SUBMODULES]


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
