"""Fault types the serving runtime catches (the exception classes of
``repro.serving.faults``).

The scheduler contains stage failures, including the injected
``WorkerDeath`` (a ``BaseException``), and the API surfaces them on the
requests. The seeded ``FaultInjector`` that raises these at named seams
comes with the hardening slice (``ROADMAP.md``); the engines' ``faults``
argument defaults to None.
"""
from __future__ import annotations


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
