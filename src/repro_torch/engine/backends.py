"""Backend registry (port of ``repro.engine.backends``, without breakers).

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
"""
from __future__ import annotations

from repro_torch.core.sparse_conv import SparseConvParams, reference_conv_cirf
from repro_torch.engine.plan import REFERENCE, SSPNNA, ConvPlan
from repro_torch.kernels.sspnna.ops import run_sspnna_conv
from repro_torch.serving import faults

AUTO = "auto"


class Backend:
    """One execution path for plan-driven sparse convolution.

    Subclasses set ``name`` (the key ``Dispatch.backend`` refers to),
    optionally ``plan_requirements`` (plan attributes that must be non-None
    for ``run`` to serve the plan) and ``fallback`` (the name resolution
    degrades to when ``supports`` says no).
    """

    name: str = ""
    plan_requirements: tuple[str, ...] = ()
    fallback: str | None = None

    def supports(self, plan: ConvPlan) -> bool:
        return all(getattr(plan, req, None) is not None
                   for req in self.plan_requirements)

    def run(self, x, params: SparseConvParams, plan: ConvPlan, *,
            use_kernel: bool = True):
        raise NotImplementedError(f"backend {self.name!r} has no run()")

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class BackendRegistry:
    """Name -> Backend mapping with fallback resolution."""

    def __init__(self):
        self._impls: dict[str, Backend] = {}

    def register(self, name: str, impl: Backend) -> Backend:
        if not name or name == AUTO:
            raise ValueError(f"invalid backend name {name!r}")
        if name in self._impls:
            raise ValueError(f"backend {name!r} already registered")
        if not callable(getattr(impl, "run", None)):
            raise TypeError(f"backend impl {impl!r} has no run() hook")
        self._impls[name] = impl
        return impl

    def get(self, name: str) -> Backend:
        impl = self._impls.get(name)
        if impl is None:
            raise ValueError(
                f"backend {name!r} not one of {(AUTO,) + self.names()}")
        return impl

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._impls))

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


def make_registry() -> BackendRegistry:
    """A registry holding the built-in ``reference`` and ``sspnna``."""
    reg = BackendRegistry()
    reg.register(REFERENCE, ReferenceBackend())
    reg.register(SSPNNA, SSpNNABackend())
    return reg


DEFAULT_REGISTRY = make_registry()
