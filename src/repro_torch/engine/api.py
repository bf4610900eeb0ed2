"""Plan-driven sparse convolution and the U-Net forward (port of
``repro.engine.api``).

``sparse_conv(x, params, plan)`` runs one conv as its ``ConvPlan`` says:
the registry resolves the plan's backend name (``"auto"`` follows the
planner's decision) to ``reference`` (gather + one product) or ``sspnna``
(the fused CUDA kernel). ``apply_unet`` walks the SCN U-Net's levels off a
``ScenePlan``, exactly as the JAX package does. ``use_kernel=False``
(the JAX package's option) runs tiled convs through the pre-gathered plain
branch instead of the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.coir import COIR
from repro_torch.core.sparse_conv import SparseConvParams, masked_batchnorm_relu
from repro_torch.device import require_device
from repro_torch.engine.backends import AUTO, DEFAULT_REGISTRY, BackendRegistry
from repro_torch.engine.plan import REFERENCE_DISPATCH, ConvPlan, ScenePlan


def available_backends(registry: BackendRegistry = DEFAULT_REGISTRY
                       ) -> tuple[str, ...]:
    """Backend names resolvable through ``registry``."""
    return (AUTO,) + registry.names()


def reference_plan(coir: COIR) -> ConvPlan:
    """Wrap bare COIR metadata as a gather + product (reference) plan."""
    return ConvPlan(coir, None, REFERENCE_DISPATCH)


def resolve_backend(plan: ConvPlan, backend: str = AUTO,
                    registry: BackendRegistry = DEFAULT_REGISTRY) -> str:
    """The backend a call will actually run, after plan-driven dispatch
    and fallback resolution through ``registry``."""
    return registry.resolve(plan, backend)


def sparse_conv(
    x: torch.Tensor,
    params: SparseConvParams,
    plan: ConvPlan,
    *,
    backend: str = AUTO,
    registry: BackendRegistry = DEFAULT_REGISTRY,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Run one sparse conv according to its plan -> (V_out, N) features."""
    name = registry.resolve(plan, backend)
    return registry.get(name).run(x, params, plan, use_kernel=use_kernel)


def conv_block(x, mask, plan: ConvPlan, block, **conv_kw):
    """Conv + masked BN + ReLU, the SCN building block (``block`` is a
    ``models.scn.ConvBlock``)."""
    y = sparse_conv(x, block.conv.params, plan, **conv_kw)
    return masked_batchnorm_relu(y, mask, block.bn_scale, block.bn_offset)


def apply_unet(
    model,
    feats,
    plan: ScenePlan,
    *,
    backend: str = AUTO,
    registry: BackendRegistry = DEFAULT_REGISTRY,
    use_kernel: bool = True,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """U-Net forward off an uploaded ScenePlan -> (V, n_classes) logits.

    ``model`` is a ``models.scn.SCNUNet``. ``feats`` (V, C_in) is copied to
    ``device`` if it lies elsewhere; the model and the plan must already be
    there (``upload_scene_plan(plan, device)``).
    """
    dev = require_device(device)
    if plan.device is None or plan.device.type != dev.type:
        raise ValueError(f"plan tables are on {plan.device}, not {dev}: "
                         "upload the plan with upload_scene_plan(plan, device)")
    if model.head.w.device.type != dev.type:
        raise ValueError(f"model is on {model.head.w.device}, not {dev}")
    feats = torch.as_tensor(feats, dtype=model.head.w.dtype, device=dev)
    kw = dict(backend=backend, registry=registry, use_kernel=use_kernel)
    x = sparse_conv(feats, model.stem.params, plan.levels[0].sub, **kw)
    skips = []
    for lvl, p in zip(plan.levels, model.levels):
        for blk in p.enc:
            x = conv_block(x, lvl.mask, lvl.sub, blk, **kw)
        if lvl.down is not None:
            skips.append(x)
            x = sparse_conv(x, p.down.params, lvl.down, **kw)
    for li in range(len(plan.levels) - 2, -1, -1):
        lvl, p = plan.levels[li], model.levels[li]
        up = sparse_conv(x, p.up.params, lvl.up, **kw)
        x = torch.cat([skips[li], up], dim=-1)
        for blk in p.dec:
            x = conv_block(x, lvl.mask, lvl.sub, blk, **kw)
    return x @ model.head.w + model.head.b
