"""Plan-driven sparse convolution and the U-Net forward (port of
``repro.engine.api``).

``sparse_conv(x, params, plan)`` runs one conv as its ``ConvPlan`` says:
the registry resolves the plan's backend name (``"auto"`` follows the
planner's decision) to ``reference`` (gather + one product) or ``sspnna``
(the fused CUDA kernel). ``apply_unet`` walks the SCN U-Net's levels off a
``ScenePlan``, exactly as the JAX package does, and hands a sharded plan
whole to its scene-level backend (``engine.shard``). ``use_kernel=False``
(the JAX package's option) runs tiled convs through the pre-gathered plain
branch instead of the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.coir import COIR
from repro_torch.core.sparse_conv import SparseConvParams, masked_batchnorm_relu
from repro_torch.device import require_device
from repro_torch.engine.backends import AUTO, DEFAULT_REGISTRY, BackendRegistry
from repro_torch.engine.context import current_context
from repro_torch.engine.plan import (
    REFERENCE_DISPATCH,
    ConvPlan,
    LevelPlan,
    ScenePlan,
    TileArrays,
)


def __getattr__(name: str):
    # legacy alias for the closed enum the JAX package's api once
    # hard-coded; computed on access so late registrations show up
    if name == "BACKENDS":
        return (AUTO,) + DEFAULT_REGISTRY.names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


def conv_block(x, mask, plan: ConvPlan, block, *, n_scenes: int = 1,
               **conv_kw):
    """Conv + masked BN + ReLU, the SCN building block (``block`` is a
    ``models.scn.ConvBlock``); ``n_scenes`` scenes of equal capacity one
    after the other are normalised each by its own statistics."""
    y = sparse_conv(x, block.conv.params, plan, **conv_kw)
    return masked_batchnorm_relu(y, mask, block.bn_scale, block.bn_offset,
                                 n_scenes=n_scenes)


def _scene_offsets(x: torch.Tensor, n_scenes: int, cap: int) -> torch.Tensor:
    """``i * cap`` for each row of ``x`` that belongs to scene ``i`` (its
    rows split evenly among the scenes), shaped to broadcast over x."""
    per = max(x.shape[0] // n_scenes, 1)
    off = torch.arange(x.shape[0], device=x.device, dtype=x.dtype) // per * cap
    return off.view(-1, *([1] * (x.dim() - 1)))


def _wave_conv(cp: ConvPlan | None, n: int, cap_in: int,
               cap_out: int) -> ConvPlan | None:
    """One conv's tables with scene i's rows moved by i*cap: partner and
    input rows where they name a row (>= 0), output rows too, and every
    tile pad (the scene's trash row ``cap_out``) to the wave's one trash
    row ``n * cap_out``, so no scene's pad lands in the next scene."""
    if cp is None:
        return None
    idx = cp.coir.indices
    idx = torch.where(idx >= 0, idx + _scene_offsets(idx, n, cap_in), idx)
    tiles = cp.tiles
    if tiles is not None:
        out_rows, in_rows = tiles.out_rows, tiles.in_rows
        real = (out_rows >= 0) & (out_rows < cap_out)
        out_rows = torch.where(
            real, out_rows + _scene_offsets(out_rows, n, cap_out), n * cap_out)
        in_rows = torch.where(in_rows >= 0,
                              in_rows + _scene_offsets(in_rows, n, cap_in),
                              in_rows)
        tiles = TileArrays(out_rows, in_rows, tiles.local_idx,
                           tiles.pair_counts)
    return ConvPlan(COIR(idx, cp.coir.bitmask, cp.coir.mask), tiles,
                    cp.dispatch)


def _wave_rows(plan: ScenePlan) -> ScenePlan:
    """A wave plan's tables with each scene's rows at its place in the
    wave (``_wave_conv``); a one-scene plan as it is."""
    n = plan.n_scenes
    if n == 1:
        return plan
    levels = []
    for li, lvl in enumerate(plan.levels):
        cap = lvl.mask.shape[0] // n
        coarse = (plan.levels[li + 1].mask.shape[0] // n
                  if lvl.down is not None else 0)
        levels.append(LevelPlan(
            lvl.coords, lvl.mask, _wave_conv(lvl.sub, n, cap, cap),
            _wave_conv(lvl.down, n, cap, coarse),
            _wave_conv(lvl.up, n, coarse, cap)))
    return ScenePlan(tuple(levels), plan.stats, n)


def apply_unet(
    model,
    feats,
    plan: ScenePlan,
    *,
    backend: str = AUTO,
    registry: BackendRegistry = DEFAULT_REGISTRY,
    use_kernel: bool = True,
    device: str | torch.device = "cuda",
    ctx=None,
    mark=None,
) -> torch.Tensor:
    """U-Net forward off an uploaded ScenePlan -> (V, n_classes) logits.

    ``model`` is a ``models.scn.SCNUNet``. ``feats`` (V, C_in) is copied to
    ``device`` if it lies elsewhere; the model and the plan must already be
    there (``upload_scene_plan(plan, device)``). A wave plan of B scenes
    takes their features one after the other (B x capacity rows) and gives
    their logits so.

    A plan carrying a ``scene_backend`` (``engine.shard.ShardedScenePlan``)
    runs whole through that backend's ``run_unet``, which reads the mesh
    of ``ctx`` (default: the ambient context); a ``backend=`` other than
    ``"auto"`` or that one raises, as in the JAX package.

    ``mark`` (optional) is called at each level boundary of the forward,
    in stream order, with the name of the stretch of work that ends there:
    ``"start"``, ``"rows"`` (a wave plan's tables moved to each scene's
    rows), ``"stem"``, ``"enc<i>"`` (level i's encoder blocks and its down
    conv), ``"dec<i>"`` (the up conv into level i, the skip and its decoder
    blocks), ``"head"``. The scene engine records a CUDA event
    at each (``serving.scene_engine``).
    """
    mark = mark or _no_mark
    scene_backend = getattr(plan, "scene_backend", None)
    if scene_backend is not None:
        if backend not in (AUTO, scene_backend):
            raise ValueError(
                f"plan is bound to scene-level backend {scene_backend!r}; "
                f"backend={backend!r} cannot serve it")
        if ctx is None:
            ctx = current_context()
        return registry.get(scene_backend).run_unet(
            model, feats, plan, ctx=ctx, device=device)
    dev = require_device(device)
    if plan.device is None or plan.device.type != dev.type:
        raise ValueError(f"plan tables are on {plan.device}, not {dev}: "
                         "upload the plan with upload_scene_plan(plan, device)")
    if model.head.w.device.type != dev.type:
        raise ValueError(f"model is on {model.head.w.device}, not {dev}")
    feats = torch.as_tensor(feats, dtype=model.head.w.dtype, device=dev)
    mark("start")
    plan = _wave_rows(plan)
    mark("rows")
    kw = dict(backend=backend, registry=registry, use_kernel=use_kernel)
    bn = dict(n_scenes=plan.n_scenes)
    x = sparse_conv(feats, model.stem.params, plan.levels[0].sub, **kw)
    mark("stem")
    skips = []
    for li, (lvl, p) in enumerate(zip(plan.levels, model.levels)):
        for blk in p.enc:
            x = conv_block(x, lvl.mask, lvl.sub, blk, **bn, **kw)
        if lvl.down is not None:
            skips.append(x)
            x = sparse_conv(x, p.down.params, lvl.down, **kw)
        mark(f"enc{li}")
    for li in range(len(plan.levels) - 2, -1, -1):
        lvl, p = plan.levels[li], model.levels[li]
        up = sparse_conv(x, p.up.params, lvl.up, **kw)
        x = torch.cat([skips[li], up], dim=-1)
        for blk in p.dec:
            x = conv_block(x, lvl.mask, lvl.sub, blk, **bn, **kw)
        mark(f"dec{li}")
    out = x @ model.head.w + model.head.b
    mark("head")
    return out


def _no_mark(name: str) -> None:
    pass
