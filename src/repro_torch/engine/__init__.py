"""repro_torch.engine: plan-driven sparse-conv execution.

Build a ``ScenePlan`` once per scene on the host (``build_scene_plan_host``:
COIR + SOAR + SPADE + tiles, or a pinned ``PlanSpec``'s decisions), copy it
to the card (``upload_scene_plan``), then run the U-Net with
``apply_unet``; ``stack_plans`` joins plans of one signature into a wave
that ``apply_unet`` runs in one pass. ``PlanCache`` memoizes plans by scene
content, and an ``ExecutionContext`` holds the device, the registry and the
cache that serving shares. A standalone conv site gets its tiled plan from
``conv_plan_for_layer``; a LiDAR stream patches each frame's plan from the
previous one's through ``StreamPlanState``. A scene too large for one
device splits its capacity over shards (``engine.shard``:
``build_sharded_scene_plan_host`` and a ``ShardLayout``, ``pin_halo`` for
serving); ``apply_unet`` runs a ``ShardedScenePlan`` as a loop over the
shards, or one shard a process under a context's ``mesh``.

Measured dispatch (``engine.autotune``): a ``CostTable`` of per-backend
times by shape signature, which plan builds consult before SPADE's
analytical model (``autotune=``) and a serving engine re-profiles in its
idle gaps. Each registry carries circuit breakers (``registry.breakers``)
that reroute a failing backend's new plans along its fallback chain.
"""
from repro_torch.engine.api import (
    apply_unet,
    available_backends,
    conv_block,
    reference_plan,
    resolve_backend,
    sparse_conv,
)
from repro_torch.engine.autotune import (
    CostTable,
    Measurement,
    ShapeSig,
    default_cache_path,
    device_fingerprint,
    measure,
    measure_backends,
    profile_group,
    reprofile,
    seed_cost_table,
    signature,
)
from repro_torch.engine.backends import (
    AUTO,
    DEFAULT_REGISTRY,
    Backend,
    BackendRegistry,
    ReferenceBackend,
    SSpNNABackend,
    default_registry,
    register_backend,
)
from repro_torch.engine.context import (
    ExecutionContext,
    current_context,
    default_context,
    mesh_axes,
    set_default_context,
    use_context,
)
from repro_torch.engine.plan import (
    REFERENCE,
    SSPNNA,
    ConvPlan,
    Dispatch,
    LevelPlan,
    PlanCache,
    PlanSpec,
    ScenePlan,
    SignatureFamily,
    StreamPlanState,
    TileArrays,
    build_plan_spec,
    build_scene_plan,
    build_scene_plan_host,
    build_signature_family,
    choose_buckets,
    conv_plan_for_layer,
    dispatch_from_dataflow,
    level_geometry,
    plan_signature,
    scene_key,
    stack_plans,
    upload_scene_plan,
)
from repro_torch.engine.shard import (
    SHARDED,
    ShardedBackend,
    ShardedConvPlan,
    ShardedLevelPlan,
    ShardedScenePlan,
    ShardLayout,
    apply_unet_sharded,
    build_sharded_scene_plan,
    build_sharded_scene_plan_host,
    pin_halo,
    upload_sharded_scene_plan,
)


def __getattr__(name: str):
    # legacy closed-enum alias; api owns the (single) definition
    if name == "BACKENDS":
        from repro_torch.engine import api
        return api.BACKENDS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AUTO", "BACKENDS", "DEFAULT_REGISTRY", "REFERENCE", "SHARDED", "SSPNNA",
    "Backend", "BackendRegistry", "ConvPlan", "CostTable", "Dispatch",
    "ExecutionContext", "LevelPlan", "Measurement", "PlanCache", "PlanSpec",
    "ReferenceBackend", "SSpNNABackend", "ScenePlan", "ShapeSig",
    "ShardLayout", "ShardedBackend", "ShardedConvPlan", "ShardedLevelPlan",
    "ShardedScenePlan", "apply_unet_sharded", "build_sharded_scene_plan",
    "build_sharded_scene_plan_host", "mesh_axes", "pin_halo",
    "upload_sharded_scene_plan",
    "SignatureFamily", "StreamPlanState", "TileArrays",
    "apply_unet", "available_backends", "build_plan_spec",
    "build_scene_plan", "build_scene_plan_host", "build_signature_family",
    "choose_buckets", "conv_block", "conv_plan_for_layer",
    "current_context", "default_cache_path", "default_context",
    "default_registry", "device_fingerprint", "dispatch_from_dataflow",
    "level_geometry", "measure", "measure_backends",
    "plan_signature", "profile_group", "reference_plan", "register_backend",
    "reprofile", "resolve_backend", "scene_key", "seed_cost_table",
    "set_default_context", "signature", "sparse_conv", "stack_plans",
    "upload_scene_plan", "use_context",
]
