"""repro_torch.engine: plan-driven sparse-conv execution.

Build a ``ScenePlan`` once per scene on the host (``build_scene_plan_host``:
COIR + SOAR + SPADE + tiles, or a pinned ``PlanSpec``'s decisions), copy it
to the card (``upload_scene_plan``), then run the U-Net with
``apply_unet``; ``stack_plans`` joins plans of one signature into a wave
that ``apply_unet`` runs in one pass. ``PlanCache`` memoizes plans by scene
content, and an ``ExecutionContext`` holds the device, the registry and the
cache that serving shares. A standalone conv site gets its tiled plan from
``conv_plan_for_layer``; a LiDAR stream patches each frame's plan from the
previous one's through ``StreamPlanState``.
"""
from repro_torch.engine.api import (
    apply_unet,
    available_backends,
    conv_block,
    reference_plan,
    resolve_backend,
    sparse_conv,
)
from repro_torch.engine.backends import (
    AUTO,
    DEFAULT_REGISTRY,
    Backend,
    BackendRegistry,
    ReferenceBackend,
    SSpNNABackend,
    make_registry,
)
from repro_torch.engine.context import (
    ExecutionContext,
    current_context,
    default_context,
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

__all__ = [
    "AUTO", "DEFAULT_REGISTRY", "REFERENCE", "SSPNNA", "Backend",
    "BackendRegistry", "ConvPlan", "Dispatch", "ExecutionContext",
    "LevelPlan", "PlanCache", "PlanSpec", "ReferenceBackend",
    "SSpNNABackend", "ScenePlan", "SignatureFamily", "StreamPlanState",
    "TileArrays",
    "apply_unet", "available_backends", "build_plan_spec",
    "build_scene_plan", "build_scene_plan_host", "build_signature_family",
    "choose_buckets", "conv_block", "conv_plan_for_layer",
    "current_context", "default_context", "dispatch_from_dataflow",
    "level_geometry", "make_registry", "plan_signature", "reference_plan",
    "resolve_backend", "scene_key", "set_default_context", "sparse_conv",
    "stack_plans", "upload_scene_plan", "use_context",
]
