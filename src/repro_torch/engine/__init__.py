"""repro_torch.engine: plan-driven sparse-conv execution.

Build a ``ScenePlan`` once per scene on the host (``build_scene_plan_host``:
COIR + SOAR + SPADE + tiles), copy it to the card
(``upload_scene_plan``), then run the U-Net with ``apply_unet``. A
standalone conv site gets its tiled plan from ``conv_plan_for_layer``.
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
from repro_torch.engine.plan import (
    REFERENCE,
    SSPNNA,
    ConvPlan,
    Dispatch,
    LevelPlan,
    ScenePlan,
    TileArrays,
    build_scene_plan_host,
    conv_plan_for_layer,
    dispatch_from_dataflow,
    level_geometry,
    upload_scene_plan,
)

__all__ = [
    "AUTO", "DEFAULT_REGISTRY", "REFERENCE", "SSPNNA", "Backend",
    "BackendRegistry", "ConvPlan", "Dispatch", "LevelPlan",
    "ReferenceBackend", "SSpNNABackend", "ScenePlan", "TileArrays",
    "apply_unet", "available_backends", "build_scene_plan_host",
    "conv_block", "conv_plan_for_layer", "dispatch_from_dataflow",
    "level_geometry", "make_registry", "reference_plan", "resolve_backend",
    "sparse_conv", "upload_scene_plan",
]
