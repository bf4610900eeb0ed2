"""Arch registry of the port: the decoders it serves so far (two dense,
one MoE).

``get_config(name)`` returns the public config; ``cfg.reduced()`` the
test size. The other architectures of ``repro.configs`` come with the
slices that port their layers (``ROADMAP.md``).
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    moonshot_v1_16b,
    stablelm_1_6b,
)
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    get_config,
    list_configs,
    register,
)

__all__ = ["ModelConfig", "MoEConfig", "get_config", "list_configs",
           "register"]
