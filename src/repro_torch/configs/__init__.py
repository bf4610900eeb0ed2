"""Arch registry of the port: the dense decoders it serves so far.

``get_config(name)`` returns the public config; ``cfg.reduced()`` the
test size. The other architectures of ``repro.configs`` come with the
slices that port their layers (``ROADMAP.md``).
"""
from repro_torch.configs import gemma2_2b, stablelm_1_6b  # noqa: F401
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    get_config,
    list_configs,
    register,
)

__all__ = ["ModelConfig", "MoEConfig", "get_config", "list_configs",
           "register"]
