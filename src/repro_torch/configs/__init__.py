"""Arch registry of the port: the decoders it serves so far (four dense,
two MoE, one hybrid of RG-LRU and local attention, one RWKV).

``get_config(name)`` returns the public config; ``cfg.reduced()`` the
test size. Pixtral's vision frontend and SeamlessM4T's encoder-decoder
come with part c of slice 10 (``ROADMAP.md``).
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    granite_8b,
    h2o_danube3_4b,
    llama4_maverick_400b,
    moonshot_v1_16b,
    recurrentgemma_9b,
    rwkv6_7b,
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
