"""Arch registry of the port: every config of the JAX package (four dense
decoders, two MoE, one hybrid of RG-LRU and local attention, one RWKV, a
decoder with a stub vision frontend and an encoder-decoder).

``get_config(name)`` returns the public config; ``cfg.reduced()`` the
test size.
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    granite_8b,
    h2o_danube3_4b,
    llama4_maverick_400b,
    moonshot_v1_16b,
    pixtral_12b,
    recurrentgemma_9b,
    rwkv6_7b,
    seamless_m4t_medium,
    stablelm_1_6b,
)
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    get_config,
    list_configs,
    register,
)

ARCH_NAMES = list_configs()

__all__ = ["ModelConfig", "MoEConfig", "get_config", "list_configs",
           "register", "ARCH_NAMES"]
