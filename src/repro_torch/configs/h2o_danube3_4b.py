"""H2O Danube-3 4B dense decoder with sliding-window attention (port of
``repro.configs.h2o_danube3_4b``).

[arXiv:2401.16818; unverified] — llama+mistral mix; SWA(4096) on every
layer makes decode state O(window). Head dim 120: the flash wrapper pads
it to the kernel's 128 on the card (``kernels.flash.flash``).
"""
from repro_torch.configs.base import LOCAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        attn_pattern=(LOCAL,),
        window=4096,
        rope_theta=10000.0,
        act="swiglu",
        tie_embeddings=False,
        attn_sharding="heads",
        sub_quadratic=True,
    )
)
