"""StableLM-2 1.6B dense decoder (port of ``repro.configs.stablelm_1_6b``).

[hf:stabilityai/stablelm-2-1_6b; unverified] — full MHA (kv == heads).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        attn_pattern=(GLOBAL,),
        rope_theta=10000.0,
        act="swiglu",
        tie_embeddings=False,
        attn_sharding="heads",
    )
)
