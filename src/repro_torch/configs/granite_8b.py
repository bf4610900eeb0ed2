"""IBM Granite 8B (code) dense decoder (port of
``repro.configs.granite_8b``).

[arXiv:2405.04324; hf] — llama-arch GQA.
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        attn_pattern=(GLOBAL,),
        rope_theta=10000.0,
        act="swiglu",
        tie_embeddings=True,
        attn_sharding="heads",
    )
)
