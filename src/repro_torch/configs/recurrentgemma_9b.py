"""RecurrentGemma 9B (Griffin): RG-LRU and local attention, 1:2 (port of
``repro.configs.recurrentgemma_9b``).

[arXiv:2402.19427; unverified] — two RG-LRU recurrent blocks then one
local-MQA block (window 2048), GeGLU MLP, embedding scaling; 38 layers are
12 cycles of the pattern and 2 RG-LRU layers after them. O(state) decode.
"""
from repro_torch.configs.base import LOCAL, RGLRU, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        attn_pattern=(RGLRU, RGLRU, LOCAL),
        window=2048,
        rope_theta=10000.0,
        act="geglu",
        scale_embeddings=True,
        tie_embeddings=True,
        rglru_dim=4096,
        conv1d_width=4,
        attn_sharding="heads",
        sub_quadratic=True,
    )
)
