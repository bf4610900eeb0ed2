"""Moonshot/Moonlight 16B-A3B fine-grained MoE decoder (port of
``repro.configs.moonshot_v1_16b``).

[hf:moonshotai/Moonlight-16B-A3B; hf] — 64 experts, top-6, narrow experts
(d_ff=1408, DeepSeek-style fine-grained).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        attn_pattern=(GLOBAL,),
        rope_theta=50000.0,
        act="swiglu",
        tie_embeddings=True,
        moe=MoEConfig(n_experts=64, top_k=6, capacity_factor=1.25),
        attn_sharding="heads",
    )
)
