"""Llama-4 Maverick 400B-A17B class MoE decoder (port of
``repro.configs.llama4_maverick_400b``).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — as the JAX package
takes the spec: every layer MoE, 128 experts, top-1 routing
(Switch-style), trained with Adafactor. One card holds one layer of it
at full width (128 experts x 3 x 5120 x 8192 in bf16, 32 GB).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        attn_pattern=(GLOBAL,),
        rope_theta=500000.0,
        act="swiglu",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25),
        optimizer="adafactor",
        attn_sharding="sequence",
        sub_quadratic=False,
    )
)
