"""Pixtral 12B multimodal decoder, the backbone with a stub vision
frontend (port of ``repro.configs.pixtral_12b``).

[hf:mistralai/Pixtral-12B-2409; unverified] — mistral-nemo-style decoder;
256 precomputed patch embeddings a sequence (``frontend_embeds``) replace
the first 256 token embeddings (the frontend itself is a stub in both
packages).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        attn_pattern=(GLOBAL,),
        rope_theta=1000000.0,
        act="swiglu",
        tie_embeddings=False,
        frontend="vision",
        n_frontend_tokens=256,
        attn_sharding="heads",
    )
)
