"""Gemma-2 2B dense decoder (port of ``repro.configs.gemma2_2b``).

[arXiv:2408.00118; hf] — alternating local(4096)/global attention, logit
softcapping (attn 50, final 30), GeGLU, embedding scaling, tied embeddings.
"""
from repro_torch.configs.base import GLOBAL, LOCAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn_pattern=(LOCAL, GLOBAL),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        rope_theta=10000.0,
        act="geglu",
        scale_embeddings=True,
        tie_embeddings=True,
        attn_sharding="sequence",
    )
)
