"""SeamlessM4T-medium encoder-decoder, the speech frontend a stub (port of
``repro.configs.seamless_m4t_medium``).

[arXiv:2308.11596; hf] — 12 encoder and 12 decoder layers; precomputed
frame embeddings (``enc_frames``) are the encoder's input. The vocab of
256206 is padded to 256256 (the padded logits are masked).
"""
from repro_torch.configs.base import GLOBAL, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        attn_pattern=(GLOBAL,),
        rope_theta=10000.0,
        act="gelu",
        tie_embeddings=True,
        encoder_layers=12,
        frontend="audio",
        attn_sharding="heads",
    )
)
