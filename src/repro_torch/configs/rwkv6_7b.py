"""RWKV-6 (Finch) 7B: attention-free, data-dependent-decay linear RNN (port
of ``repro.configs.rwkv6_7b``).

[arXiv:2404.05892; hf] — 64 wkv heads of size 64; the time mix replaces
attention, the channel mix (d_ff=14336) the FFN. O(1) decode state.
"""
from repro_torch.configs.base import RWKV, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        attn_pattern=(RWKV,),
        rwkv_head_dim=64,
        act="rwkv_cm",
        tie_embeddings=False,
        attn_sharding="heads",
        sub_quadratic=True,
    )
)
