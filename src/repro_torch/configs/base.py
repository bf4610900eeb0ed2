"""Model configuration schema and registry (port of ``repro.configs.base``).

``ModelConfig`` keeps the JAX package's fields and defaults, so a config
reads the same in both packages; ``reduced()`` gives the same small config
as the JAX package's (the size of the CPU tests). The working dtype is
``cfg.torch_dtype`` (the JAX package's ``jnp_dtype``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

# layer kinds usable in attn_pattern (cycled over layers)
GLOBAL, LOCAL, RWKV, RGLRU = "global", "local", "rwkv", "rglru"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_layer_period: int = 1       # every n-th layer is MoE


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn_pattern: tuple[str, ...] = (GLOBAL,)
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    act: str = "swiglu"              # swiglu|geglu|gelu
    norm_eps: float = 1e-6
    scale_embeddings: bool = False
    tie_embeddings: bool = True
    moe: MoEConfig = field(default_factory=MoEConfig)
    # ssm / hybrid extras
    rglru_dim: int = 0
    conv1d_width: int = 4
    rwkv_head_dim: int = 64
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: number of prefix embeddings supplied externally
    frontend: str | None = None      # None|"vision"|"audio"
    n_frontend_tokens: int = 0
    # numerics / training
    dtype: str = "bfloat16"
    attn_dtype: str = "float32"      # online-softmax accumulation dtype
    remat: bool = True
    remat_policy: str = "full"       # full | dots
    optimizer: str = "adamw"         # adamw|adafactor
    # distribution
    attn_sharding: str = "heads"     # heads|sequence
    sub_quadratic: bool = False      # may run long_500k

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    def param_count(self) -> int:
        """Analytical parameter count (the JAX package's, term for term)."""
        d, v = self.d_model, self.vocab_padded
        att = (d * self.n_heads * self.head_dim * 2
               + d * self.n_kv_heads * self.head_dim * 2)
        if self.act in ("swiglu", "geglu"):
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        total = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in (GLOBAL, LOCAL):
                total += att
            elif kind == RWKV:
                total += 4 * d * d + 2 * d * self.d_ff + d * d  # tm + cm approx
                continue  # rwkv channel-mix replaces ffn
            elif kind == RGLRU:
                r = self.rglru_dim or d
                total += 2 * d * r + r * d + 2 * r * self.conv1d_width
            if self.is_moe and (i % self.moe.moe_layer_period == 0):
                total += self.moe.n_experts * ffn + d * self.moe.n_experts
            else:
                total += ffn
        total += v * d * (1 if self.tie_embeddings else 2)
        enc_att = att
        total += self.encoder_layers * (enc_att + ffn
                                        + (att if self.is_encdec else 0))
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        ffn = (3 if self.act in ("swiglu", "geglu") else 2) * d * self.d_ff
        n_moe_layers = self.n_layers // self.moe.moe_layer_period
        dense_total = self.param_count() - n_moe_layers * (
            self.moe.n_experts * ffn
        )
        return dense_total + self.n_layers // self.moe.moe_layer_period * (
            self.moe.top_k * ffn
        )

    def reduced(self) -> "ModelConfig":
        """Family-preserving small config for CPU tests (the JAX package's
        ``reduced()``, field for field)."""
        n_kv = max(1, min(self.n_kv_heads,
                          4 * self.n_kv_heads // max(self.n_heads, 1), 4))
        if self.n_kv_heads == self.n_heads:
            n_kv = 4
        moe = self.moe
        if self.is_moe:
            moe = replace(moe, n_experts=min(8, moe.n_experts),
                          top_k=min(2, moe.top_k), capacity_factor=4.0)
        return replace(
            self,
            n_layers=min(self.n_layers, 2 if self.is_encdec else 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=32,
            rglru_dim=128 if self.rglru_dim else 0,
            encoder_layers=min(self.encoder_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            moe=moe,
            dtype="float32",
            remat=False,
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs  # noqa: F401

    return sorted(_REGISTRY)
