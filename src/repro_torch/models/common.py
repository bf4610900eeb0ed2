"""Shared model components: norms, softcap, RoPE, initializers (port of
``repro.models.common``).

``rms_norm`` computes in f32 and multiplies by ``w`` (not ``1 + w``), and
RoPE rotates split halves in f32, as the JAX package does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.abstract import is_abstract


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.cache
def rope_table(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """``rope_frequencies(head_dim, theta)`` as f32 on ``device``, made at
    first use and kept under every input of its value, so a layer copies
    nothing from the host. To a card it is copied from pinned memory
    without blocking, so even the first call does not wait on the stream.
    ``rope_table.cache_clear()`` empties the table."""
    freqs = torch.from_numpy(rope_frequencies(head_dim, theta))
    if device.type == "cuda":
        freqs = freqs.pin_memory()
    return freqs.to(device, non_blocking=True)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    if is_abstract(positions):
        # fake positions (the dry run's): a table of this fake mode, never
        # kept across modes by the cache
        freqs = positions.new_tensor(rope_frequencies(d, theta))
    else:
        freqs = rope_table(d, theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device, scale: float | None = None
               ) -> torch.Tensor:
    """Normal weights of std ``scale`` (default ``1/sqrt(fan_in)``), drawn
    in f32 on the generator's device, then cast and moved to ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * s
    return w.to(device=device, dtype=dtype)
