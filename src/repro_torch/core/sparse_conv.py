"""Spatially-sparse 3D convolution on COIR metadata (port of
``repro.core.sparse_conv``, main-path subset).

The reference dataflow gathers every partner feature per weight plane and
runs one ``(V, K*C) @ (K*C, N)`` product: the coarse single dispatch the
engine's ``reference`` backend runs, and the numerical oracle of the tiled
SSpNNA path. The JAX package leaves this to plain XLA ops, so it stays
plain PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.coir import COIR


class SparseConvParams(NamedTuple):
    weight: torch.Tensor  # (K, C, N)
    bias: torch.Tensor    # (N,)


def gather_partners(feats: torch.Tensor, coir: COIR) -> torch.Tensor:
    """(V, K, C) partner features; zeros at holes."""
    idx = coir.indices.clamp(min=0).long()
    g = feats[idx]  # (V, K, C)
    return torch.where(coir.valid().unsqueeze(-1), g, 0.0)


def reference_conv_cirf(
    feats_in: torch.Tensor, coir: COIR, params: SparseConvParams
) -> torch.Tensor:
    """Out-major (CIRF) evaluation: gather + one contraction with f32
    accumulation, then bias and the output mask."""
    g = gather_partners(feats_in, coir)
    v, k, c = g.shape
    w = params.weight
    out = (g.reshape(v, k * c).float() @ w.reshape(k * c, -1).float()
           ).to(feats_in.dtype)
    out = out + params.bias.to(out.dtype)
    return out * coir.mask.unsqueeze(-1).to(out.dtype)


def masked_batchnorm_relu(x, mask, scale, offset, eps: float = 1e-5):
    """BN + ReLU over active rows only (the SCN conv-block epilogue)."""
    m = mask.unsqueeze(-1).to(x.dtype)
    n = m.sum().clamp(min=1.0)
    mean = (x * m).sum(0) / n
    var = ((x - mean).square() * m).sum(0) / n
    y = (x - mean) * torch.rsqrt(var + eps) * scale + offset
    return torch.relu(y) * m
