"""Sparse conv through the fused SSpNNA kernel and a tile plan (port of
``repro.kernels.sspnna.ops.run_sspnna_conv``, fused path).

The engine's ``sspnna`` backend drives this. The accumulating pre-gathered
path of the JAX package (``fused=False``, for plane-split plans) is not
ported yet; the engine never builds plane-split plans.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sspnna.sspnna import sspnna_fused


def run_sspnna_conv(
    feats: torch.Tensor,       # (V_in, C) global input features
    weights: torch.Tensor,     # (K, C, N)
    out_rows: torch.Tensor,    # (T, dO) from TilePlan / dma_tile_tables
    in_rows: torch.Tensor,     # (T, dI)
    local_idx: torch.Tensor,   # (T, dO, K)
    *,
    n_out: int,
    pair_counts: torch.Tensor,  # (T,) pairs per tile, 0 = dead tile
) -> torch.Tensor:
    """Tiled sparse convolution -> (n_out, N) features (no bias/mask).

    Tiles must own disjoint output rows (the kernel's store overwrites).
    """
    return sspnna_fused(feats, weights, out_rows, in_rows, local_idx,
                        pair_counts, n_out=n_out)
