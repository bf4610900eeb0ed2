"""Plain PyTorch oracle for one stack of SSpNNA tiles (port of
``repro.kernels.sspnna.ref``).

For tile t, output slot o, weight plane k, the partner feature is
``feats[t, local_idx[t, o, k]]`` (zeros where the index is -1); the output
is the contraction of the gathered ``(dO, K, C)`` block with the
``(K, C, N)`` weights as one flattened ``(dO, K*C) @ (K*C, N)`` product,
accumulated in f32. ``random_tile_tables`` makes inputs of the fused
kernel for holding it against its plain version.
"""
from __future__ import annotations

import numpy as np
import torch


def sspnna_tile_ref(feats: torch.Tensor, local_idx: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """feats (T, dI, C); local_idx (T, dO, K), -1 holes; weights (K, C, N)
    -> (T, dO, N) in feats.dtype."""
    t, d_o, k = local_idx.shape
    c = feats.shape[2]
    valid = local_idx >= 0
    idx = local_idx.clamp(min=0).long().reshape(t, d_o * k, 1)
    gathered = torch.gather(feats, 1, idx.expand(t, d_o * k, c))
    gathered = torch.where(valid.unsqueeze(-1), gathered.reshape(t, d_o, k, c), 0.0)
    out = gathered.reshape(t, d_o, k * c).float() @ weights.reshape(k * c, -1).float()
    return out.to(feats.dtype)


def random_tile_tables(rng: np.random.Generator, *, v: int, c: int, n: int,
                       t: int, d_i: int, d_o: int, k: int = 27,
                       hole_p: float = 0.3, dead_p: float = 0.3):
    """Random numpy inputs of ``sspnna_fused``, in its argument order:
    ``(feats, weights, out_rows, in_rows, local_idx, pair_counts)``.

    They honor the planner contract: local_idx only references slots
    holding valid in_rows; live tiles own disjoint output rows; dead tiles
    are all pads; -1 pads everywhere else. Weights are scaled by
    ``1/sqrt(K*C)`` so outputs are about unit size.
    """
    feats = rng.normal(size=(v, c)).astype(np.float32)
    weights = (rng.normal(size=(k, c, n)) / np.sqrt(k * c)).astype(np.float32)
    in_rows = np.full((t, d_i), -1, np.int32)
    out_rows = np.full((t, d_o), -1, np.int32)
    local_idx = np.full((t, d_o, k), -1, np.int32)
    out_pool = rng.permutation(v)
    taken = 0
    for ti in range(t):
        if rng.random() < dead_p:
            continue
        n_valid = int(rng.integers(1, min(d_i, v) + 1))
        in_rows[ti, :n_valid] = rng.choice(v, size=n_valid, replace=False)
        n_rows = int(rng.integers(1, min(d_o, v - taken) + 1))
        out_rows[ti, :n_rows] = out_pool[taken:taken + n_rows]
        taken += n_rows
        li = rng.integers(0, n_valid, (n_rows, k)).astype(np.int32)
        holes = rng.random((n_rows, k)) < hole_p
        local_idx[ti, :n_rows] = np.where(holes, -1, li)
    pair_counts = (local_idx >= 0).sum(axis=(1, 2)).astype(np.int32)
    return feats, weights, out_rows, in_rows, local_idx, pair_counts
