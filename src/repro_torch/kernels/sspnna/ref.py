"""Plain PyTorch oracle for one stack of SSpNNA tiles (port of
``repro.kernels.sspnna.ref``).

For tile t, output slot o, weight plane k, the partner feature is
``feats[t, local_idx[t, o, k]]`` (zeros where the index is -1); the output
is the contraction of the gathered ``(dO, K, C)`` block with the
``(K, C, N)`` weights as one flattened ``(dO, K*C) @ (K*C, N)`` product,
accumulated in f32. ``random_tile_tables`` and ``random_tile_stack`` make
inputs of the fused and the pre-gathered kernel for holding each against
its plain version; ``TILE_STACK_CASES`` are the pre-gathered kernel's
shapes of ``tests/test_kernels.py`` plus ragged and wide ones.
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


# (t, d_i, d_o, k, c, n, dtype): the JAX package's five-case sweep
# (tests/test_kernels.py), then C and N not multiples of 4, K = 8 in bf16,
# and the widest SCN conv (C = 128, N = 64)
TILE_STACK_CASES = [
    (3, 64, 32, 27, 16, 16, torch.float32),
    (2, 96, 48, 27, 8, 24, torch.float32),
    (4, 32, 32, 8, 32, 16, torch.float32),
    (2, 64, 32, 27, 16, 16, torch.bfloat16),
    (1, 16, 8, 27, 64, 64, torch.float32),
    (5, 40, 20, 27, 6, 18, torch.float32),
    (3, 24, 9, 8, 12, 20, torch.bfloat16),
    (6, 128, 32, 27, 128, 64, torch.float32),
]
# max |got - want| / max(|want|, 1): f32 sums of up to K*C products in
# another order; in bf16 the output is rounded to bf16 (one ulp, 2**-8)
TILE_STACK_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def random_tile_stack(rng: np.random.Generator, *, t: int, d_i: int,
                      d_o: int, k: int = 27, c: int, n: int,
                      dtype: torch.dtype = torch.float32,
                      hole_p: float = 0.3, dead_p: float = 0.3):
    """Random inputs of ``sspnna_tiles`` as CPU tensors:
    ``(feats (T, dI, C), local_idx (T, dO, K) int32, weights (K, C, N))``,
    feats and weights in ``dtype``.

    local_idx is uniform in ``[0, dI)`` with holes (-1) at rate ``hole_p``,
    and each tile is all holes (a dead tile) with probability ``dead_p``;
    tile 0 is always dead and tile 1 (when T > 1) always live. Weights are
    scaled by ``1/sqrt(K*C)`` so outputs are about unit size.
    """
    feats = rng.normal(size=(t, d_i, c)).astype(np.float32)
    weights = (rng.normal(size=(k, c, n)) / np.sqrt(k * c)).astype(np.float32)
    idx = rng.integers(0, d_i, (t, d_o, k)).astype(np.int32)
    idx[rng.random((t, d_o, k)) < hole_p] = -1
    dead = rng.random(t) < dead_p
    dead[0] = True
    if t > 1:
        dead[1] = False
    idx[dead] = -1
    return (torch.from_numpy(feats).to(dtype), torch.from_numpy(idx),
            torch.from_numpy(weights).to(dtype))


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
