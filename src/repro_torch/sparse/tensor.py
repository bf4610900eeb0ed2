"""Fixed-capacity padded sparse voxel tensor (port of ``repro.sparse.tensor``).

A padded list of active voxel coordinates plus a feature row per voxel.
Padding slots have ``mask == False`` and ``coords == PAD_COORD``. The leaves
are numpy arrays on the host (what the planners read) or torch tensors on
the device (what the forward pass reads).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

PAD_COORD = -1

MAX_RESOLUTION = 1290  # largest R with R**3 < 2**31 (int32-safe linear keys)


class SparseVoxelTensor(NamedTuple):
    """coords (V, 3) int32, PAD_COORD on padding rows; feats (V, C);
    mask (V,) bool, True on active rows."""

    coords: Any
    feats: Any
    mask: Any

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def n_active(self) -> int:
        return int(self.mask.sum())

    def replace_feats(self, feats) -> "SparseVoxelTensor":
        return SparseVoxelTensor(self.coords, feats, self.mask)


def linear_key(coords: torch.Tensor, resolution: int,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Linear voxel key (int32); inactive/padding rows map to ``R**3``.

    Keys are strictly monotone in (x, y, z) lexicographic order, so sorted
    keys support binary-search neighbour lookup.
    """
    if resolution > MAX_RESOLUTION:
        raise ValueError(
            f"resolution {resolution} > int32-safe max {MAX_RESOLUTION}")
    c = coords.to(torch.int32)
    key = (c[..., 0] * resolution + c[..., 1]) * resolution + c[..., 2]
    sentinel = torch.tensor(resolution ** 3, dtype=torch.int32,
                            device=coords.device)
    keep = mask if mask is not None else (coords >= 0).all(dim=-1)
    return torch.where(keep, key, sentinel)
