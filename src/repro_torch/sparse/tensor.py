"""Fixed-capacity padded sparse voxel tensor (port of ``repro.sparse.tensor``).

A padded list of active voxel coordinates plus a feature row per voxel.
Padding slots have ``mask == False`` and ``coords == PAD_COORD``. The leaves
are numpy arrays on the host (what the planners read) or torch tensors on
the device (what the forward pass reads). ``from_dense`` builds one on a
device from a dense grid; ``to_dense`` and ``compact_to_capacity`` work on
the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.device import host_array, require_device

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


def from_dense(dense: np.ndarray, capacity: int | None = None, *,
               device: str | torch.device = "cuda") -> SparseVoxelTensor:
    """A SparseVoxelTensor on ``device`` from a dense (X, Y, Z, C) numpy
    array: a voxel is active iff any channel is non-zero; active voxels
    come first in (x, y, z) order, then padding."""
    dev = require_device(device)
    dense = np.asarray(dense)
    occ = np.any(dense != 0, axis=-1)
    xs, ys, zs = np.nonzero(occ)
    n = len(xs)
    cap = capacity if capacity is not None else max(n, 1)
    if n > cap:
        raise ValueError(f"capacity {cap} < active voxels {n}")
    coords = np.full((cap, 3), PAD_COORD, np.int32)
    feats = np.zeros((cap, dense.shape[-1]), dense.dtype)
    mask = np.zeros((cap,), bool)
    coords[:n, 0], coords[:n, 1], coords[:n, 2] = xs, ys, zs
    feats[:n] = dense[xs, ys, zs]
    mask[:n] = True
    return SparseVoxelTensor(*(torch.from_numpy(x).to(dev)
                               for x in (coords, feats, mask)))


def to_dense(t: SparseVoxelTensor, resolution: int) -> np.ndarray:
    """Materialize to a dense (R, R, R, C) numpy array on the host."""
    coords, feats, mask = (host_array(x) for x in t)
    out = np.zeros((resolution,) * 3 + (feats.shape[-1],), feats.dtype)
    c = coords[mask]
    out[c[:, 0], c[:, 1], c[:, 2]] = feats[mask]
    return out


def compact_to_capacity(t: SparseVoxelTensor, capacity: int
                        ) -> tuple[SparseVoxelTensor, np.ndarray]:
    """Re-pack a scene into another fixed capacity on the host: active rows
    first in their original order, padding after.

    Returns ``(the compacted tensor with numpy leaves, active_idx)``, where
    compacted row ``i`` is source row ``active_idx[i]``.
    """
    mask = host_array(t.mask)
    idx = np.flatnonzero(mask)
    n = len(idx)
    if n > capacity:
        raise ValueError(
            f"capacity {capacity} < active voxels {n}; pick a larger bucket")
    coords_src, feats_src = host_array(t.coords), host_array(t.feats)
    coords = np.full((capacity, 3), PAD_COORD, np.int32)
    feats = np.zeros((capacity, feats_src.shape[-1]), feats_src.dtype)
    out_mask = np.zeros((capacity,), bool)
    coords[:n] = coords_src[idx]
    feats[:n] = feats_src[idx]
    out_mask[:n] = True
    return SparseVoxelTensor(coords, feats, out_mask), idx
