"""AdMAC neighbour search on the device (port of ``repro.core.hashgrid``).

Sorted linear keys plus a vectorized binary search stand in for the
paper's banked spatial hash: every (voxel, kernel-offset) pair issues one
``torch.searchsorted`` probe. These functions take torch tensors and work
on their device; ``core.host_meta`` holds the numpy twins the host planner
uses, and both give the same tables. ``UpdatableSortedGrid`` is the
streaming planner's numpy index, patched frame to frame instead of
re-sorted.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.tensor import PAD_COORD, linear_key


def kernel_offsets(kernel_size: int, centered: bool | None = None) -> np.ndarray:
    """Lexicographic (K^3, 3) integer offsets for a cubic kernel.

    Odd kernels default to centered offsets (submanifold convs); even kernels
    to [0, K) offsets (strided down/up-sampling convs), matching SCN.
    """
    if centered is None:
        centered = kernel_size % 2 == 1
    lo = -(kernel_size // 2) if centered else 0
    rng = np.arange(lo, lo + kernel_size)
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


class SortedGrid:
    """Sorted-key index over an active-voxel set (the adjacency 'hash')."""

    def __init__(self, coords: torch.Tensor, mask: torch.Tensor,
                 resolution: int):
        self.coords = coords
        self.mask = mask
        self.resolution = resolution
        keys = linear_key(coords, resolution, mask)
        order = torch.argsort(keys, stable=True)
        self.sorted_keys = keys[order].contiguous()
        self.sorted_idx = order.to(torch.int32)

    def lookup(self, query_coords: torch.Tensor,
               query_valid: torch.Tensor) -> torch.Tensor:
        """Indices into the voxel list for each query coord; -1 if absent."""
        r = self.resolution
        in_bounds = ((query_coords >= 0) & (query_coords < r)).all(dim=-1)
        valid = query_valid & in_bounds
        qkey = linear_key(query_coords, r, valid)
        pos = torch.searchsorted(self.sorted_keys, qkey.contiguous())
        pos = pos.clamp(0, self.sorted_keys.shape[0] - 1)
        found = valid & (self.sorted_keys[pos] == qkey)
        return torch.where(found, self.sorted_idx[pos], -1).to(torch.int32)


def query_neighbors(
    out_coords: torch.Tensor,
    out_mask: torch.Tensor,
    in_coords: torch.Tensor,
    in_mask: torch.Tensor,
    offsets,
    resolution: int,
    stride: int = 1,
) -> torch.Tensor:
    """For each output voxel, the input voxel at each kernel offset.

    The input coordinate probed for output o and offset d is
    ``o * stride + d``. Returns (V_out, K) int32, -1 where the input voxel
    is inactive or out of bounds or the output row is padding.
    """
    grid = SortedGrid(in_coords, in_mask, resolution)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=out_coords.device)
    probe = out_coords[:, None, :] * stride + offs[None, :, :]  # (Vo, K, 3)
    valid = out_mask[:, None].expand(-1, offs.shape[0])
    return grid.lookup(probe, valid)


def build_neighbor_table(coords: torch.Tensor, mask: torch.Tensor, offsets,
                         resolution: int) -> torch.Tensor:
    """Adjacency map of an active set against itself (submanifold case)."""
    return query_neighbors(coords, mask, coords, mask, offsets, resolution,
                           stride=1)


def downsample_coords(
    coords: torch.Tensor,
    mask: torch.Tensor,
    resolution: int,
    factor: int = 2,
    capacity_out: int | None = None,
):
    """Output active set of a strided conv: unique(coords // factor).

    Returns (out_coords (Vo, 3) int32, out_mask (Vo,)) with Vo =
    ``capacity_out`` (default: the input capacity), rows sorted by linear
    key; unique keys past the capacity are dropped, as in the JAX package.
    Runs without a host sync.
    """
    dev = coords.device
    cap_out = capacity_out or coords.shape[0]
    r_out = max(resolution // factor, 1)
    down = torch.where(mask[:, None], coords // factor, PAD_COORD)
    sorted_keys = torch.sort(linear_key(down, r_out, mask)).values
    is_first = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        sorted_keys[1:] != sorted_keys[:-1],
    ]) & (sorted_keys < r_out ** 3)
    # compact first occurrences into the output prefix; the rest (and any
    # past the capacity) go to a trash slot that is cut off
    dest = torch.cumsum(is_first.to(torch.int32), 0) - 1
    slot = torch.where(is_first & (dest < cap_out), dest, cap_out).long()
    out_keys = torch.full((cap_out + 1,), 2**31 - 1, dtype=torch.int32,
                          device=dev)
    out_keys[slot] = sorted_keys
    out_keys = out_keys[:cap_out]
    n_out = is_first.sum()
    out_mask = torch.arange(cap_out, device=dev) < n_out
    out_coords = torch.stack([
        out_keys // (r_out * r_out),
        (out_keys // r_out) % r_out,
        out_keys % r_out,
    ], dim=-1).to(torch.int32)
    out_coords = torch.where(out_mask[:, None], out_coords, PAD_COORD)
    return out_coords, out_mask


class UpdatableSortedGrid:
    """Updatable sorted-key index: the streaming seam of the AdMAC search.

    ``SortedGrid`` / ``host_meta.SortedGridNp`` re-sort the full key set per
    scene — fine for i.i.d. uploads, wasteful for a 10–20 Hz LiDAR stream
    where frame t+1 keeps most of frame t's voxels. This numpy structure
    keeps only the *active* keys sorted (paired with their row ids) and
    supports the three stream mutations without a full re-sort:

    * ``shift(key_offset)`` — uniform ego motion. Linear keys are linear in
      the coordinate, so a constant coordinate shift is a constant key
      offset and preserves sorted order entirely (O(n) add).
    * ``delete(keys)`` — batched removal by sorted key (O(n) compress).
    * ``insert(keys, rows)`` — batched insertion of sorted new keys at
      their ``searchsorted`` positions (O(n + m log n) merge, no re-sort).

    ``lookup`` returns bit-identical results to ``SortedGridNp.lookup`` on
    the same active set: active keys are unique, and the sentinel rows the
    capacity-shaped variant carries can never match a valid query, so
    dropping them changes nothing.
    """

    def __init__(self, resolution: int, keys: np.ndarray | None = None,
                 rows: np.ndarray | None = None):
        self.resolution = resolution
        self.keys = (np.empty((0,), np.int32) if keys is None
                     else np.asarray(keys, np.int32))
        self.rows = (np.empty((0,), np.int32) if rows is None
                     else np.asarray(rows, np.int32))
        if self.keys.shape != self.rows.shape:
            raise ValueError(
                f"keys {self.keys.shape} / rows {self.rows.shape} mismatch")

    @classmethod
    def from_coords(cls, coords: np.ndarray, mask: np.ndarray,
                    resolution: int) -> "UpdatableSortedGrid":
        from repro_torch.core.host_meta import linear_key_np

        mask = np.asarray(mask)
        rows = np.flatnonzero(mask).astype(np.int32)
        keys = linear_key_np(np.asarray(coords)[rows], resolution)
        order = np.argsort(keys, kind="stable")
        return cls(resolution, keys[order], rows[order])

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def shift(self, key_offset: int) -> None:
        """Apply a uniform key offset (ego motion after removals: every
        remaining coordinate stays in bounds, so no per-component borrow
        can break the linear-key arithmetic)."""
        if key_offset:
            self.keys = self.keys + np.int32(key_offset)

    def delete(self, keys: np.ndarray) -> None:
        """Remove ``keys`` (sorted or not; must all be present)."""
        keys = np.asarray(keys, np.int32)
        if not keys.size:
            return
        pos = np.searchsorted(self.keys, keys)
        if (pos >= len(self.keys)).any() or (self.keys[np.minimum(
                pos, len(self.keys) - 1)] != keys).any():
            raise KeyError("delete of keys not present in the grid")
        keep = np.ones(len(self.keys), bool)
        keep[pos] = False
        self.keys = self.keys[keep]
        self.rows = self.rows[keep]

    def insert(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Insert new (key, row) pairs (keys must be sorted + absent)."""
        keys = np.asarray(keys, np.int32)
        rows = np.asarray(rows, np.int32)
        if not keys.size:
            return
        pos = np.searchsorted(self.keys, keys)
        self.keys = np.insert(self.keys, pos, keys)
        self.rows = np.insert(self.rows, pos, rows)

    def lookup(self, query_coords: np.ndarray,
               query_valid: np.ndarray) -> np.ndarray:
        """Row ids for query coords; -1 if absent (``SortedGridNp`` twin)."""
        from repro_torch.core.host_meta import linear_key_np

        r = self.resolution
        q = np.asarray(query_coords)
        in_bounds = np.all((q >= 0) & (q < r), axis=-1)
        valid = np.asarray(query_valid) & in_bounds
        qkey = linear_key_np(q, r, valid)
        if not len(self.keys):
            return np.full(qkey.shape, -1, np.int32)
        pos = np.searchsorted(self.keys, qkey)
        pos = np.minimum(pos, len(self.keys) - 1)
        found = valid & (self.keys[pos] == qkey)
        return np.where(found, self.rows[pos], -1).astype(np.int32)


def upsample_coords(coords: torch.Tensor, mask: torch.Tensor):
    """Output set of a transposed (deconv) layer restoring a finer level.

    SCN U-Nets restore the saved finer-level active set rather than
    expanding it; callers pass the skip connection's coords, so this passes
    them through and documents the contract.
    """
    return coords, mask
