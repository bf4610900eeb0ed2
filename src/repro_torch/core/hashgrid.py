"""AdMAC neighbour search on the device (port of ``repro.core.hashgrid``).

Sorted linear keys plus a vectorized binary search stand in for the
paper's banked spatial hash: every (voxel, kernel-offset) pair issues one
``torch.searchsorted`` probe. These functions take torch tensors and work
on their device; ``core.host_meta`` holds the numpy twins the host planner
uses, and both give the same tables. The streaming ``UpdatableSortedGrid``
is not ported yet.
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


def upsample_coords(coords: torch.Tensor, mask: torch.Tensor):
    """Output set of a transposed (deconv) layer restoring a finer level.

    SCN U-Nets restore the saved finer-level active set rather than
    expanding it; callers pass the skip connection's coords, so this passes
    them through and documents the contract.
    """
    return coords, mask
