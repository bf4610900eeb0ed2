"""COIR: Compressed Output-response / Input-receptive Field metadata (§IV-A).

Port of ``repro.core.coir``. CIRF is out-major (per output voxel, the input
partners of each weight plane), CORF in-major. Partners are stored as a
dense ``(V, K)`` index block with -1 holes plus a K-bit bitmask header word.
The leaves are numpy arrays on the host or torch tensors on the device; the
methods work on either. ``build_cirf``/``build_corf`` and
``transpose_flavor`` build COIR on the device from torch tensors;
``core.host_meta`` holds the host builders, which give the same tables.

The bitmask has the JAX package's bit pattern (bit k set iff plane k has a
partner). The host builders store it as uint32, as JAX does; the device
builders store it as int32, which holds the same bits for K <= 31 (27 for
a 3^3 kernel) and, unlike torch's uint32, supports the arithmetic torch
offers on integer tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.hashgrid import SortedGrid, kernel_offsets, query_neighbors


class COIR(NamedTuple):
    """indices (V, K) int32, partner per weight plane, -1 absent;
    bitmask (V,), bit k set iff indices[:, k] >= 0 (uint32 on the host,
    int32 on the device); mask (V,) bool, active rows of the major set."""

    indices: Any
    bitmask: Any
    mask: Any

    @property
    def n_weight_planes(self) -> int:
        return self.indices.shape[1]

    def valid(self):
        return self.indices >= 0

    def popcount(self):
        """Active partners per entry (receptive/response field size)."""
        return (self.indices >= 0).sum(1)

    def arf(self) -> float:
        """Average Receptive (or Response) Field over active entries."""
        n = max(int(self.mask.sum()), 1)
        return float((self.popcount() * self.mask).sum()) / n

    def n_pairs(self) -> int:
        return int((self.popcount() * self.mask).sum())


def kernel_offsets_np(kernel_size: int, centered: bool | None = None) -> np.ndarray:
    return kernel_offsets(kernel_size, centered)


def _pack_bitmask(indices: torch.Tensor) -> torch.Tensor:
    k = indices.shape[1]
    if k > 31:
        raise ValueError(f"an int32 bitmask holds at most 31 planes, not {k}")
    bits = (indices >= 0).to(torch.int32) << torch.arange(
        k, dtype=torch.int32, device=indices.device)
    return bits.sum(dim=1, dtype=torch.int32)


def build_cirf(
    out_coords: torch.Tensor,
    out_mask: torch.Tensor,
    in_coords: torch.Tensor,
    in_mask: torch.Tensor,
    offsets,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CIRF: out-major receptive-field metadata.

    ``indices[o, k]`` is the input voxel at ``out_coords[o]*stride + offsets[k]``.
    """
    idx = query_neighbors(out_coords, out_mask, in_coords, in_mask, offsets,
                          resolution, stride)
    return COIR(idx, _pack_bitmask(idx), out_mask)


def build_corf(
    out_coords: torch.Tensor,
    out_mask: torch.Tensor,
    in_coords: torch.Tensor,
    in_mask: torch.Tensor,
    offsets,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CORF: in-major response-field metadata.

    Output o is in the response field of input i at plane k iff
    ``o*stride + offsets[k] == i``, i.e. ``o == (i - offsets[k]) / stride``
    where the division is exact and in-bounds.
    """
    out_res = max(resolution // stride, 1) if stride > 1 else resolution
    grid = SortedGrid(out_coords, out_mask, out_res)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=in_coords.device)
    diff = in_coords[:, None, :] - offs[None, :, :]  # (Vi, K, 3)
    exact = (diff % stride == 0).all(dim=-1)
    probe = torch.div(diff, stride, rounding_mode="floor")
    valid = in_mask[:, None] & exact
    idx = grid.lookup(probe, valid)
    return COIR(idx, _pack_bitmask(idx), in_mask)


def transpose_flavor(coir: COIR, minor_capacity: int) -> COIR:
    """Convert CIRF<->CORF by inverting the (major, minor, plane) relation.

    Each (major m, plane k) -> minor i pair becomes (i, k) -> m. The plane
    slot is preserved, so at most one partner per (minor, plane) exists for
    convolution metadata and the scatter is collision-free.
    """
    minor = coir.indices  # (V, K)
    v, k = minor.shape
    dev = minor.device
    major = torch.arange(v, dtype=torch.int32, device=dev)[:, None].expand(v, k)
    plane = torch.arange(k, device=dev)[None, :].expand(v, k)
    ok = minor >= 0
    # invalid pairs land on a trash row that is cut off
    rows = torch.where(ok, minor, minor_capacity).long()
    out = torch.full((minor_capacity + 1, k), -1, dtype=torch.int32, device=dev)
    out[rows.reshape(-1), plane.reshape(-1)] = torch.where(
        ok, major, -1).reshape(-1)
    out = out[:minor_capacity]
    return COIR(out, _pack_bitmask(out), (out >= 0).any(dim=1))


# ---------------------------------------------------------------------------
# Metadata size accounting (paper §IV-A compression claim)
# ---------------------------------------------------------------------------

def coir_size_words(coir: COIR) -> int:
    """Logical COIR size in 32-bit words: per active entry, 1 header word
    (bitmask) + 1 self index + one word per active partner."""
    return int(((2 + coir.popcount()) * coir.mask).sum())


def rulebook_size_words(coir: COIR) -> int:
    """Size of the baseline per-weight-plane rulebook (SCN reference impl):
    every valid (in, out) pair appears as 2 words in some weight plane list."""
    return 2 * coir.n_pairs()
