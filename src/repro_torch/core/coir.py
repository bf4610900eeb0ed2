"""COIR: Compressed Output-response / Input-receptive Field metadata (§IV-A).

Port of ``repro.core.coir``. CIRF is out-major (per output voxel, the input
partners of each weight plane), CORF in-major. Partners are stored as a
dense ``(V, K)`` index block with -1 holes plus a K-bit bitmask header word.
The leaves are numpy arrays on the host or torch tensors on the device; the
methods work on either.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from repro_torch.core.hashgrid import kernel_offsets


class COIR(NamedTuple):
    """indices (V, K) int32, partner per weight plane, -1 absent;
    bitmask (V,) uint32, bit k set iff indices[:, k] >= 0;
    mask (V,) bool, active rows of the major point set."""

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
