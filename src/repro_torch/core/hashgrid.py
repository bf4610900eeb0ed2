"""Kernel-offset stencils (port of ``repro.core.hashgrid.kernel_offsets``).

The sorted-key neighbour search itself runs on the host in
``core.host_meta``.
"""
from __future__ import annotations

import numpy as np


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
