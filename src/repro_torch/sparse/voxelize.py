"""Pointcloud -> voxel grid quantization (port of ``repro.sparse.voxelize``;
host-side numpy, the same arrays as the JAX package's).

Deduplicates points landing in the same voxel by averaging their features,
mirroring the standard SCN preprocessing (Graham et al. 2018).
"""
from __future__ import annotations

import numpy as np

from .tensor import PAD_COORD


def voxelize(
    points: np.ndarray,
    features: np.ndarray,
    resolution: int,
    capacity: int | None = None,
):
    """Quantize points in [0, 1)^3 onto a resolution^3 grid.

    Returns (coords (V,3) int32, feats (V,C), mask (V,)) padded to capacity.
    """
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {points.shape}")
    ijk = np.clip((points * resolution).astype(np.int64), 0, resolution - 1)
    key = (ijk[:, 0] * resolution + ijk[:, 1]) * resolution + ijk[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, start, counts = np.unique(key_s, return_index=True, return_counts=True)
    n = len(uniq_key)
    cap = capacity if capacity is not None else n
    if n > cap:
        # Keep the densest voxels first (deterministic truncation policy).
        keep = np.argsort(-counts, kind="stable")[:cap]
        keep.sort()
        uniq_key, start, counts = uniq_key[keep], start[keep], counts[keep]
        n = cap
    coords = np.full((cap, 3), PAD_COORD, np.int32)
    feats = np.zeros((cap, features.shape[1]), features.dtype)
    mask = np.zeros((cap,), bool)
    coords[:n, 0] = uniq_key // (resolution * resolution)
    coords[:n, 1] = (uniq_key // resolution) % resolution
    coords[:n, 2] = uniq_key % resolution
    # Mean feature per voxel via segment sums over the sorted order.
    seg_id = np.repeat(np.arange(n), counts)
    f_sorted = features[order]
    # order was truncated potentially: rebuild the slice covering kept voxels
    rows = (np.concatenate([np.arange(s, s + c)
                            for s, c in zip(start, counts)])
            if n else np.zeros(0, np.int64))
    sums = np.zeros((n, features.shape[1]), np.float64)
    np.add.at(sums, seg_id, f_sorted[rows])
    feats[:n] = (sums / counts[:, None]).astype(features.dtype)
    mask[:n] = True
    return coords, feats, mask
