"""Host-side AdMAC metadata builders (port of ``repro.core.host_meta``).

Sorted linear keys plus a vectorized binary search stand in for the paper's
banked spatial hash: every (voxel, kernel-offset) pair issues one
``searchsorted`` probe. Numpy on the host, so the whole offline pass (AdMAC
+ SOAR + SPADE + tiles) stays off the device until
``engine.plan.upload_scene_plan``. Outputs are bit-identical to the JAX
package's numpy twins (same tables, bitmasks and canonical orders).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.coir import COIR
from repro_torch.core.hashgrid import kernel_offsets
from repro_torch.sparse.tensor import MAX_RESOLUTION, PAD_COORD


def linear_key_np(coords: np.ndarray, resolution: int,
                  mask: np.ndarray | None = None) -> np.ndarray:
    """Numpy twin of ``sparse.tensor.linear_key`` (int32, same sentinel)."""
    if resolution > MAX_RESOLUTION:
        raise ValueError(
            f"resolution {resolution} > int32-safe max {MAX_RESOLUTION}")
    r = np.int32(resolution)
    c = np.asarray(coords).astype(np.int32)
    key = (c[..., 0] * r + c[..., 1]) * r + c[..., 2]
    sentinel = np.int32(resolution) ** 3
    if mask is not None:
        key = np.where(np.asarray(mask), key, sentinel)
    else:
        key = np.where(np.all(c >= 0, axis=-1), key, sentinel)
    return key.astype(np.int32)


class SortedGridNp:
    """Sorted-key index over an active-voxel set (the adjacency 'hash')."""

    def __init__(self, coords: np.ndarray, mask: np.ndarray, resolution: int):
        self.resolution = resolution
        keys = linear_key_np(coords, resolution, mask)
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_idx = order.astype(np.int32)

    def lookup(self, query_coords: np.ndarray,
               query_valid: np.ndarray) -> np.ndarray:
        """Indices into the voxel list for each query coord; -1 if absent."""
        r = self.resolution
        q = np.asarray(query_coords)
        in_bounds = np.all((q >= 0) & (q < r), axis=-1)
        valid = np.asarray(query_valid) & in_bounds
        qkey = linear_key_np(q, r, valid)
        pos = np.searchsorted(self.sorted_keys, qkey)
        pos = np.clip(pos, 0, self.sorted_keys.shape[0] - 1)
        found = valid & (self.sorted_keys[pos] == qkey)
        return np.where(found, self.sorted_idx[pos], -1).astype(np.int32)


def query_neighbors_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> np.ndarray:
    """(V_out, K) input row at ``out_coords * stride + offsets[k]``, -1 absent."""
    grid = SortedGridNp(in_coords, in_mask, resolution)
    out_coords = np.asarray(out_coords)
    offsets = np.asarray(offsets)
    probe = out_coords[:, None, :] * stride + offsets[None, :, :]
    valid = np.broadcast_to(np.asarray(out_mask)[:, None],
                            (out_coords.shape[0], offsets.shape[0]))
    return grid.lookup(probe, valid)


def _pack_bitmask_np(indices: np.ndarray) -> np.ndarray:
    k = indices.shape[1]
    bits = ((indices >= 0).astype(np.uint32)
            << np.arange(k, dtype=np.uint32)[None, :])
    return bits.sum(axis=1, dtype=np.uint32)


def build_cirf_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CIRF (out-major): ``indices[o, k]`` is the input voxel at
    ``out_coords[o] * stride + offsets[k]``."""
    idx = query_neighbors_np(out_coords, out_mask, in_coords, in_mask,
                             offsets, resolution, stride)
    return COIR(idx, _pack_bitmask_np(idx), np.asarray(out_mask))


def build_corf_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CORF (in-major): output o is in the response field of input i at
    plane k iff ``o * stride + offsets[k] == i``."""
    out_res = max(resolution // stride, 1) if stride > 1 else resolution
    grid = SortedGridNp(out_coords, out_mask, out_res)
    in_coords = np.asarray(in_coords)
    offsets = np.asarray(offsets)
    diff = in_coords[:, None, :] - offsets[None, :, :]
    exact = np.all(diff % stride == 0, axis=-1)
    probe = diff // stride
    valid = np.asarray(in_mask)[:, None] & exact
    idx = grid.lookup(probe, valid)
    return COIR(idx, _pack_bitmask_np(idx), np.asarray(in_mask))


def transposed_coir_np(
    coarse_coords: np.ndarray,
    coarse_mask: np.ndarray,
    fine_coords: np.ndarray,
    fine_mask: np.ndarray,
    fine_resolution: int,
    kernel_size: int = 2,
    stride: int = 2,
) -> COIR:
    """Metadata of the transposed (upsampling) conv: the CORF of the
    coarse-to-fine strided pairing, read out-major over the fine rows."""
    offs = kernel_offsets(kernel_size, centered=False)
    return build_corf_np(coarse_coords, coarse_mask, fine_coords, fine_mask,
                         offs, fine_resolution, stride)


def downsample_coords_np(
    coords: np.ndarray,
    mask: np.ndarray,
    resolution: int,
    factor: int = 2,
    capacity_out: int | None = None,
):
    """Unique ``coords // factor`` in sorted-key order -> (coords, mask)."""
    coords = np.asarray(coords)
    mask = np.asarray(mask)
    cap_out = capacity_out or coords.shape[0]
    r_out = max(resolution // factor, 1)
    down = np.where(mask[:, None], coords // factor, PAD_COORD)
    keys = linear_key_np(down, r_out, mask)
    sorted_keys = np.sort(keys)
    is_first = np.concatenate(
        [[True], sorted_keys[1:] != sorted_keys[:-1]]
    ) & (sorted_keys < np.int32(r_out) ** 3)
    dest = np.cumsum(is_first.astype(np.int32)) - 1
    out_keys = np.full((cap_out,), np.int32(2**31 - 1))
    keep = is_first & (dest < cap_out)
    out_keys[dest[keep]] = sorted_keys[keep]
    n_out = int(is_first.sum())
    out_mask = np.arange(cap_out) < n_out
    out_coords = np.stack(
        [
            out_keys // (r_out * r_out),
            (out_keys // r_out) % r_out,
            out_keys % r_out,
        ],
        axis=-1,
    ).astype(np.int32)
    out_coords = np.where(out_mask[:, None], out_coords, PAD_COORD)
    return out_coords, out_mask
