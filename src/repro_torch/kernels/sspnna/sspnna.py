"""Fused SSpNNA sparse conv: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.sspnna.sspnna.sspnna_fused``. The kernel
(``kernels/csrc/sspnna_fused.cu``) takes the global ``(V, C)`` feature
array plus the tile tables and writes each tile's outputs straight to their
global rows: no ``(T, dI, C)`` gathered copy and no scatter pass in device
memory. ``sspnna_fused_plain`` computes the same function with plain
PyTorch ops; the wrapper uses it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sspnna.ref import sspnna_tile_ref

KERNEL = "sspnna_fused"


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.sspnna_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(feats, weights, out_rows, in_rows, local_idx, pair_counts):
    if feats.dim() != 2 or weights.dim() != 3 or local_idx.dim() != 3:
        raise ValueError(
            f"expected feats (V, C), weights (K, C, N), local_idx (T, dO, K); "
            f"got {tuple(feats.shape)}, {tuple(weights.shape)}, "
            f"{tuple(local_idx.shape)}")
    t, d_o, k = local_idx.shape
    c = feats.shape[1]
    if weights.shape[:2] != (k, c):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"K={k}, C={c}")
    if (out_rows.shape != (t, d_o) or in_rows.dim() != 2
            or in_rows.shape[0] != t or pair_counts.shape != (t,)):
        raise ValueError(
            f"tile tables disagree: out_rows {tuple(out_rows.shape)}, "
            f"in_rows {tuple(in_rows.shape)}, local_idx {tuple(local_idx.shape)}, "
            f"pair_counts {tuple(pair_counts.shape)}")
    tensors = (feats, weights, out_rows, in_rows, local_idx, pair_counts)
    if any(x.device != feats.device for x in tensors):
        raise ValueError("all inputs must lie on one device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    if feats.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"sspnna_fused takes float32 only, got feats "
                        f"{feats.dtype} and weights {weights.dtype}")
    if any(x.dtype != torch.int32 for x in tensors[2:]):
        raise TypeError("tile tables must be int32")
    if torch.is_grad_enabled() and (feats.requires_grad or weights.requires_grad):
        raise RuntimeError(
            "sspnna_fused is forward-only (the kernel has no backward yet): "
            "run under torch.no_grad(), or use backend='reference'")


def sspnna_fused_plain(feats, weights, out_rows, in_rows, local_idx,
                       pair_counts, *, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: gather each tile's working
    set, run the tile oracle, overwrite the live tiles' output rows of a
    zeroed ``(n_out + 1, N)`` buffer (pads and dead tiles go to the trash
    row ``n_out``) and drop the trash row."""
    n = weights.shape[2]
    tile_feats = feats[in_rows.clamp(min=0).long()]  # (T, dI, C)
    tile_out = sspnna_tile_ref(tile_feats, local_idx, weights)  # (T, dO, N)
    live = (pair_counts > 0).unsqueeze(1)
    rows = torch.where(live & (out_rows >= 0), out_rows, n_out).long()
    out = torch.zeros((n_out + 1, n), dtype=feats.dtype, device=feats.device)
    out[rows.reshape(-1)] = tile_out.reshape(-1, n)
    return out[:n_out]


def sspnna_fused(feats, weights, out_rows, in_rows, local_idx, pair_counts,
                 *, n_out: int) -> torch.Tensor:
    """Fused gather-GEMM-scatter sparse conv -> (n_out, N) (no bias/mask).

    feats (V, C) f32; weights (K, C, N) f32; out_rows (T, dO), in_rows
    (T, dI), local_idx (T, dO, K) and pair_counts (T,) int32, in raw
    ``TilePlan`` layout (-1 pads) or the kernel layout of
    ``core.tiles.dma_tile_tables``. Tiles must own disjoint output rows.

    On CUDA tensors this launches the kernel (and counts the launch in
    ``sspnna_fused.launches``); on CPU tensors it runs
    ``sspnna_fused_plain``. Any other device raises.
    """
    _check(feats, weights, out_rows, in_rows, local_idx, pair_counts)
    if feats.device.type == "cpu":
        return sspnna_fused_plain(feats, weights, out_rows, in_rows,
                                  local_idx, pair_counts, n_out=n_out)
    if feats.device.type != "cuda":
        raise ValueError(f"sspnna_fused runs on cuda or cpu, not {feats.device}")
    tensors = (feats, weights, out_rows, in_rows, local_idx, pair_counts)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sspnna_fused needs contiguous inputs")
    t, d_o, k = local_idx.shape
    c, n, d_i = feats.shape[1], weights.shape[2], in_rows.shape[1]
    out = torch.zeros((n_out + 1, n), dtype=feats.dtype, device=feats.device)
    if t == 0 or n == 0:
        return out[:n_out]
    fn = _library().sspnna_fused_f32
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats.data_ptr(), weights.data_ptr(), out_rows.data_ptr(),
                 in_rows.data_ptr(), local_idx.data_ptr(),
                 pair_counts.data_ptr(), out.data_ptr(), t, d_o, d_i, k, c, n,
                 n_out, stream)
    if err:
        raise RuntimeError(f"sspnna_fused kernel launch failed: CUDA error {err}")
    sspnna_fused.launches += 1
    return out[:n_out]


sspnna_fused.launches = 0
