"""SSpNNA kernels: the CUDA kernels' wrappers and their plain versions.

Port of ``repro.kernels.sspnna.sspnna``:

* ``sspnna_fused`` (``kernels/csrc/sspnna_fused.cu``) takes the global
  ``(V, C)`` feature array plus the tile tables and writes each tile's
  outputs straight to their global rows: no ``(T, dI, C)`` gathered copy
  and no scatter pass in device memory.
* ``sspnna_tiles`` (``kernels/csrc/sspnna_tiles.cu``) runs the same tile
  product over a pre-gathered ``(T, dI, C)`` stack and returns the
  ``(T, dO, N)`` tile outputs; ``ops.run_sspnna_conv(fused=False)``
  scatters them back with an accumulate, which plane-split plans need.

Both kernels take their tile body from ``kernels/csrc/sspnna_tile.cuh``
(one launch geometry, ``cp.async`` feed and ``mma.sync`` product), so a
pre-gathered conv equals the fused one bit for bit on the card.

``sspnna_fused_plain`` and ``sspnna_tiles_plain`` compute the same
functions with plain PyTorch ops; each wrapper uses its plain version only
for tensors that lie on the CPU. Both kernels are forward-only. The TPU
kernels' ``block_n``/``block_k`` (which only tile the N axis or split the
plane sum into blocks) and ``interpret`` are not taken.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sspnna.ref import sspnna_tile_ref

KERNEL = "sspnna_fused"
TILES_KERNEL = "sspnna_tiles"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# sspnna_fused_f32(feats, weights, out_rows, in_rows, local_idx, pair_counts,
# out, t, d_o, d_i, k, c, n, n_out, stream) of csrc/sspnna_fused.cu
FUSED_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.sspnna_fused_f32
    fn.argtypes = FUSED_ARGTYPES
    fn.restype = ctypes.c_int
    lib.sspnna_fused_geometry.argtypes = ([ctypes.c_int] * 5
                                          + [ctypes.POINTER(ctypes.c_int)])
    lib.sspnna_fused_geometry.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# Pre-gathered tile stack
# ---------------------------------------------------------------------------

# sspnna_tiles(feats, local_idx, weights, out, dtype, t, d_i, d_o, k, c, n,
# stream) of csrc/sspnna_tiles.cu
TILES_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

sspnna_tiles_plain = sspnna_tile_ref


@functools.cache
def _tiles_library() -> ctypes.CDLL:
    lib = build.load(TILES_KERNEL)
    lib.sspnna_tiles.argtypes = TILES_ARGTYPES
    lib.sspnna_tiles.restype = ctypes.c_int
    lib.sspnna_tiles_geometry.argtypes = ([ctypes.c_int] * 6
                                          + [ctypes.POINTER(ctypes.c_int)])
    lib.sspnna_tiles_geometry.restype = ctypes.c_int
    return lib


def _check_tiles(feats, local_idx, weights):
    if feats.dim() != 3 or local_idx.dim() != 3 or weights.dim() != 3:
        raise ValueError(
            f"expected feats (T, dI, C), local_idx (T, dO, K), weights "
            f"(K, C, N); got {tuple(feats.shape)}, {tuple(local_idx.shape)}, "
            f"{tuple(weights.shape)}")
    t, d_o, k = local_idx.shape
    c = feats.shape[2]
    if feats.shape[0] != t or weights.shape[:2] != (k, c):
        raise ValueError(
            f"feats {tuple(feats.shape)}, local_idx {tuple(local_idx.shape)} "
            f"and weights {tuple(weights.shape)} disagree on T, K or C")
    if feats.dtype not in _DTYPE_CODE or weights.dtype != feats.dtype:
        raise TypeError(f"sspnna_tiles takes float32 or bfloat16 feats and "
                        f"weights of one dtype, got {feats.dtype} and "
                        f"{weights.dtype}")
    if local_idx.dtype != torch.int32:
        raise TypeError(f"local_idx must be int32, got {local_idx.dtype}")
    if local_idx.device != feats.device or weights.device != feats.device:
        raise ValueError("feats, local_idx and weights must lie on one device")
    if torch.is_grad_enabled() and (feats.requires_grad or weights.requires_grad):
        raise RuntimeError(
            "sspnna_tiles is forward-only (the kernel has no backward yet): "
            "run under torch.no_grad(), or use backend='reference'")


def sspnna_tiles(feats: torch.Tensor, local_idx: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """SSpNNA over a pre-gathered stack of tiles -> (T, dO, N) in
    ``feats.dtype``: ``out[t, o] = sum_k feats[t, local_idx[t, o, k]] @
    weights[k]`` with f32 sums, -1 holes adding nothing.

    feats (T, dI, C) and weights (K, C, N) float32 or bfloat16 (one dtype);
    local_idx (T, dO, K) int32 in [-1, dI). On CUDA tensors this launches
    the kernel (and counts the launch in ``sspnna_tiles.launches``); on CPU
    tensors it runs ``sspnna_tiles_plain``. Any other device raises.
    """
    _check_tiles(feats, local_idx, weights)
    if feats.device.type == "cpu":
        return sspnna_tiles_plain(feats, local_idx, weights)
    if feats.device.type != "cuda":
        raise ValueError(f"sspnna_tiles runs on cuda or cpu, not {feats.device}")
    if not all(x.is_contiguous() for x in (feats, local_idx, weights)):
        raise ValueError("sspnna_tiles needs contiguous inputs")
    t, d_o, k = local_idx.shape
    d_i, c = feats.shape[1:]
    n = weights.shape[2]
    out = torch.empty((t, d_o, n), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    fn = _tiles_library().sspnna_tiles
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats.data_ptr(), local_idx.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[feats.dtype], t, d_i, d_o, k, c,
                 n, stream)
    if err:
        raise RuntimeError(f"sspnna_tiles kernel launch failed: CUDA error {err}")
    sspnna_tiles.launches += 1
    return out


sspnna_tiles.launches = 0


GEOMETRY = ("grid_x", "grid_y", "threads", "rows_per_block",
            "channels_per_block", "stages", "smem_bytes", "blocks_per_sm")


def launch_geometry(kernel: str, t: int, d_o: int, k: int, c: int, n: int,
                    dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """The CUDA launch that ``sspnna_fused`` (``kernel=KERNEL``) or
    ``sspnna_tiles`` (``TILES_KERNEL``) makes for ``t`` tiles of ``d_o``
    slots, ``k`` planes, C=``c``, N=``n``: grid, threads, rows and channels
    a block, plane stages, shared memory and the blocks an SM holds at once,
    keyed as ``GEOMETRY``. Builds and loads the library; needs the card."""
    shape = (ctypes.c_int * len(GEOMETRY))()
    if kernel == KERNEL:
        err = _library().sspnna_fused_geometry(t, d_o, k, c, n, shape)
    elif kernel == TILES_KERNEL:
        err = _tiles_library().sspnna_tiles_geometry(
            t, d_o, k, c, n, _DTYPE_CODE[dtype], shape)
    else:
        raise ValueError(f"no SSpNNA kernel named {kernel!r}")
    if err:
        raise ValueError(f"{kernel} has no launch for T={t} dO={d_o} K={k} "
                         f"C={c} N={n}: CUDA error {err}")
    return dict(zip(GEOMETRY, shape, strict=True))
