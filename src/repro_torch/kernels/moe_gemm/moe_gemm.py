"""Grouped expert GEMM: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.moe_gemm.moe_gemm.grouped_gemm``. Per expert e,
``out[e] = where(valid[e][:, None], xin[e], 0) @ w[e]``, summed in f32. The
kernel (``kernels/csrc/moe_gemm.cu``) takes any C, d and f (no block
divisibility), f32 or bf16 inputs, ``valid`` as a bool (byte) tensor, and
stores in ``out_dtype``: xin's dtype by default, as the TPU kernel does, or
float32, which the MoE layer asks for where the JAX package keeps an f32
product (``models.moe``). Rows that are not valid come out as exact zeros.
bf16 inputs run on the tensor cores: for C >= 64 (prefill) on ``wgmma``
tiles of 128 of an expert's valid rows by 128 columns, for C < 64
(decode) on 64-column slabs of ``w`` streamed through ``mma.sync``; f32
inputs run on the CUDA cores. A row tile past an expert's valid rows,
and an expert no row chose, write their zeros without reading ``w``.
Sums are bitwise reproducible (no atomics). ``grouped_gemm_ref`` computes
the same function with plain PyTorch ops; the wrapper uses it only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

KERNEL = "moe_gemm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# moe_gemm(x, w, valid, out, dtype, out_dtype, e, c, d, f, stream) of
# csrc/moe_gemm.cu
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.moe_gemm.argtypes = ARGTYPES
    lib.moe_gemm.restype = ctypes.c_int
    return lib


def _check(xin, w, valid, out_dtype):
    if xin.dim() != 3 or w.dim() != 3 or valid.dim() != 2:
        raise ValueError(
            f"expected xin (E, C, d), w (E, d, f), valid (E, C); got "
            f"{tuple(xin.shape)}, {tuple(w.shape)}, {tuple(valid.shape)}")
    e, c, d = xin.shape
    if w.shape[:2] != (e, d) or valid.shape != (e, c):
        raise ValueError(f"w {tuple(w.shape)} or valid {tuple(valid.shape)} "
                         f"do not match xin {tuple(xin.shape)}")
    if xin.dtype not in _DTYPE_CODE or w.dtype != xin.dtype:
        raise TypeError(f"grouped_gemm takes float32 or bfloat16 xin and w "
                        f"of one dtype, got {xin.dtype} and {w.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if w.device != xin.device or valid.device != xin.device:
        raise ValueError("xin, w and valid must lie on one device")
    if torch.is_grad_enabled() and (xin.requires_grad or w.requires_grad):
        raise RuntimeError(
            "grouped_gemm is forward-only (the kernel has no backward yet): "
            "run under torch.no_grad()")


def grouped_gemm(xin: torch.Tensor, w: torch.Tensor, valid: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """xin (E, C, d), w (E, d, f), valid (E, C) bool -> (E, C, f) in
    ``out_dtype`` (default xin's dtype; float32 or bfloat16).

    On CUDA tensors this launches the kernel (and counts the launch in
    ``grouped_gemm.launches``); on CPU tensors it runs ``grouped_gemm_ref``.
    Any other device raises.
    """
    out_dtype = out_dtype or xin.dtype
    _check(xin, w, valid, out_dtype)
    if xin.device.type == "cpu":
        return grouped_gemm_ref(xin, w, valid, out_dtype)
    if xin.device.type != "cuda":
        raise ValueError(f"grouped_gemm runs on cuda or cpu, not {xin.device}")
    if not all(x.is_contiguous() for x in (xin, w, valid)):
        raise ValueError("grouped_gemm needs contiguous xin, w and valid")
    e, c, d = xin.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=out_dtype, device=xin.device)
    if out.numel() == 0:
        return out
    fn = _library().moe_gemm
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xin.data_ptr(), w.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[xin.dtype],
                 _DTYPE_CODE[out_dtype], e, c, d, f, stream)
    if err:
        raise RuntimeError(f"grouped_gemm kernel launch failed: CUDA error "
                           f"{err}")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0
