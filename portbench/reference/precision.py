"""The products of a reference, in the precision it is asked for: f32 with
TF32 off, or a lower precision emulated on f32 operands (the controls).

* ``"f32"``: IEEE f32 products (``torch.backends.cuda.matmul.allow_tf32``
  off, highest float32 matmul precision);
* ``"tf32"``: each operand rounded to TF32 (10 mantissa bits, to nearest)
  and multiplied in f32, what a TF32 tensor-core product computes;
* ``"fp8"``: each operand quantized to float8 e4m3 with one scale per row
  of the left and per column of the right operand, multiplied in f32, what
  an fp8 GEMM with per-token and per-channel scales computes.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32 inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (half away from zero
    on the magnitude), kept as f32."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in f32 (a: (..., K), b: (K, N)) in ``precision``."""
    a, b = a.float(), b.float()
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    elif precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, 0)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return a @ b
