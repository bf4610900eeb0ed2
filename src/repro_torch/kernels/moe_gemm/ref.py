"""Plain PyTorch oracle for the grouped expert GEMM (port of
``repro.kernels.moe_gemm.ref``), the cases that hold the CUDA kernel
against it on the card, and random kernel inputs."""
from __future__ import annotations

import numpy as np
import torch

# Cases that hold the kernel against its plain version on the card:
# (e, c, d, f, valid share, dtype, out dtype). The JAX test's three shapes
# (tests/test_kernels.py), C, d and f that are not multiples of the
# kernel's 64 x 64 x 32 tiles (nor of its 8-element vectors), an expert
# with no valid row (valid share < 0 empties expert 0), decode's C = 8,
# and a prefill-like width; f32 and bf16 inputs with both output dtypes.
MOE_GEMM_CASES = [
    (4, 16, 32, 64, 0.7, torch.float32, torch.float32),
    (8, 8, 64, 128, 0.7, torch.float32, torch.float32),
    (2, 32, 16, 48, 0.7, torch.bfloat16, torch.bfloat16),
    (3, 77, 45, 101, 0.6, torch.float32, torch.float32),
    (3, 77, 45, 101, 0.6, torch.bfloat16, torch.float32),
    (5, 130, 200, 72, -0.5, torch.bfloat16, torch.bfloat16),
    (6, 70, 96, 136, -0.5, torch.float32, torch.float32),
    (64, 8, 2048, 1408, 0.2, torch.bfloat16, torch.float32),
    (16, 8, 1408, 2048, 0.2, torch.bfloat16, torch.bfloat16),
    (4, 300, 512, 352, 0.8, torch.bfloat16, torch.float32),
    (4, 300, 512, 352, 0.8, torch.float32, torch.bfloat16),
]
# kernel vs plain version, max |got - want| / max(|want|, 1): f32 sums of d
# products in another order (d <= 512 in f32: at d = 2048 the order alone
# moves a sum by ~1.4e-5); bf16 inputs or output round to bf16 (the
# tolerances of tests/test_kernels.py)
MOE_GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def moe_gemm_tol(dtype: torch.dtype, out_dtype: torch.dtype) -> float:
    """The tolerance of a case: bf16's where inputs or output are bf16."""
    return max(MOE_GEMM_TOL[dtype], MOE_GEMM_TOL[out_dtype])


def grouped_gemm_ref(xin: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """xin: (E, C, d); w: (E, d, f); valid: (E, C) bool -> (E, C, f).

    ``where(valid, xin, 0) @ w`` per expert, summed in f32 and cast to
    ``out_dtype`` (default: xin's dtype)."""
    x = torch.where(valid[..., None], xin, torch.zeros((), dtype=xin.dtype,
                                                       device=xin.device))
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return out.to(out_dtype or xin.dtype)


def random_moe_inputs(rng: np.random.Generator, *, e: int, c: int, d: int,
                      f: int, valid_share: float,
                      dtype: torch.dtype = torch.float32):
    """Numpy-seeded CPU tensors xin (E, C, d), w (E, d, f) (std 0.1) and
    valid (E, C) bool with about ``valid_share`` of the rows valid; a
    negative share keeps ``|valid_share|`` valid and empties expert 0."""
    xin = rng.standard_normal((e, c, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32) * np.float32(0.1)
    valid = rng.random((e, c)) < abs(valid_share)
    if valid_share < 0:
        valid[0] = False
    return (torch.from_numpy(xin).to(dtype), torch.from_numpy(w).to(dtype),
            torch.from_numpy(valid))
