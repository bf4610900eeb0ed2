"""The grouped expert GEMM and its plain version (port of
``repro.kernels.moe_gemm.ops``)."""
from __future__ import annotations

from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

__all__ = ["grouped_gemm", "grouped_gemm_ref"]
