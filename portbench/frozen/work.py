"""Operations and bytes of the kernels and model steps the benchmark reads
against the H100's peaks (frozen from the port's ``launch/roofline`` work
functions, counted from shapes and from the benchmark's own rulebooks, never
from the program's tables).

A roofline bound is the larger of operations over the peak rate and bytes
over the memory rate; each input byte is counted read once and each output
byte written once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.frozen import peaks


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    peak: float

    def __add__(self, other: "Work") -> "Work":
        if other.peak != self.peak:
            raise ValueError("work at two peaks does not add")
        return Work(self.flops + other.flops, self.bytes + other.bytes,
                    self.peak)

    def bound_s(self) -> float:
        """Least seconds the card could take."""
        return max(self.flops / self.peak, self.bytes / peaks.HBM_BYTES_PER_S)


def sspnna_conv_work(pairs: int, rows_in: int, rows_out: int, c: int,
                     n: int, kernel_volume: int = 27) -> Work:
    """One fused gather-GEMM-scatter conv of f32 features over a rulebook of
    ``pairs`` (output row, input row) pairs: 2*C*N FLOPs a pair at the
    3xTF32 rate; the input rows, the weights and one 4-byte index a pair
    read once, the output rows written once."""
    flops = 2.0 * pairs * c * n
    nbytes = 4.0 * (rows_in * c + kernel_volume * c * n + pairs
                    + rows_out * n)
    return Work(flops, nbytes, peaks.F32_3XTF32_FLOPS)


def mask_pairs(sq: int, skv: int, *, causal: bool,
               window: int | None = None) -> int:
    """(query, key) pairs a causal or window mask keeps, queries at the end
    of the keys (``launch/roofline.mask_pairs``)."""
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q_pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = (np.maximum(q_pos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
               causal: bool, elem_bytes: int = 2,
               window: int | None = None) -> Work:
    """Flash attention forward (``launch/roofline.flash_work``): 4*D FLOPs a
    kept (q, k) pair and query head at the bf16 peak; Q, K, V read once and
    O written once."""
    pairs = mask_pairs(sq, skv, causal=causal, window=window)
    flops = 4.0 * d * pairs * b * hq
    nbytes = float(elem_bytes * (2 * b * sq * hq * d + 2 * b * skv * hkv * d))
    return Work(flops, nbytes, peaks.BF16_FLOPS)


def decoder_matmul_params(layers: int, d: int, heads: int, kv_heads: int,
                          head_dim: int, d_ff: int, vocab: int) -> int:
    """Weights a token multiplies through: each layer's q, k, v, o and the
    three SwiGLU projections, and the output head (the embedding lookup is
    no product)."""
    attn = d * head_dim * (2 * heads + 2 * kv_heads)
    return layers * (attn + 3 * d * d_ff) + d * vocab


def decoder_request_flops(matmul_params: int, layers: int, heads: int,
                          head_dim: int, prompt: int, generated: int) -> float:
    """Model FLOPs of one request without padding: 2 a weight for each token
    that runs through the model (the prompt's, then each generated token
    but the last), and 4*H*D a layer for each (query, earlier or same key)
    pair among those tokens."""
    tokens = prompt + max(generated - 1, 0)
    pairs = tokens * (tokens + 1) // 2
    return 2.0 * matmul_params * tokens + 4.0 * layers * heads * head_dim * pairs
