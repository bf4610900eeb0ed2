"""Error-feedback int8 gradient compression (port of
``repro.training.grad_compress``).

Across pods, the data-parallel gradient reduction rides the slowest links;
int8 with one f32 scale a block of ``BLOCK`` values cuts those bytes 4x
against f32 (2x against bf16), and feeding the quantization error into the
next step keeps the training's quality (Seide et al. 2014-style EF). The
round trip is computed where the reduction would run, so one process
reproduces its numerics exactly. Both packages round half to even and
divide in IEEE f32, so the round trip equals the JAX one bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.training.tree import tree_leaves, tree_map, unzip

BLOCK = 256


def _quantize_int8(x: torch.Tensor):
    """Per-block symmetric int8 -> (q int8 (n_blocks, BLOCK), scales f32
    (n_blocks, 1))."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).reshape(-1, BLOCK)
    # divisors as tensors on x's device: a Python-float divisor would make
    # CUDA multiply by its reciprocal, which is not this division
    scale = blocks.abs().amax(1, keepdim=True) / torch.full(
        (), 127.0, device=x.device)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1)
    return x[:math.prod(shape)].reshape(shape)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_decompress(grads, error_state):
    """The EF-int8 round trip: g' = Q(g + e); e' = (g + e) - g'.
    -> (g' tree in f32, e' tree)."""
    def one(g, e):
        x = g.float() + e
        q, s = _quantize_int8(x)
        deq = _dequantize(q, s, g.shape)
        return deq, x - deq

    return unzip(tree_map(one, grads, error_state), 2)


def compression_ratio(params, from_dtype_bytes: int = 2) -> float:
    """Wire-bytes ratio of the compressed reduction (int8 + scales)."""
    total = sum(p.numel() for p in tree_leaves(params))
    comp = total * 1 + (total // BLOCK + 1) * 4
    return (total * from_dtype_bytes) / comp
