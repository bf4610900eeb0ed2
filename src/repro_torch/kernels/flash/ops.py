"""Model-layout flash attention (port of ``repro.kernels.flash.ops``).

The JAX wrapper folds GQA by repeating k and v per query-head group into
the kernel's ``(B*H, S, D)`` layout. The CUDA kernel takes the model layout
and indexes the kv head of each query head itself, so here the wrapper
only names the entry the model calls.
"""
from __future__ import annotations

from repro_torch.kernels.flash.flash import flash_attention


def flash_attention_bshd(q, k, v, *, causal=True, window=None, softcap=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query head h reads kv head ``h // (Hq // Hkv)``, as the JAX package's
    group-wise repeat does.
    """
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)
