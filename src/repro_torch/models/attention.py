"""GQA attention: prefill through the flash kernel + cached decode (port of
``repro.models.attention``).

* ``chunked_attention`` keeps the JAX signature; in the port the prefill
  goes through ``kernels.flash.ops.flash_attention_bshd`` (the hand-written
  CUDA kernel on the card, its plain version on the CPU), which computes
  the same function as the JAX package's chunked online softmax.
* decode: a single-token query against a ring (local) or linear (global)
  cache; scores are (B, H, S_cache), computed in one shot with plain
  PyTorch ops, as the JAX package leaves decode to XLA.
* Caches are updated in place (``cache_update_decode``), where the JAX
  package returns new arrays: each cache has one owner, and this keeps one
  copy of it in device memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash.ops import flash_attention_bshd
from repro_torch.models.common import softcap as _softcap

NEG_INF = -1e30


def chunked_attention(
    q: torch.Tensor,             # (B, Sq, Hq, D)
    k: torch.Tensor,             # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    acc_dtype: str | torch.dtype = torch.float32,
) -> torch.Tensor:
    """Flash attention; O(Sq*(window|Skv)) compute, no (Sq, Skv) scores.

    The kernel tiles the sequence itself, so ``q_chunk``/``kv_chunk`` only
    keep the JAX signature. It places the queries at the end of the kv
    sequence, so ``q_offset`` must be ``Skv - Sq`` (0 for a prefill), and it
    accumulates in f32, the only ``acc_dtype`` it takes.
    """
    del q_chunk, kv_chunk
    sq, skv = q.shape[1], k.shape[1]
    if q_offset != skv - sq:
        raise ValueError(f"q_offset {q_offset}: the flash kernel places the "
                         f"{sq} queries at the end of {skv} keys")
    if str(acc_dtype).removeprefix("torch.") != "float32":
        raise ValueError(f"acc_dtype {acc_dtype}: the flash kernel "
                         "accumulates in float32")
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                softcap=logit_cap)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer stack of caches. ``k``/``v``: (L, B, S_buf, Hkv, D);
    for local layers S_buf == window (ring addressing)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def buf_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(n_layers, batch, buf_len, n_kv, head_dim, dtype, *,
                  device) -> KVCache:
    shape = (n_layers, batch, buf_len, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_update_decode(cache_k, cache_v, k_new, v_new, t: int, ring: bool):
    """Write one token (k_new/v_new: (B, 1, Hkv, D)) at position t (ring:
    slot t % buf) into the (B, S_buf, Hkv, D) caches, in place; returns
    them."""
    buf = cache_k.shape[1]
    slot = (t % buf) if ring else t
    if not 0 <= slot < buf:
        raise IndexError(f"position {t} is past the {buf}-slot cache")
    cache_k[:, slot:slot + 1] = k_new
    cache_v[:, slot:slot + 1] = v_new
    return cache_k, cache_v


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D)
    cache_k: torch.Tensor,  # (B, S_buf, Hkv, D) — already includes token t
    cache_v: torch.Tensor,
    t: int,                 # current position (token t is at slot t or t%buf)
    *,
    ring: bool,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    b, sbuf, hkv, d = cache_k.shape
    hq = q.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, d)
    # f32 products of the cache's dtype, as the JAX einsum's f32 result
    s = torch.einsum("bhgd,bkhd->bhgk", qg[:, 0].float(), cache_k.float())
    # sqrt(d) in f32 on s's device, filled there (no host copy): a
    # Python-float divisor would make CUDA multiply by its reciprocal,
    # which is not bit-equal to this division at D = 128
    s = s / torch.full((), float(d), device=s.device).sqrt()
    s = _softcap(s, logit_cap)
    slots = torch.arange(sbuf, device=q.device)
    # ring: slot holds position t - ((t - slot) mod buf); valid if >= 0
    pos = t - ((t - slots) % sbuf) if ring else slots
    valid = (pos >= 0) & (pos <= t)
    if window is not None:
        valid &= pos > t - window
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)
