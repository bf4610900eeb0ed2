"""GQA attention: the train mode's chunked online softmax, the prefill
through the flash kernel, and cached decode (port of
``repro.models.attention``).

* ``chunked_attention`` keeps the JAX signature and serves the prefill
  (``mode="prefill"``): it goes through
  ``kernels.flash.ops.flash_attention_bshd`` (the hand-written CUDA kernel
  on the card, its plain version on the CPU), which computes the same
  function as the JAX package's chunked online softmax. The kernel is
  forward-only.
* ``chunked_softmax_attention`` is the train mode's (``mode="train"``): a
  plain PyTorch port of the JAX function, chunk for chunk, which autograd
  differentiates. The JAX package trains through its ``jnp`` loop, not
  through its Pallas kernel, and has no backward kernel; so the port's
  train mode launches no kernel either. It keeps ``p`` in the accumulation
  dtype, where the flash kernels (TPU and CUDA) round it to v's dtype.
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

from repro_torch.kernels.abstract import (
    any_dtensor,
    redistribute_for,
    sharded_call,
)
from repro_torch.kernels.flash.flash import SHARD_DIMS as FLASH_SHARD_DIMS
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
    """Flash attention, the prefill's; O(Sq*(window|Skv)) compute, no
    (Sq, Skv) scores. Forward-only: ``mode="train"`` runs
    ``chunked_softmax_attention`` instead, as the JAX package trains
    through its ``jnp`` loop and not through its kernel.

    The kernel tiles the sequence itself, so ``q_chunk``/``kv_chunk`` only
    keep the JAX signature. It places the queries at the end of the kv
    sequence, so where a causal or window mask reads the positions,
    ``q_offset`` must be ``Skv - Sq`` (0 for a prefill); without a mask
    the positions change nothing and any offset is taken (the decoder's
    cross attention, Sq != Skv at offset 0). It accumulates in f32, the
    only ``acc_dtype`` it takes. ``DTensor`` inputs (the dry run's) are
    first redistributed to placements the kernel takes (batch and heads
    shards; a partial sum or any other shard reduced or gathered).
    """
    del q_chunk, kv_chunk
    sq, skv = q.shape[1], k.shape[1]
    if (causal or window is not None) and q_offset != skv - sq:
        raise ValueError(f"q_offset {q_offset}: the flash kernel places the "
                         f"{sq} queries at the end of {skv} keys")
    if str(acc_dtype).removeprefix("torch.") != "float32":
        raise ValueError(f"acc_dtype {acc_dtype}: the flash kernel "
                         "accumulates in float32")
    qkv = redistribute_for({"q": q, "k": k, "v": v}, FLASH_SHARD_DIMS)
    return flash_attention_bshd(**qkv, causal=causal, window=window,
                                softcap=logit_cap)


def _chunk_attend(q, k, v, q_pos, k_pos, causal, window, cap, acc_dtype):
    """One (q-chunk, kv-chunk) tile -> (unnormalised output, row max, row
    sum), as the JAX package's ``_chunk_attend``: q (B, Cq, Hkv, G, D), k/v
    (B, Ckv, Hkv, D); scores and ``p`` in ``acc_dtype``, the statistics
    and the PV product's result in f32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(acc_dtype), k.to(acc_dtype))
    # sqrt(d) in the scores' dtype on their device (see decode_attention)
    s = s / torch.full((), float(q.shape[-1]), device=s.device).sqrt().to(
        s.dtype)
    s = _softcap(s, cap)
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))
    m = s.amax(-1).float()
    p = torch.exp(s.float() - m[..., None]).to(acc_dtype)
    p = torch.where(mask, p, torch.zeros((), dtype=acc_dtype, device=p.device))
    l = p.float().sum(-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.float(), v.float())
    return o, m, l


def chunked_softmax_attention(
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
    """The train mode's attention: the JAX package's ``chunked_attention``
    in plain PyTorch ops, under autograd. Query chunks of ``q_chunk`` rows
    run one after the other; each takes its kv chunks with a running f32
    (max, sum, acc), or, for a local layer whose window leaves most of the
    sequence out, the one kv span the window reaches. A kv chunk that the
    masks hide from every query of the chunk is skipped: it would add
    exact zeros. ``DTensor`` inputs (the dry run's) run on each rank's
    shard of batch rows and heads, as ``decode_attention`` does: the
    chunk products fold batch and heads into one dim, which ``DTensor``
    does not propagate when both are sharded."""
    if any_dtensor(q, k, v):
        kw = dict(causal=causal, window=window, logit_cap=logit_cap,
                  q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk,
                  acc_dtype=acc_dtype)
        return sharded_call(chunked_softmax_attention, "train_attention",
                            redistribute_for({"q": q, "k": k, "v": v},
                                             FLASH_SHARD_DIMS),
                            FLASH_SHARD_DIMS, FLASH_SHARD_DIMS["q"], **kw)
    acc_dtype = getattr(torch, str(acc_dtype).removeprefix("torch."))
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks {q_chunk}/{kv_chunk} do not divide the "
                         f"lengths {sq}/{skv}")
    local = window is not None and window + q_chunk < skv
    if local:  # only the kv span [q_start - window, q_end) can be unmasked
        span = -(-(window + q_chunk) // kv_chunk) * kv_chunk
    outs = []
    for q_start in range(0, sq, q_chunk):
        q_lo = q_offset + q_start
        q_pos = q_lo + torch.arange(q_chunk, device=q.device)
        qc = qg[:, q_start:q_start + q_chunk]
        if local:
            k_start = min(max(q_lo + q_chunk - span, 0), skv - span)
            k_pos = k_start + torch.arange(span, device=q.device)
            o, _, l = _chunk_attend(
                qc, k[:, k_start:k_start + span], v[:, k_start:k_start + span],
                q_pos, k_pos, True, window, logit_cap, acc_dtype)
            outs.append(o / l[..., None].clamp(min=1e-30))
            continue
        m_run = l_run = acc = None
        for k_start in range(0, skv, kv_chunk):
            k_end = k_start + kv_chunk
            if ((causal and k_start > q_lo + q_chunk - 1)
                    or (window is not None and k_end - 1 <= q_lo - window)):
                continue
            o, m, l = _chunk_attend(
                qc, k[:, k_start:k_end], v[:, k_start:k_end], q_pos,
                k_start + torch.arange(kv_chunk, device=q.device), causal,
                window, logit_cap, acc_dtype)
            if m_run is None:
                m_run, l_run, acc = m, l, o
                continue
            m_new = torch.maximum(m_run, m)
            a, bcoef = torch.exp(m_run - m_new), torch.exp(m - m_new)
            l_run = l_run * a + l * bcoef
            acc = acc * a[..., None] + o * bcoef[..., None]
            m_run = m_new
        outs.append(acc / l_run[..., None].clamp(min=1e-30))
    out = torch.cat(outs, dim=3)                      # (B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


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


_DECODE_SHARD_DIMS = {"q": FLASH_SHARD_DIMS["q"],
                      "cache_k": FLASH_SHARD_DIMS["k"],
                      "cache_v": FLASH_SHARD_DIMS["v"]}


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
    """One query position over the cache -> (B, 1, Hq, D) in q's dtype.
    ``DTensor`` inputs (the dry run's) run on each rank's shard of batch
    rows and heads, as the flash kernel does: the einsums below fold batch
    and heads into one product dim, which ``DTensor`` cannot propagate
    when both are sharded."""
    if any_dtensor(q, cache_k, cache_v):
        args = redistribute_for({"q": q, "cache_k": cache_k,
                                 "cache_v": cache_v}, _DECODE_SHARD_DIMS)
        return sharded_call(decode_attention, "decode_attention", args,
                            _DECODE_SHARD_DIMS, FLASH_SHARD_DIMS["q"], t=t,
                            ring=ring, window=window, logit_cap=logit_cap)
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
