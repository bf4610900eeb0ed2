"""Decoder LM: prefill/train forward and cached decode (port of
``repro.models.transformer``: ``GLOBAL`` and ``LOCAL`` attention layers
with a dense or MoE feed-forward, ``RWKV`` layers (time mix and channel
mix, ``models.rwkv6``) and ``RGLRU`` layers (the recurrent block and an
MLP, ``models.rglru``).

Parameters are a plain dict of tensors: ``embed``, ``final_norm``,
``lm_head`` (untied configs only), ``encoder`` (encoder-decoder configs
only) and ``layers``, one dict per layer:
``ln1``, the mixer (``attn`` {``wq``, ``wk``, ``wv``, ``wo``}, ``tm`` or
``rec``), ``ln2``, and the feed-forward (``mlp``; ``moe`` every
``moe_layer_period``-th layer of an MoE config; ``cm``, the channel mix,
in an RWKV layer). The JAX package stacks layers per cycle of
``attn_pattern`` and scans them; the port loops over layers in Python, and
``params_from_jax`` un-stacks a JAX tree into this list.

Two modes share one layer: ``forward`` (``mode="train"`` or ``"prefill"``,
which also emits the per-layer cache) and ``decode_step`` (one token
against the cache). A cache is ``{"layers": [...], "pos": t}`` with one
flat dict of tensors a layer: ``{"k", "v"}`` (B, S_buf, Hkv, D) for an
attention layer, ``{"s", "x_tm", "x_cm"}`` for an RWKV layer (the wkv
state (B, H, D, D) f32 and the last inputs of the time and channel mix,
(B, d)) and ``{"h", "conv"}`` for an RG-LRU layer (the recurrence (B, r)
f32 and the conv's last width-1 inputs (B, W-1, r)). The JAX package nests
the same tensors as ``{"attn": {"k", "v"}}``, ``{"rwkv": {"s", "x_tm"},
"rwkv_cm": {"x_cm"}}`` and ``{"rec": {"h", "conv"}}``. ``decode_step``
writes every layer's new state into these tensors in place (``copy_``),
so a CUDA graph of a step that reads and writes one cache's buffers
advances it on every replay (``serving.engine``). The mode picks the code:

* ``"prefill"`` and decode serve: prefill attention goes through the flash
  kernel (``models.attention.chunked_attention``), and the MoE layers'
  expert products of both through the grouped expert GEMM
  (``models.moe``). Both kernels are forward-only. The recurrences are
  plain ops in both packages (no Pallas kernel).
* ``"train"`` is differentiable, as the JAX package's train mode is: that
  mode runs no Pallas kernel (its attention is a ``jnp`` loop, its expert
  products ``jnp.einsum``), and the JAX package has no backward kernel. So
  the port's train mode runs the same plain ops under autograd
  (``models.attention.chunked_softmax_attention``, ``apply_moe(train=True)``)
  and launches no kernel; with ``cfg.remat`` each layer is recomputed in
  the backward pass (``torch.utils.checkpoint``), as the JAX package
  wraps its layers in ``jax.checkpoint``.

An encoder-decoder config (``cfg.is_encdec``) has ``params["encoder"] =
{"layers": [...], "final_norm"}``, global attention layers without a cross
block that ``forward`` runs over ``enc_frames`` (B, S_src, d) with no
causal mask, and each decoder layer has ``ln_cross`` and ``cross`` (the
four attention projections), run between the mixer and the feed-forward
against the encoder's output. A prefill keeps the cross keys and values
as ``{"ck", "cv"}`` (B, S_src, Hkv, D) in the layer's flat cache dict,
which decode reads and never writes. A vision config (``cfg.frontend ==
"vision"``) takes ``frontend_embeds`` (B, P, d), which replace the first
P token embeddings.

``lm_loss`` is the next-token cross-entropy the trainer minimises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import GLOBAL, LOCAL, RGLRU, RWKV, ModelConfig
from repro_torch.device import require_device
from repro_torch.dist.hints import DP, constrain
from repro_torch.models.attention import (
    cache_update_decode,
    chunked_attention,
    chunked_softmax_attention,
    decode_attention,
)
from repro_torch.models.common import apply_rope, dense_init, rms_norm, softcap
from repro_torch.models.mlp import apply_mlp, apply_rwkv_channel_mix, init_mlp
from repro_torch.models.moe import apply_moe, init_moe, moe_capacity
from repro_torch.models.rglru import (
    apply_rglru_block,
    apply_rglru_block_decode,
    init_rglru_block,
)
from repro_torch.models.rwkv6 import (
    apply_time_mix,
    apply_time_mix_decode,
    init_time_mix,
)

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, *, device: str | torch.device = "cuda",
            generator: torch.Generator | None = None) -> dict:
    """Random parameters: ``dense_init`` normals drawn from ``generator``
    (seed 0 on the CPU when omitted; a generator on the card draws there,
    which a full-size model needs), norms at 1."""
    dev = require_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dt, d, hd = cfg.torch_dtype, cfg.d_model, cfg.head_dim

    def w(shape, scale=None):
        return dense_init(g, shape, dt, dev, scale)

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    params = {"embed": w((cfg.vocab_padded, d), 0.02), "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = w((d, cfg.vocab_padded))

    def attn():
        return {"wq": w((d, cfg.n_heads * hd)),
                "wk": w((d, cfg.n_kv_heads * hd)),
                "wv": w((d, cfg.n_kv_heads * hd)),
                "wo": w((cfg.n_heads * hd, d))}

    def layer(i, kind, cross):
        p = {"ln1": ones()}
        if kind == RWKV:
            p["tm"] = init_time_mix(g, d, cfg.n_heads, cfg.rwkv_head_dim, dt,
                                    dev)
        elif kind == RGLRU:
            p["rec"] = init_rglru_block(g, d, cfg.rglru_dim or d,
                                        cfg.conv1d_width, dt, dev)
        elif kind in (GLOBAL, LOCAL):
            p["attn"] = attn()
        else:
            raise ValueError(kind)
        if cross:
            p["ln_cross"], p["cross"] = ones(), attn()
        p["ln2"] = ones()
        if kind == RWKV:
            p["cm"] = init_mlp(g, d, cfg.d_ff, "rwkv_cm", dt, dev)
        else:
            p.update(_init_ffn(g, cfg, i, dt, dev))
        return p

    params["layers"] = [layer(i, cfg.layer_kind(i), cfg.is_encdec)
                        for i in range(cfg.n_layers)]
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [layer(i, GLOBAL, False)
                       for i in range(cfg.encoder_layers)],
            "final_norm": ones()}
    return params


def _init_ffn(g, cfg: ModelConfig, i: int, dt, dev) -> dict:
    if cfg.is_moe and i % cfg.moe.moe_layer_period == 0:
        return {"moe": init_moe(g, cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                                cfg.act, dt, dev)}
    return {"mlp": init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dt, dev)}


def _tensor(x, device: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly
        return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(device)


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> dict:
    """The JAX package's ``init_lm`` tree (numpy leaves) as the port's
    parameters: ``tree["cycles"][j]`` stacks layer ``i*len(pattern)+j`` at
    index ``i``, and ``tree["rem"]`` holds the layers after the last full
    cycle (RecurrentGemma's 38 layers: 12 cycles of 3, then 2). Every leaf
    keeps its dtype: an MoE router, the RG-LRU's ``w_a``, ``w_x`` and
    ``lam``, and the RWKV time mix's ``w0``, LoRA, ``u`` and ``ln_x`` stay
    f32 in a bf16 model. An encoder-decoder tree's ``encoder`` stacks all
    its layers in ``cycles[0]`` (``rem`` is empty), and its decoder layers
    carry ``ln_cross`` and ``cross``. The JAX package's decode caches nest a
    layer's tensors one level deeper than the port's flat layer dicts
    (module docstring); their tensors are the same."""
    dev = require_device(device)

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        return _tensor(node if index is None else np.asarray(node)[index], dev)

    cycle = len(cfg.attn_pattern)
    n_cycles = cfg.n_layers // cycle
    layers = [conv(tree["cycles"][j], i)
              for i in range(n_cycles) for j in range(cycle)]
    layers += [conv(lp) for lp in tree["rem"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    params = {k: _tensor(tree[k], dev) for k in ("embed", "final_norm")}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(tree["lm_head"], dev)
    params["layers"] = layers
    if cfg.is_encdec:
        enc = tree["encoder"]
        stack = enc["cycles"][0]
        params["encoder"] = {
            "layers": [conv(stack, i) for i in range(cfg.encoder_layers)]
                      + [conv(lp) for lp in enc["rem"]],
            "final_norm": _tensor(enc["final_norm"], dev)}
    return params


# ---------------------------------------------------------------------------
# Layer application (shared by all modes)
# ---------------------------------------------------------------------------

def _attn_qkv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attention(p, x, cfg: ModelConfig, kind: str, mode: str, cache,
                    pos: int, cache_pad: int, causal: bool = True):
    b, s, _ = x.shape
    window = cfg.window if kind == LOCAL else None
    new_cache = None
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = _attn_qkv(p, x, cfg, positions)
        ring = kind == LOCAL
        ck, cv = cache_update_decode(cache["k"], cache["v"],
                                     k.to(cache["k"].dtype),
                                     v.to(cache["v"].dtype), pos, ring)
        o = decode_attention(q, ck, cv, pos, ring=ring, window=window,
                             logit_cap=cfg.attn_softcap)
        new_cache = cache  # written in place (with any cross keys in it)
    else:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q, k, v = _attn_qkv(p, x, cfg, positions)
        if mode == "train":  # the JAX train mode's jnp loop, differentiable
            o = chunked_softmax_attention(
                q, k, v, causal=causal, window=window,
                logit_cap=cfg.attn_softcap, q_chunk=min(512, s),
                kv_chunk=min(512, s), acc_dtype=cfg.attn_dtype)
        else:
            o = chunked_attention(q, k, v, causal=causal, window=window,
                                  logit_cap=cfg.attn_softcap,
                                  acc_dtype=cfg.attn_dtype)
        if mode == "prefill":
            if kind == LOCAL and s >= cfg.window:
                # ring addressing: position p lives at slot p % window
                shift = (s - cfg.window) % cfg.window
                new_cache = {"k": torch.roll(k[:, -cfg.window:], shift, 1),
                             "v": torch.roll(v[:, -cfg.window:], shift, 1)}
            else:
                pad = (0, 0, 0, 0, 0, cache_pad)
                new_cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    return o.reshape(b, o.shape[1], -1) @ p["wo"], new_cache


def _cross_attention(p, x, enc_out, cfg: ModelConfig, mode: str, cache):
    """Attention of the decoder's positions over the encoder's output ->
    (out, new cache): no RoPE, no softcap, no mask. Train and prefill
    project k and v from ``enc_out`` (B, S_src, d); a prefill keeps them
    as ``{"ck", "cv"}``. Decode reads ``ck``/``cv`` from the layer's cache
    and writes nothing."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    new_cache = None
    if mode == "decode":
        k, v = cache["ck"], cache["cv"]
        o = decode_attention(q, k, v, k.shape[1] - 1, ring=False, window=None)
    else:
        se = enc_out.shape[1]
        k = (enc_out @ p["wk"]).reshape(b, se, cfg.n_kv_heads, hd)
        v = (enc_out @ p["wv"]).reshape(b, se, cfg.n_kv_heads, hd)
        attend = (chunked_softmax_attention if mode == "train"
                  else chunked_attention)
        o = attend(q, k, v, causal=False, q_chunk=min(512, s),
                   kv_chunk=min(512, se))
        if mode == "prefill":
            new_cache = {"ck": k, "cv": v}
    return o.reshape(b, s, -1) @ p["wo"], new_cache


def _cross_block(p, x, cfg: ModelConfig, mode: str, cache, enc_out,
                 new_cache):
    """The decoder layer's cross block (norm, cross attention, residual),
    where the layer has one and there is an encoder output (train,
    prefill) or a cross cache (decode) -> (x, new cache with ``ck``/``cv``
    merged in)."""
    if "cross" not in p or (enc_out is None
                            and (cache is None or "ck" not in cache)):
        return x, new_cache
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    o, cross = _cross_attention(p["cross"], h, enc_out, cfg, mode, cache)
    if cross is not None:
        new_cache = dict(new_cache or {}, **cross)
    return x + o, new_cache


def _ffn(p, x, cfg: ModelConfig, moe_groups: int | None, train: bool):
    """Feed-forward -> (y, aux); an MoE layer routes ``b*s`` tokens in
    ``moe_groups`` groups (default: one group per batch row), its expert
    products on the kernel unless ``train``."""
    if "moe" in p:
        b, s, d = x.shape
        g = moe_groups or b
        xg = x.reshape(g, (b * s) // g, d)
        cap = moe_capacity((b * s) // g, cfg.moe.top_k, cfg.moe.n_experts,
                           cfg.moe.capacity_factor)
        y, aux = apply_moe(p["moe"], xg, top_k=cfg.moe.top_k, capacity=cap,
                           act=cfg.act, train=train)
        return y.reshape(b, s, d), aux
    return apply_mlp(p["mlp"], x, cfg.act), {}


def _write_state(cache: dict, **new) -> dict:
    """A decode step's new recurrent state, copied into the layer's cache
    buffers (once every new value is computed): a CUDA graph of the step
    then advances the buffers it replays on."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _rwkv_layer(p, x, h, cfg: ModelConfig, mode: str, cache, enc_out):
    """An RWKV layer after its first norm ``h``: the time mix, (a cross
    block,) then the channel mix, each with its token shift -> (x, new
    cache, aux)."""
    if mode == "decode":
        o, (x_tm, s) = apply_time_mix_decode(p["tm"], h, cache["x_tm"],
                                             cache["s"], n_heads=cfg.n_heads)
    else:
        b, hd = h.shape[0], cfg.rwkv_head_dim
        s0 = torch.zeros((b, cfg.n_heads, hd, hd), dtype=torch.float32,
                         device=h.device)
        o, (x_tm, s) = apply_time_mix(p["tm"], h, torch.zeros_like(h[:, 0]),
                                      s0, n_heads=cfg.n_heads)
    x, cross = _cross_block(p, x + o, cfg, mode, cache, enc_out, None)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "decode":
        y = apply_rwkv_channel_mix(p["cm"], h, cache["x_cm"][:, None])
        new_cache = _write_state(cache, s=s, x_tm=x_tm, x_cm=h[:, 0])
    else:
        shifted = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        y = apply_rwkv_channel_mix(p["cm"], h, shifted)
        new_cache = ({"s": s, "x_tm": x_tm.clone(), "x_cm": h[:, -1].clone(),
                      **(cross or {})}
                     if mode == "prefill" else None)
    return x + y, new_cache, {}


def _rglru(p, h, cfg: ModelConfig, mode: str, cache):
    """The RG-LRU block -> (out, new cache)."""
    if mode == "decode":
        o, new = apply_rglru_block_decode(p, h, cache)
        return o, _write_state(cache, **new)
    b, r = h.shape[0], cfg.rglru_dim or cfg.d_model
    state = {"h": torch.zeros((b, r), dtype=torch.float32, device=h.device),
             "conv": torch.zeros((b, cfg.conv1d_width - 1, r),
                                 dtype=cfg.torch_dtype, device=h.device)}
    o, new = apply_rglru_block(p, h, state)
    if mode != "prefill":
        return o, None
    return o, {"h": new["h"].clone(), "conv": new["conv"].clone()}


def apply_layer(p, x, kind: str, cfg: ModelConfig, mode: str, cache=None,
                pos: int = 0, cache_pad: int = 0,
                moe_groups: int | None = None, enc_out=None,
                causal: bool = True):
    """Returns (x, new_cache, aux). In decode the new cache is ``cache``,
    its tensors advanced in place. ``mode="encode"`` is a prefill that
    emits no cache (the encoder's layers outside training)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == RWKV:
        return _rwkv_layer(p, x, h, cfg, mode, cache, enc_out)
    if kind == RGLRU:
        o, new_cache = _rglru(p["rec"], h, cfg, mode, cache)
    elif kind in (GLOBAL, LOCAL):
        o, new_cache = _self_attention(p["attn"], h, cfg, kind, mode, cache,
                                       pos, cache_pad, causal)
    else:
        raise ValueError(kind)
    x, new_cache = _cross_block(p, x + o, cfg, mode, cache, enc_out,
                                new_cache)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p, h, cfg, moe_groups, mode == "train")
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens, frontend_embeds=None):
    """Token embeddings (scaled by sqrt(d) where the config says so); a
    vision config's ``frontend_embeds`` (B, P, d) then replace the first
    P positions, cast to the embeddings' dtype. P > S raises, as the JAX
    package's ``dynamic_update_slice`` refuses it."""
    x = params["embed"][tokens.long()]
    sp = ("model" if cfg.attn_sharding == "sequence" and tokens.shape[1] > 1
          else None)
    x = constrain(x, DP, sp, None)
    if cfg.scale_embeddings:  # sqrt(d) in f32, cast to the working dtype
        # a 0-dim CPU tensor: read on the host at launch, no device copy
        scale = torch.tensor(np.sqrt(np.float32(cfg.d_model))).to(x.dtype)
        x = x * scale
    if cfg.frontend == "vision" and frontend_embeds is not None:
        n = frontend_embeds.shape[1]
        if n > x.shape[1]:
            raise ValueError(f"{n} frontend embeddings do not fit "
                             f"{x.shape[1]} positions")
        fe = torch.as_tensor(frontend_embeds, device=x.device).to(x.dtype)
        x = torch.cat([fe, x[:, n:]], dim=1)
    return x


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(constrain((x @ head).float(), DP, None, "model"),
                     cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# what ``remat_policy="dots"`` keeps from the forward pass, as
# ``jax.checkpoint_policies.checkpoint_dots`` keeps the dot products
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, layer):
    """``layer`` recomputed in the backward pass (``cfg.remat``): all of it
    under ``remat_policy="full"``, all but the matmul outputs under
    ``"dots"``."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is not 'full' "
                         "or 'dots'")
    return functools.partial(checkpoint, layer, use_reentrant=False, **kw)


def _run_encoder(params, cfg: ModelConfig, frames, mode: str):
    """frames (B, S_src, d) -> the encoder's output (B, S_src, d): the
    frames cast to the working dtype, the encoder's layers without a causal
    mask, its final norm. It follows the outer ``mode``: plain ops under
    autograd in ``"train"`` (remat per layer under ``cfg.remat``), the
    flash kernel in a prefill; it emits no cache."""
    enc = params["encoder"]
    x = torch.as_tensor(frames, device=enc["final_norm"].device).to(
        cfg.torch_dtype)
    layer = functools.partial(apply_layer, causal=False)
    if cfg.remat and mode == "train":
        layer = _remat(cfg, layer)
    for lp in enc["layers"]:
        x, _, _ = layer(lp, x, GLOBAL, cfg,
                        "train" if mode == "train" else "encode")
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, frontend_embeds=None,
            enc_frames=None, mode: str = "train",
            moe_groups: int | None = None, cache_pad: int = 0,
            last_only: bool = False):
    """tokens: (B, S) -> (logits (B, S, Vp) f32, cache or None, aux).

    ``aux`` sums the MoE layers' auxiliaries (``models.moe.apply_moe``)
    over the layers; it is empty for a dense model. ``last_only`` applies
    the head to the last position only (logits (B, 1, Vp)): what a prefill
    needs, without the (B, S, Vp) f32 array. ``mode="train"`` runs plain
    ops that autograd differentiates (remat per layer under ``cfg.remat``);
    ``"prefill"`` runs the kernels and emits the cache. A vision config
    takes ``frontend_embeds`` (B, P, d); an encoder-decoder config needs
    ``enc_frames`` (B, S_src, d), the encoder's input.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r} is not 'train' or 'prefill'")
    x = _embed(params, cfg, tokens, frontend_embeds)
    enc_out = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "enc_frames (B, S_src, d)")
        enc_out = _run_encoder(params, cfg, enc_frames, mode)
    caches = []
    aux_sum: dict = {}
    layer = functools.partial(apply_layer, cache_pad=cache_pad,
                              moe_groups=moe_groups, enc_out=enc_out)
    if cfg.remat and mode == "train":
        layer = _remat(cfg, layer)
    for i, lp in enumerate(params["layers"]):
        x, c, aux = layer(lp, x, cfg.layer_kind(i), cfg, mode)
        caches.append(c)
        for k, v in aux.items():
            aux_sum[k] = aux_sum[k] + v if k in aux_sum else v
    if last_only:
        x = x[:, -1:]
    logits = _logits(params, cfg, x)
    cache = None
    if mode == "prefill":
        cache = {"layers": caches, "pos": tokens.shape[1]}
    return logits, cache, aux_sum


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      src_len: int = 0, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed cache for ``cache_len`` positions (local layers keep at most
    ``window`` slots; recurrent layers keep their state, whatever the
    length); an encoder-decoder's layers also hold the cross keys and
    values of ``src_len`` source positions."""
    dev = require_device(device)
    dt = cfg.torch_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == RWKV:
            hd = cfg.rwkv_head_dim
            layers.append({"s": zeros(batch, cfg.n_heads, hd, hd,
                                      dtype=torch.float32),
                           "x_tm": zeros(batch, cfg.d_model),
                           "x_cm": zeros(batch, cfg.d_model)})
        elif kind == RGLRU:
            r = cfg.rglru_dim or cfg.d_model
            layers.append({"h": zeros(batch, r, dtype=torch.float32),
                           "conv": zeros(batch, cfg.conv1d_width - 1, r)})
        else:
            buf = min(cfg.window, cache_len) if kind == LOCAL else cache_len
            shape = (batch, buf, cfg.n_kv_heads, cfg.head_dim)
            layers.append({"k": zeros(*shape), "v": zeros(*shape)})
        if cfg.is_encdec:
            shape = (batch, src_len, cfg.n_kv_heads, cfg.head_dim)
            layers[-1].update(ck=zeros(*shape), cv=zeros(*shape))
    return {"layers": layers, "pos": cache_len}


def decode_step(params, cfg: ModelConfig, token, cache: dict, *,
                moe_groups: int | None = None):
    """token: (B, 1) -> (logits (B, 1, Vp), cache advanced by one position;
    every layer's buffers (KV and recurrent state) are updated in
    place)."""
    x = _embed(params, cfg, token)
    pos = cache["pos"]
    layers = []
    for i, lp in enumerate(params["layers"]):
        x, c, _ = apply_layer(lp, x, cfg.layer_kind(i), cfg, "decode",
                              cache=cache["layers"][i], pos=pos,
                              moe_groups=moe_groups)
        layers.append(c)
    return _logits(params, cfg, x), {"layers": layers, "pos": pos + 1}


def lm_loss(logits, targets, cfg: ModelConfig, mask=None):
    """Next-token cross-entropy over the real vocab: logits (B, S, Vp) f32,
    targets (B, S) ints, mask (B, S) optional -> the masked mean.

    The JAX package's: a max-shifted logsumexp, the target's logit, and the
    mean over the mask (at least 1). A gather picks the target's logit
    where the JAX package contracts with a one-hot (a vocab-sharding
    choice): the same value without a second (B, S, V) array.
    """
    del cfg  # the padded vocab's logits are already -1e30
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    ll = tgt - lse
    mask = (torch.ones_like(ll) if mask is None
            else torch.as_tensor(mask, device=ll.device).float())
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)
