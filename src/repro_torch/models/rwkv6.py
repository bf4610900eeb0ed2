"""RWKV-6 (Finch) time mix with data-dependent decay, as chunked linear
attention (port of ``repro.models.rwkv6``).

Recurrence per head (state S in R^{D x D}):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with a per-(token, channel) decay w_t = exp(-exp(w0 + lora(x mix))) and a
per-head bonus u. Training and prefill use the chunked form: within a chunk
of L tokens the pairwise decay exponents la_{t-1} - la_s (s <= t-1) are
<= 0, so the direct masked computation is stable; across chunks an f32
state is carried, here by a Python loop over the chunks where the JAX
package runs ``lax.scan``. Decode is the one-step recurrence.

``chunked_wkv`` builds a ``(B, H, L, L, D)`` f32 decay block per chunk
(268 MB at B=4, H=64, L=64, D=64), which autograd keeps for every chunk:
train with ``cfg.remat``. ``w0``, the decay LoRA, ``u`` and ``ln_x`` are f32
in a model of any dtype, and the casts are the JAX package's.

The functions return new states; the transformer's decode step copies them
into its cache buffers (``models.transformer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_time_mix(generator: torch.Generator, d_model: int, n_heads: int,
                  head_dim: int, dtype: torch.dtype, device: torch.device,
                  lora_rank: int = 64) -> dict:
    hd = n_heads * head_dim

    def w(shape, dt=dtype, scale=None):
        return dense_init(generator, shape, dt, device, scale)

    def full(shape, value, dt=torch.float32):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "w_r": w((d_model, hd)),
        "w_k": w((d_model, hd)),
        "w_v": w((d_model, hd)),
        "w_g": w((d_model, hd)),
        "w_o": w((hd, d_model)),
        "mu": full((5, d_model), 0.0, dtype),   # r, k, v, g, w shift mixes
        "w0": full((hd,), -1.0),
        "w_lora_a": w((d_model, lora_rank), torch.float32),
        "w_lora_b": w((lora_rank, hd), torch.float32, 0.1),
        "u": full((n_heads, head_dim), 0.0),    # bonus
        "ln_x_scale": full((hd,), 1.0),
        "ln_x_bias": full((hd,), 0.0),
    }


def _group_norm_heads(x, scale, bias, n_heads: int, eps: float = 64e-5):
    """Per-head LayerNorm of the wkv output (RWKV's ln_x), in f32."""
    b, t, hd = x.shape
    xh = x.reshape(b, t, n_heads, hd // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(b, t, hd)
    return y * scale + bias


def chunked_wkv(r, k, v, logw, u, s0, chunk: int):
    """r, k, v, logw: (B, T, H, D); u: (H, D); s0: (B, H, D, D).

    Returns (o (B, T, H, D) f32, final state (B, H, D, D) f32); logw =
    log(decay) <= 0. ``chunk`` must divide T.
    """
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide the {t} tokens")
    nc = t // chunk

    def to_chunks(x):   # (nc, B, H, L, D)
        return x.float().reshape(b, nc, chunk, h, d).permute(1, 0, 3, 2, 4)

    r_, k_, v_, lw = (to_chunks(x) for x in (r, k, v, logw))
    la = torch.cumsum(lw, dim=3)        # inclusive within the chunk
    lap = la - lw                       # la_{t-1} (exclusive)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)   # s < t
    s = s0.float()
    outs = []
    for c in range(nc):
        rc, kc, vc, lac, lapc = r_[c], k_[c], v_[c], la[c], lap[c]
        # across chunks: o += (r * exp(la_{t-1})) @ S
        o = torch.einsum("bhld,bhde->bhle", rc * torch.exp(lapc), s)
        # within the chunk, strictly lower scores (exponent <= 0: stable)
        expo = torch.exp(lapc[:, :, :, None, :] - lac[:, :, None, :, :])
        # sum_d r_td k_sd expo_tsd, as products and one reduction (an
        # einsum of the three runs a slow batched matrix-vector kernel)
        score = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * expo).sum(-1)
        score = torch.where(tri, score, torch.zeros((), device=r.device))
        o = o + torch.einsum("bhts,bhse->bhte", score, vc)
        # the diagonal's bonus term
        dscore = torch.einsum("bhtd,bhtd->bht", rc * u[None, :, None, :], kc)
        o = o + dscore[..., None] * vc
        # S' = diag(exp(la_L)) S + sum_s (k_s * exp(la_L - la_s)) v_s^T
        la_l = lac[:, :, -1:, :]
        kd = kc * torch.exp(la_l - lac)
        s = torch.exp(la_l.squeeze(2))[..., None] * s + torch.einsum(
            "bhsd,bhse->bhde", kd, vc)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, t, h, d)
    return o, s


def wkv_decode_step(r, k, v, logw, u, s):
    """One token. r, k, v, logw: (B, H, D); s: (B, H, D, D) f32 -> (o (B, H,
    D) f32, new state)."""
    r, k, v, logw = (x.float() for x in (r, k, v, logw))
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    o = torch.einsum("bhd,bhde->bhe", r, s + u[None, :, :, None] * kv)
    s_new = torch.exp(logw)[..., None] * s + kv
    return o, s_new


def _mix_and_project(params, xs, shifted, n_heads: int):
    """The five token-shift mixes and their projections: r, k, v (..., H,
    D), the gate g and the log decay (..., H, D) f32."""
    mu = params["mu"]
    xr, xk, xv, xg, xw = (xs + (shifted - xs) * mu[i] for i in range(5))
    head_dim = params["w_r"].shape[1] // n_heads
    lead = xs.shape[:-1]
    r, k, v = ((xm @ params[name]).reshape(*lead, n_heads, head_dim)
               for xm, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(xg @ params["w_g"])
    # the data-dependent decay (RWKV-6): log w in (-inf, 0)
    w_raw = params["w0"] + torch.tanh(
        xw.float() @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = -torch.exp(w_raw).reshape(*lead, n_heads, head_dim)
    return r, k, v, g, logw


def apply_time_mix(params, x, x_prev, s0, *, n_heads: int, chunk: int = 64):
    """x: (B, T, d); x_prev: (B, d), the token before the window (zeros at
    t=0); s0: (B, H, D, D). Returns (out (B, T, d), (last x (B, d), final
    state)). T must be a multiple of ``min(chunk, T)``."""
    b, t, _ = x.shape
    hd = params["w_r"].shape[1]
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    r, k, v, g, logw = _mix_and_project(params, x, shifted, n_heads)
    o, s_fin = chunked_wkv(r, k, v, logw, params["u"], s0, min(chunk, t))
    o = _group_norm_heads(o.reshape(b, t, hd), params["ln_x_scale"],
                          params["ln_x_bias"], n_heads)
    out = (o * g.float()).to(x.dtype) @ params["w_o"]
    return out, (x[:, -1], s_fin)


def apply_time_mix_decode(params, x, x_prev, s, *, n_heads: int):
    """x: (B, 1, d), one token. Returns (out (B, 1, d), (x (B, d), new
    state))."""
    b = x.shape[0]
    hd = params["w_r"].shape[1]
    xt = x[:, 0]
    r, k, v, g, logw = _mix_and_project(params, xt, x_prev, n_heads)
    o, s_new = wkv_decode_step(r, k, v, logw, params["u"], s)
    o = _group_norm_heads(o.reshape(b, 1, hd), params["ln_x_scale"],
                          params["ln_x_bias"], n_heads)
    out = (o * g[:, None].float()).to(x.dtype) @ params["w_o"]
    return out, (xt, s_new)
