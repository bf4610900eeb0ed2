"""RG-LRU recurrent block of Griffin / RecurrentGemma (port of
``repro.models.rglru``).

Block:  x -> {linear -> causal conv1d(width) -> RG-LRU} * {linear -> GeLU}
-> linear, where the RG-LRU is

    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    log a_t = -c * r_t * softplus(Λ)  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``w_a``, ``w_x`` and ``lam`` are f32 in a model of any dtype, and the
recurrence runs in f32, as in the JAX package. Training and prefill
evaluate the linear recurrence with ``rglru_scan``: the JAX package uses
``lax.associative_scan``, which torch lacks, so this is a Hillis-Steele
scan in plain ops, ceil(log2 T) out-of-place doubling passes over
``(a, b)`` with the same combine ``(a1 a2, a2 b1 + b2)``, which autograd
differentiates. Its f32 sums associate in another order than XLA's. A
cumulative sum of ``log a`` would need ``exp(-log a)`` over the whole
sequence, which overflows, so it is not used. Decode is one step; the
depthwise causal conv keeps a (width-1)-token state for it.

The functions return new states; the transformer's decode step copies them
into its cache buffers (``models.transformer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init

_C = 8.0


def init_rglru_block(generator: torch.Generator, d_model: int, r_dim: int,
                     conv_width: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    def w(shape, dt=dtype, scale=None):
        return dense_init(generator, shape, dt, device, scale)

    return {
        "w_in_x": w((d_model, r_dim)),
        "w_in_gate": w((d_model, r_dim)),
        "w_out": w((r_dim, d_model)),
        "conv_w": w((conv_width, r_dim), scale=0.5),
        "conv_b": torch.zeros((r_dim,), dtype=dtype, device=device),
        "w_a": w((r_dim, r_dim), torch.float32),
        "w_x": w((r_dim, r_dim), torch.float32),
        # Λ so that a ~ U(0.9, 0.999)-ish at r = 0.5 (Griffin appendix)
        "lam": torch.linspace(2.0, 5.0, r_dim, dtype=torch.float32,
                              device=device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, T, r); w: (W, r); state: (B, W-1, r).
    Returns (out (B, T, r), new state (B, W-1, r))."""
    width = w.shape[0]
    pad = state if state is not None else torch.zeros(
        (x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[width - 1 - i]
              for i in range(width)) + b
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return out, new_state


def _rglru_gates(p, x):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, in f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"])
    i = torch.sigmoid(xf @ p["w_x"])
    log_a = -_C * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * xf


def rglru_scan(p, x, h0):
    """x: (B, T, r); h0: (B, r) -> (h (B, T, r) f32, h_last (B, r)). The
    linear recurrence h_t = a_t h_{t-1} + b_t as a log-depth scan."""
    a, b = _rglru_gates(p, x)
    # the carried-in state enters through the first element
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], 1)
    t, d = x.shape[1], 1
    while d < t:
        # element t takes combine(element t - d, element t)
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1))
        d *= 2
    return b, b[:, -1]


def rglru_step(p, x, h):
    """x: (B, r) one token; h: (B, r) -> (h_new, h_new) in f32."""
    a, b = _rglru_gates(p, x[:, None])
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new, h_new


def apply_rglru_block(p, x, state):
    """x: (B, T, d); state: {"h": (B, r) f32, "conv": (B, W-1, r)}.
    Returns (out (B, T, d), new state)."""
    u = x @ p["w_in_x"]
    gate = F.gelu(x @ p["w_in_gate"], approximate="tanh")
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    y, h_last = rglru_scan(p, u, state["h"])
    out = (y.to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}


def apply_rglru_block_decode(p, x, state):
    """x: (B, 1, d). Returns (out (B, 1, d), new state)."""
    u = x @ p["w_in_x"]
    gate = F.gelu(x @ p["w_in_gate"], approximate="tanh")
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    y, h_last = rglru_step(p, u[:, 0], state["h"])
    out = (y[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}
