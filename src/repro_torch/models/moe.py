"""Mixture-of-Experts layer with COIR-style dispatch (port of
``repro.models.moe``, group-local ``"gather"`` dispatch).

Tokens are organized in groups (the batch rows, or ``moe_groups``); each
group routes its tokens top-k over E experts and gathers them into an
``(E, cap)`` dispatch table per group (``core.moe_spade.build_dispatch``).
The JAX package computes the three expert products with ``jnp.einsum``;
each of them is exactly the grouped expert GEMM's function
(``kernels/moe_gemm``: ``where(valid, x, 0) @ w[e]`` with f32 sums), so the
port's prefill and decode run them through that kernel, one launch per
product with the groups folded into the kernel's rows: ``(E, G*cap, d)``.
The kernel is forward-only, so ``train=True`` (the transformer's
``mode="train"``) computes the same products as the JAX package does, as
plain batched products of the masked rows in f32 (bf16 operands widened
exactly), which autograd differentiates.

As in the JAX package, the gate and up products keep their f32 result
(the kernel stores f32 there), SwiGLU/GeGLU run in f32, and the down
product takes the activation cast to x's dtype and stores x's dtype.

The expert-major exchange (``dispatch="a2a"``) needs ``torch.distributed``
and waits for ROADMAP.md's slice 11.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.moe_spade import build_dispatch
from repro_torch.kernels.moe_gemm.ops import grouped_gemm
from repro_torch.models.common import dense_init

DISPATCH_MODES = ("gather", "a2a")


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, act: str, dtype: torch.dtype,
             device: torch.device) -> dict:
    """Router in f32, stacked expert weights ``(E, d_in, d_out)`` in
    ``dtype`` (``dense_init``'s std over the leading axis, as the JAX
    package draws them); ``gelu`` has no ``w_gate``."""
    def w(shape, dt=dtype):
        return dense_init(generator, shape, dt, device)

    p = {"router": w((d_model, n_experts), torch.float32)}
    if act != "gelu":
        p["w_gate"] = w((n_experts, d_model, d_ff))
    p["w_up"] = w((n_experts, d_model, d_ff))
    p["w_down"] = w((n_experts, d_ff, d_model))
    return p


def moe_capacity(tokens_per_group: int, top_k: int, n_experts: int,
                 capacity_factor: float, round_to: int = 4) -> int:
    cap = int(tokens_per_group * top_k * capacity_factor / n_experts) + 1
    return max((cap + round_to - 1) // round_to * round_to, round_to)


def _expert_product(xin, w, valid, out_dtype, train: bool):
    """``where(valid, xin, 0) @ w[e]`` per expert with f32 sums: the
    kernel, or under ``train`` the JAX package's ``jnp.einsum`` with an f32
    result as one plain batched product."""
    if not train:
        return grouped_gemm(xin, w, valid, out_dtype=out_dtype)
    x = torch.where(valid[..., None], xin, torch.zeros((), dtype=xin.dtype,
                                                       device=xin.device))
    return torch.bmm(x.float(), w.float()).to(out_dtype)


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int, capacity: int,
              act: str, dispatch: str = "gather", train: bool = False):
    """x: (G, Tg, d) -> (out (G, Tg, d), aux dict).

    G = token groups, Tg tokens per group. Each group's dispatch is local
    to it: a token competes for capacity only with its own group's tokens.
    ``train`` computes the expert products with plain ops under autograd
    instead of the forward-only kernel.
    """
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch {dispatch!r} not one of {DISPATCH_MODES}")
    if dispatch == "a2a":
        raise NotImplementedError(
            "dispatch='a2a' (the expert-major all-to-all over a mesh) comes "
            "with the distribution slice (ROADMAP.md, queue 1, slice 11)")
    g, tg, d = x.shape
    n_experts = params["router"].shape[1]
    logits = x.float() @ params["router"]                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)          # (G, Tg, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    slot, table = build_dispatch(idx, n_experts, capacity)
    # slot: (G, Tg, k); table: (G, E, cap) -> expert-major rows (E, G*cap):
    # row g*cap + s of expert e holds group g's token table[g, e, s]
    table = table.transpose(0, 1)                          # (E, G, cap)
    valid = (table >= 0).reshape(n_experts, g * capacity)
    rows = (table.clamp(min=0)
            + torch.arange(g, device=x.device)[None, :, None] * tg)
    xin = x.reshape(g * tg, d)[rows.reshape(n_experts, g * capacity)]

    # jax.nn.gelu defaults to the tanh approximation
    def product(xs, w, out_dtype):
        return _expert_product(xs, w, valid, out_dtype, train)

    if act in ("swiglu", "geglu"):
        a = product(xin, params["w_gate"], torch.float32)
        b = product(xin, params["w_up"], torch.float32)
        inner = (F.silu(a) if act == "swiglu"
                 else F.gelu(a, approximate="tanh")).mul_(b)
        del a, b
    else:
        inner = F.gelu(product(xin, params["w_up"], torch.float32),
                       approximate="tanh")
    h = product(inner.to(x.dtype), params["w_down"], x.dtype)
    del inner

    # Combine: per assignment j, token t of group g reads row
    # g*cap + slot[g, t, j] of expert idx[g, t, j].
    lin = (idx * (g * capacity) + slot.clamp(min=0)
           + torch.arange(g, device=x.device)[:, None, None] * capacity)
    picked = h.reshape(n_experts * g * capacity, d)[lin]   # (G, Tg, k, d)
    picked = torch.where((slot >= 0)[..., None], picked,
                         torch.zeros((), dtype=h.dtype, device=x.device))
    out = torch.einsum("gtkd,gtk->gtd", picked.float(),
                       gates.float()).to(x.dtype)

    # aux losses (Switch): load-balance + router z-loss
    me = probs.mean(1)                                     # (G, E)
    onehot = F.one_hot(idx[..., 0], n_experts).float()
    ce = onehot.mean(1)
    aux = {"moe_lb_loss": n_experts * (me * ce).sum(-1).mean(),
           "moe_z_loss": torch.logsumexp(logits, -1).square().mean(),
           "moe_dropped": (slot < 0).float().mean(),
           "expert_load": onehot.sum((0, 1))}
    return out, aux
