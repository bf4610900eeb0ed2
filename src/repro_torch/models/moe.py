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

``dispatch="a2a"`` is the expert-parallel process form over the ``"model"``
dim of a ``DeviceMesh`` (the JAX package's ``expert_all_to_all`` path):
each rank holds G/S token groups, the whole router and E/S experts' rows of
``w_gate``, ``w_up`` and ``w_down`` (``expert_shard`` cuts them). It
routes its own groups, exchanges the gathered tokens expert-major
(``dist.expert_all_to_all``: ``(G/S, E, cap, d)`` -> ``(G, E/S, cap,
d)``), runs the three products on its experts' rows ``(E/S, G*cap, d)``,
which reach the kernel in the gather path's ``g*cap + s`` order, exchanges
the results back and combines its own tokens. The auxiliaries are reduced
over the mesh dim, so they are the JAX call's averages over every group;
their gradient on a rank is that rank's own groups' share.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.moe_spade import build_dispatch
from repro_torch.dist.collectives import expert_all_to_all, process_group
from repro_torch.dist.hints import DP, constrain
from repro_torch.kernels.abstract import (
    any_dtensor,
    redistribute_for,
    sharded_call,
)
from repro_torch.kernels.moe_gemm.moe_gemm import SHARD_DIMS as GEMM_SHARD_DIMS
from repro_torch.kernels.moe_gemm.ops import grouped_gemm
from repro_torch.models.common import dense_init

DISPATCH_MODES = ("gather", "a2a")
# a DTensor combine's inputs: each shards its groups (dim 0) only
_GROUP_DIMS = {"h": {0: "groups"}, "idx": {0: "groups"},
               "slot": {0: "groups"}, "gates": {0: "groups"}}


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
    result as one plain batched product. ``DTensor`` inputs (the dry
    run's) go to the kernel on placements it takes (experts and rows
    shards; the rest gathered)."""
    if not train:
        args = redistribute_for({"xin": xin, "w": w, "valid": valid},
                                GEMM_SHARD_DIMS)
        return grouped_gemm(**args, out_dtype=out_dtype)
    x = torch.where(valid[..., None], xin, torch.zeros((), dtype=xin.dtype,
                                                       device=xin.device))
    return torch.bmm(x.float(), w.float()).to(out_dtype)


def expert_shard(params: dict, x: torch.Tensor, rank: int,
                 size: int) -> tuple[dict, torch.Tensor]:
    """Rank ``rank`` of ``size``'s part of a full MoE layer and its input
    for ``dispatch="a2a"``: the router whole, the expert rows ``[rank*E/S,
    (rank+1)*E/S)`` of the expert weights, and the token groups ``[rank*G/S,
    (rank+1)*G/S)`` of ``x`` (G, Tg, d). G or E not divisible raises."""
    g, e = x.shape[0], params["router"].shape[1]
    if g % size or e % size:
        raise ValueError(f"{g} groups and {e} experts must split over "
                         f"{size} ranks")
    ge, gg = e // size, g // size
    part = {k: v if k == "router" else v[rank * ge:(rank + 1) * ge]
            for k, v in params.items()}
    return part, x[rank * gg:(rank + 1) * gg]


def _route(params: dict, x: torch.Tensor, top_k: int, capacity: int):
    """Router logits and probabilities, the renormalized top-k gates and
    experts, and the per-group dispatch (slot (G, Tg, k), table (G, E,
    cap))."""
    n_experts = params["router"].shape[1]
    # one product per group, batched: a group's logits do not depend on how
    # many groups share the call (cuBLAS picks its kernel for one (G*Tg, d)
    # product by G*Tg), so an a2a rank routes its groups to the same bits
    # as the gather does
    router = params["router"].expand(x.shape[0], -1, -1)
    logits = torch.bmm(x.float(), router)                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)          # (G, Tg, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    slot, table = build_dispatch(idx, n_experts, capacity)
    return logits, probs, gates, idx, slot, table


def _experts(params: dict, xin, valid, act: str, dtype, train: bool):
    """The three expert products on rows ``xin`` (E, C, d) with ``valid``
    (E, C) -> h (E, C, d) in ``dtype``."""
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
    return product(inner.to(dtype), params["w_down"], dtype)


def _combine(rows, lin, slot, gates, dtype):
    """Per assignment j, token t of group g reads row ``lin[g, t, j]`` of
    ``rows`` (n, d); dropped assignments read zeros."""
    picked = rows[lin]                                     # (G, Tg, k, d)
    picked = torch.where((slot >= 0)[..., None], picked,
                         torch.zeros((), dtype=rows.dtype, device=rows.device))
    return torch.einsum("gtkd,gtk->gtd", picked.float(),
                        gates.float()).to(dtype)


def _aux(logits, probs, idx, slot, n_experts: int) -> dict:
    """Switch auxiliaries: load-balance and router z-loss, the dropped
    share and the load of each expert."""
    me = probs.mean(1)                                     # (G, E)
    onehot = F.one_hot(idx[..., 0], n_experts).float()
    ce = onehot.mean(1)
    return {"moe_lb_loss": n_experts * (me * ce).sum(-1).mean(),
            "moe_z_loss": torch.logsumexp(logits, -1).square().mean(),
            "moe_dropped": (slot < 0).float().mean(),
            "expert_load": onehot.sum((0, 1))}


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int, capacity: int,
              act: str, mesh=None, dispatch: str = "gather",
              train: bool = False):
    """x: (G, Tg, d) -> (out (G, Tg, d), aux dict).

    G = token groups, Tg tokens per group. Each group's dispatch is local
    to it: a token competes for capacity only with its own group's tokens.
    ``dispatch="a2a"`` runs the expert-parallel process form over
    ``mesh``'s ``"model"`` dim (module docstring): ``x`` is this rank's G/S
    groups and ``params`` its E/S experts (``expert_shard``); E must
    divide over the dim. ``train`` computes the expert products with plain
    ops under autograd instead of the forward-only kernel.
    """
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch {dispatch!r} not one of {DISPATCH_MODES}")
    if dispatch == "a2a":
        if mesh is None:
            raise ValueError("dispatch='a2a' needs a mesh with a 'model' axis")
        return _apply_moe_a2a(params, x, top_k, capacity, act,
                              process_group(mesh, "model"), train)
    g, tg, d = x.shape
    n_experts = params["router"].shape[1]
    logits, probs, gates, idx, slot, table = _route(params, x, top_k,
                                                    capacity)
    # table (G, E, cap) -> expert-major rows (E, G*cap): row g*cap + s of
    # expert e holds group g's token table[g, e, s]
    table = table.transpose(0, 1)                          # (E, G, cap)
    valid = (table >= 0).reshape(n_experts, g * capacity)
    rows = (table.clamp(min=0)
            + torch.arange(g, device=x.device)[None, :, None] * tg)
    xin = x.reshape(g * tg, d)[rows.reshape(n_experts, g * capacity)]
    # the JAX hint (DP over groups, experts over "model") on these rows
    xin = constrain(xin, "model", DP, None)
    h = constrain(_experts(params, xin, valid, act, x.dtype, train),
                  "model", DP, None)
    del xin
    if any_dtensor(h):
        # a DTensor (the dry run's): each rank combines its own groups from
        # their rows of every expert, group-major (the other experts' rows
        # gathered), since a gather by global row has no sharding rule
        h = h.view(n_experts, g, capacity, d).transpose(0, 1)
        args = redistribute_for({"h": h, "idx": idx, "slot": slot,
                                 "gates": gates}, _GROUP_DIMS)
        out = sharded_call(_combine_groups, "moe_combine", args, _GROUP_DIMS,
                           {0: "groups"}, dtype=x.dtype)
        return out, _aux(logits, probs, idx, slot, n_experts)
    # token t of group g, assignment j: row g*cap + slot of expert idx
    lin = (idx * (g * capacity) + slot.clamp(min=0)
           + torch.arange(g, device=x.device)[:, None, None] * capacity)
    out = _combine(h.reshape(n_experts * g * capacity, d), lin, slot, gates,
                   x.dtype)
    return out, _aux(logits, probs, idx, slot, n_experts)


def _combine_groups(h, idx, slot, gates, dtype):
    """``_combine`` on group-major rows ``h`` (G, E, cap, d): token t of
    group g, assignment j, reads row (g, idx, slot)."""
    g, n_experts, capacity, d = h.shape
    lin = (idx * capacity + slot.clamp(min=0)
           + torch.arange(g, device=h.device)[:, None, None]
           * (n_experts * capacity))
    return _combine(h.reshape(g * n_experts * capacity, d), lin, slot, gates,
                    dtype)


def _apply_moe_a2a(params, x, top_k, capacity, act, group, train):
    size = dist.get_world_size(group)
    gl, tg, d = x.shape
    n_experts = params["router"].shape[1]
    e_local = params["w_up"].shape[0]
    if n_experts % size or e_local != n_experts // size:
        raise ValueError(
            f"dispatch='a2a' over {size} ranks needs E={n_experts} to divide "
            f"and this rank's {n_experts // size} experts, got {e_local} "
            "(models.moe.expert_shard cuts them)")
    logits, probs, gates, idx, slot, table = _route(params, x, top_k,
                                                    capacity)
    rows = (table.clamp(min=0)
            + torch.arange(gl, device=x.device)[:, None, None] * tg)
    xin = x.reshape(gl * tg, d)[rows]                      # (G/S, E, cap, d)
    # expert-major: every group's tokens for this rank's experts, group
    # j*G/S + i from rank j's group i
    xin = expert_all_to_all(group, xin, split_axis=1, concat_axis=0)
    valid = expert_all_to_all(group, (table >= 0).to(torch.uint8),
                              split_axis=1, concat_axis=0).bool()
    g = gl * size
    xin = xin.transpose(0, 1).reshape(e_local, g * capacity, d)
    valid = valid.transpose(0, 1).reshape(e_local, g * capacity)
    h = _experts(params, xin, valid, act, x.dtype, train)
    del xin
    h = h.view(e_local, g, capacity, d).transpose(0, 1)    # (G, E/S, cap, d)
    h = expert_all_to_all(group, h, split_axis=0, concat_axis=1)
    # token t of local group g, assignment j: row (g, idx, slot)
    lin = (idx * capacity + slot.clamp(min=0)
           + torch.arange(gl, device=x.device)[:, None, None]
           * (n_experts * capacity))
    out = _combine(h.reshape(gl * n_experts * capacity, d), lin, slot,
                   gates, x.dtype)
    aux = _aux(logits, probs, idx, slot, n_experts)
    if size > 1:
        # every group's average (equal group counts) and load sum: the
        # value is the mesh dim's, the gradient this rank's own share
        names = ("moe_lb_loss", "moe_z_loss", "moe_dropped")
        local = torch.cat([torch.stack([aux[k] for k in names]),
                           aux["expert_load"]])
        total = local.detach().clone()
        dist.all_reduce(total, group=group)
        total[:len(names)] /= size
        total = local + (total - local.detach())
        aux = dict(zip(names, total[:len(names)]),
                   expert_load=total[len(names):])
    return out, aux
