"""Optimizers, functional: AdamW and Adafactor (port of
``repro.training.optimizer``).

* AdamW: moments in ``moment_dtype`` (bf16 moments halve the optimizer's
  memory).
* Adafactor: a factored second moment (row and column means) for leaves
  whose last two dims both reach ``min_dim_factored``, no first moment.

Params, grads and states are trees of tensors (``training.tree``: nested
dicts and lists); a state mirrors the params. An update returns new trees
and leaves its inputs as they were, under ``torch.no_grad()``. The math is
the JAX package's, line for line: the clip by the global norm happens
inside the update, bias correction counts ``step + 1``, weight decay
applies to leaves of rank 2 or more only, and Adafactor clips each leaf's
update at RMS 1. ``torch.optim.AdamW`` is another function (it decays
every leaf and does not clip), so it is not used.

An update's ``ranks`` (a tree of ints, default each leaf's own rank) says
which rank the weight decay reads for each leaf: the LM train step passes
the ranks the leaves have in the JAX package's layout, which stacks the
layers and so decays their norms too (``training.train_loop``). For the
same reason both updates take ``groups`` (a tree of keys, default
``None`` everywhere): leaves with one key form one JAX leaf, the stack of
a cycle position's layers, and Adafactor's update clip takes the RMS over
all of them; a leaf whose key is ``None`` stands alone. AdamW's update is
elementwise and reads no groups.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.training.tree import tree_leaves, tree_map, unzip


@dataclass(frozen=True)
class OptHParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    min_dim_factored: int = 128   # adafactor: factor axes >= this


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim)."""
    with torch.no_grad():
        return torch.sqrt(sum(x.float().square().sum()
                              for x in tree_leaves(tree)))


def _clip_scale(grads, max_norm: float):
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """(grads in f32 scaled to a global norm of at most ``max_norm``, the
    global norm before)."""
    scale, gn = _clip_scale(grads, max_norm)
    with torch.no_grad():
        return tree_map(lambda g: g.float() * scale, grads), gn


def _ranks(params, ranks):
    return ranks if ranks is not None else tree_map(lambda p: p.dim(), params)


def _t(step) -> torch.Tensor:
    """``step + 1`` as f32, where ``step`` counts the updates made."""
    return (torch.as_tensor(step) + 1).float()


# -------------------------------- AdamW -----------------------------------

def adamw_init(params, hp: OptHParams) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=hp.moment_dtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(params, grads, state, step, hp: OptHParams, ranks=None,
                 groups=None):
    """-> (new params, new state, {"grad_norm"}). AdamW's update is
    elementwise, so ``groups`` changes nothing here."""
    scale, gn = _clip_scale(grads, hp.grad_clip)
    t = _t(step)
    c1 = 1.0 - hp.b1 ** t
    c2 = 1.0 - hp.b2 ** t

    def upd(p, g, m, v, rank):
        g32 = g.float() * scale
        m32 = hp.b1 * m.float() + (1 - hp.b1) * g32
        v32 = hp.b2 * v.float() + (1 - hp.b2) * torch.square(g32)
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + hp.eps)
        if rank >= 2:
            u = u + hp.weight_decay * p.float()
        return ((p.float() - hp.lr * u).to(p.dtype),
                m32.to(hp.moment_dtype), v32.to(hp.moment_dtype))

    new_p, new_m, new_v = unzip(
        tree_map(upd, params, grads, state["m"], state["v"],
                 _ranks(params, ranks)), 3)
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gn}


# ------------------------------ Adafactor ---------------------------------

def _factored(p, hp: OptHParams) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= hp.min_dim_factored
            and p.shape[-2] >= hp.min_dim_factored)


def adafactor_init(params, hp: OptHParams) -> dict:
    def one(p):
        if _factored(p, hp):
            return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, device=p.device)}

    return {"v": tree_map(one, params)}


@torch.no_grad()
def adafactor_update(params, grads, state, step, hp: OptHParams,
                     ranks=None, groups=None):
    """-> (new params, new state, {"grad_norm"})."""
    scale, gn = _clip_scale(grads, hp.grad_clip)
    beta2 = 1.0 - _t(step) ** -0.8

    def scaled(p, g, v):
        """The unclipped update and the new second moment."""
        g32 = g.float() * scale
        g2 = torch.square(g32) + 1e-30
        if _factored(p, hp):
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
            denom = vr.mean(-1, keepdim=True)
            rms = (vr[..., None] / torch.clamp(denom[..., None], min=1e-30)
                   ) * vc[..., None, :]
            u = g32 * torch.rsqrt(torch.clamp(rms, min=1e-30))
            nv = {"vr": vr, "vc": vc}
        else:
            vf = beta2 * v["v"] + (1 - beta2) * g2
            u = g32 * torch.rsqrt(torch.clamp(vf, min=1e-30))
            nv = {"v": vf}
        return u, nv

    # state["v"] holds a small dict at each param leaf: params' structure
    # is a prefix of it, so tree_map passes the dict whole
    us, new_v = unzip(tree_map(scaled, params, grads, state["v"]), 2)
    if groups is None:
        groups = tree_map(lambda _: None, params)
    # a group's mean square: its squares summed over all its leaves
    sums: dict = {}
    for u, key in zip(tree_leaves(us), tree_leaves(groups), strict=True):
        if key is not None:
            sq, n = sums.get(key, (0.0, 0))
            sums[key] = (sq + torch.square(u).sum(), n + u.numel())

    def upd(p, u, key, rank):
        # update clipping (Adafactor d=1.0), over the leaf or its group
        if key is None:
            ms = torch.square(u).mean()
        else:
            sq, n = sums[key]
            ms = sq / n
        u = u / torch.clamp(torch.sqrt(ms + 1e-30), min=1.0)
        if rank >= 2:
            u = u + hp.weight_decay * p.float()
        return (p.float() - hp.lr * u).to(p.dtype)

    new_p = tree_map(upd, params, us, groups, _ranks(params, ranks))
    return new_p, {"v": new_v}, {"grad_norm": gn}


def make_optimizer(name: str, hp: OptHParams):
    """-> (init, update) for ``"adamw"`` or ``"adafactor"``."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
