"""GPipe-style stage-stacked pipeline execution over a "pipe" mesh axis
(port of ``repro.dist.pipeline``).

``stack_stages`` stacks per-stage parameter trees along a new leading axis;
``pipeline_apply`` runs the classic GPipe schedule over the ranks of the
pipe axis, rank ``s`` running stage ``s``: microbatch m occupies stage s at
step t = s + m, so n_micro microbatches drain through n_stages stages in
n_micro + n_stages - 1 steps, each hand-off a point-to-point send to the
next rank (the JAX package's ``ppermute``).

On a 1-wide pipe axis the schedule collapses to a serial loop over
microbatches: no collectives, any output shape. With 2+ stages the stage
function must preserve shape and dtype (activations hand off between
identical stage bodies); that is checked on the meta device before any
rank sends, so every rank raises alike.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.hints import mesh_axes
from repro_torch.training.tree import tree_leaves, tree_map


def stack_stages(stages):
    """Stack a list of per-stage param trees along a new leading axis."""
    if not stages:
        raise ValueError("stack_stages needs at least one stage")
    return tree_map(lambda *xs: torch.stack(xs), stages[0], *stages[1:])


def _stage(stacked, i: int):
    return tree_map(lambda a: a[i], stacked)


def pipeline_apply(mesh, stage_fn, stage_params, x: torch.Tensor, *,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` (n_micro, micro_batch, ...) through the stacked stages.

    ``stage_fn(params, microbatch) -> microbatch`` is one stage body;
    ``stage_params`` comes from ``stack_stages`` and must have exactly as
    many stages as the ``axis`` dim of ``mesh``; this rank runs the stage
    of its index on that dim. Returns the (n_micro, ...) outputs of the
    last stage on every rank (broadcast from the last one, as the JAX
    package's ``psum`` replicates them).
    """
    axes = mesh_axes(mesh)
    if axis not in axes:
        raise ValueError(f"axis {axis!r} not in mesh axes {tuple(axes)}")
    n_stages = axes[axis]
    n_stacked = tree_leaves(stage_params)[0].shape[0]
    if n_stacked != n_stages:
        raise ValueError(
            f"{n_stacked} stacked stages vs {n_stages}-wide {axis!r} axis")
    n_micro = x.shape[0]

    if n_stages == 1:
        params = _stage(stage_params, 0)
        return torch.stack([stage_fn(params, x[m]) for m in range(n_micro)])

    out = stage_fn(
        tree_map(lambda a: torch.empty(a.shape[1:], dtype=a.dtype,
                                       device="meta"), stage_params),
        torch.empty(x.shape[1:], dtype=x.dtype, device="meta"))
    if out.shape != x.shape[1:] or out.dtype != x.dtype:
        raise ValueError(
            f"multi-stage pipelines need shape/dtype-preserving stages; got "
            f"{tuple(x.shape[1:])}:{x.dtype} -> {tuple(out.shape)}:{out.dtype}")

    group = mesh.get_group(axis)
    stage = dist.get_rank(group)
    last = n_stages - 1
    params = _stage(stage_params, stage)
    buf = torch.zeros_like(x)
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        if stage == 0:
            inp = x[m]
        else:
            inp = torch.empty_like(x[0])
            dist.recv(inp, dist.get_global_rank(group, stage - 1), group=group)
        out = stage_fn(params, inp).contiguous()
        if stage == last:
            buf[m] = out
        else:  # held in ``sends`` until its send completes
            sends.append((dist.isend(out, dist.get_global_rank(
                group, stage + 1), group=group), out))
    for work, _ in sends:
        work.wait()
    # only the last stage wrote real outputs; every rank returns them
    dist.broadcast(buf, dist.get_global_rank(group, last), group=group)
    return buf
