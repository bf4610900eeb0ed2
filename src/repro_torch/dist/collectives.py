"""Collectives of the port (port of ``repro.dist.collectives``): the
EF-int8 compressed gradient sum, the expert all-to-all of expert-parallel
MoE, and the halo exchange of sharded scenes.

Each takes this process's block and a process group, or a ``DeviceMesh``
and the name of the dim to run over (a name the mesh lacks raises, as in
the JAX package): a process group is the port's ``shard_map``.

``compressed_psum`` wires ``training.grad_compress``'s error-feedback int8
quantizer around the data-parallel gradient sum: each rank quantizes its
error-corrected leaf to int8 blocks, the int8 payload and the f32 block
scales are all that cross (two ``all_gather_into_tensor`` calls, 4x fewer
bytes than f32), and every rank dequantizes the gathered blocks and sums
them in rank order. On one rank it is the quantization round trip.

``expert_all_to_all`` exchanges a group-major MoE dispatch block ``(G/S,
E, cap, d)`` for the expert-major ``(G, E/S, cap, d)``: one
``all_to_all_single``; swapping the axes inverts it, and autograd's
backward pass is that inverse. ``expert_all_to_all_local`` is the same
exchange over the ranks' blocks stacked on one device. Both move values
and add nothing, and both are the identity at one rank.

The halo exchange: shard ``d`` holds a ``(Vs, C)`` block of feature rows;
a conv's send table ``send_rows (S, S, H)`` lists in ``send_rows[d, s]``
the rows (local to ``d``) that shard ``s`` needs from ``d``, ``-1`` pads.
Every shard ``s`` receives ``(S, H, C)``: block ``d`` is
``feats[d][send_rows[d, s]]``, pad slots as zero rows, so its conv reads
``concat([own rows, received rows (S*H)])``, the layout
``core.host_meta.shard_halo_tables_np`` codes its local indices against.
The exchange moves rows and adds nothing, so both forms give the same
bits:

* ``halo_exchange_local`` is the loop form, all shards on one device (the
  counterpart of the JAX package's ``vmap(axis_name=...)`` path);
* ``halo_exchange`` is the process form, one shard a process: one
  ``torch.distributed.all_to_all_single`` of the halo rows in a process
  group (the JAX package's ``all_to_all`` under ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.hints import mesh_axes
from repro_torch.training.grad_compress import _dequantize, _quantize_int8
from repro_torch.training.tree import tree_map, unzip


def process_group(group_or_mesh, axis: str):
    """The process group of ``axis`` when given a ``DeviceMesh`` (an axis
    the mesh lacks raises); a process group (or None, the default group)
    as it is."""
    if not hasattr(group_or_mesh, "mesh_dim_names"):
        return group_or_mesh
    names = tuple(mesh_axes(group_or_mesh))
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return group_or_mesh.get_group(axis)


@torch.no_grad()
def compressed_psum(group_or_mesh, grads, axis: str = "pod",
                    error_state=None):
    """EF-int8 sum of a gradient tree over the ranks of ``axis``.

    Each rank contributes its own leaves; the wire format is int8 blocks
    and f32 scales (``grad_compress.BLOCK``). Returns the summed tree (f32
    leaves), or ``(summed, new_error_state)`` when ``error_state`` is given
    (the residual to feed back next step)."""
    group = process_group(group_or_mesh, axis)
    n = dist.get_world_size(group)
    with_err = error_state is not None
    if error_state is None:
        error_state = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, e):
        x = g.float() + e
        q, s = _quantize_int8(x)
        # the int8 payload and the scales are the only traffic
        qg = q.new_empty((n * q.shape[0], q.shape[1]))
        sg = s.new_empty((n * s.shape[0], 1))
        dist.all_gather_into_tensor(qg, q, group=group)
        dist.all_gather_into_tensor(sg, s, group=group)
        deq = qg.view(n, *q.shape).float() * sg.view(n, *s.shape)
        total = deq[0]
        for r in range(1, n):
            total = total + deq[r]
        total = total.reshape(-1)[:x.numel()].reshape(g.shape)
        return total, x - _dequantize(q, s, g.shape)

    summed, err = unzip(tree_map(one, grads, error_state), 2)
    return (summed, err) if with_err else summed


def _exchange(x: torch.Tensor, group, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    # chunk j of the split dim goes to rank j; chunk j received lands at
    # block j of the concat dim
    chunks = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _ExpertAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_exchange(grad, ctx.group, concat_axis, split_axis), None,
                None, None)


def expert_all_to_all(group_or_mesh, x: torch.Tensor, axis: str = "model",
                      split_axis: int = 1,
                      concat_axis: int = 0) -> torch.Tensor:
    """Process form: this rank's ``x`` split into S chunks along
    ``split_axis``, chunk j sent to rank j, and the S chunks received
    concatenated along ``concat_axis`` in rank order: a group-major ``(G/S,
    E, cap, d)`` block becomes the expert-major ``(G, E/S, cap, d)``.
    Swapped axes invert it; the identity at one rank."""
    return _ExpertAllToAll.apply(x, process_group(group_or_mesh, axis),
                                 split_axis, concat_axis)


def expert_all_to_all_local(x: torch.Tensor, split_axis: int = 1,
                            concat_axis: int = 0) -> torch.Tensor:
    """Loop form over stacked rank blocks: ``x`` (S, *block) -> (S,
    *exchanged block), block ``r`` what rank ``r`` of the process form
    returns (axes refer to a block's dims)."""
    n = x.shape[0]
    chunks = [b.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
              for b in x]
    return torch.stack([torch.cat([c[r] for c in chunks], dim=concat_axis)
                        for r in range(n)])


def _halo_payload(feats: torch.Tensor, send_rows: torch.Tensor) -> torch.Tensor:
    """What one shard sends: ``feats`` (Vs, C) and its send table
    ``send_rows`` (S, H) -> (S, H, C), block ``s`` the rows shard ``s``
    needs, ``-1`` pads as zero rows."""
    rows = send_rows.long()
    got = feats[rows.clamp(min=0)]
    return torch.where((rows >= 0)[..., None], got, torch.zeros_like(got))


def halo_exchange_local(feats: torch.Tensor,
                        send_rows: torch.Tensor) -> torch.Tensor:
    """Loop form over stacked shards: ``feats`` (S, Vs, C) and ``send_rows``
    (S, S, H) -> (S, S, H, C), ``out[s, d]`` the rows shard ``s`` received
    from shard ``d``."""
    payloads = [_halo_payload(feats[d], send_rows[d])
                for d in range(feats.shape[0])]
    return torch.stack(payloads, dim=1)


def halo_exchange(group, feats: torch.Tensor,
                  send_rows: torch.Tensor) -> torch.Tensor:
    """Process form: this process's shard ``feats`` (Vs, C) and its send
    table ``send_rows`` (S, H) -> the (S, H, C) rows it received, block
    ``d`` from the process of rank ``d`` in ``group``, in one
    ``all_to_all_single``."""
    payload = _halo_payload(feats, send_rows).contiguous()
    out = torch.empty_like(payload)
    dist.all_to_all_single(out, payload, group=group)
    return out
