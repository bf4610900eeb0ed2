"""The halo exchange of sharded scenes (port of
``repro.dist.collectives.halo_exchange_local`` / ``halo_exchange``).

Shard ``d`` holds a ``(Vs, C)`` block of feature rows; a conv's send table
``send_rows (S, S, H)`` lists in ``send_rows[d, s]`` the rows (local to
``d``) that shard ``s`` needs from ``d``, ``-1`` pads. Every shard ``s``
receives ``(S, H, C)``: block ``d`` is ``feats[d][send_rows[d, s]]``, pad
slots as zero rows, so its conv reads ``concat([own rows, received rows
(S*H)])``, the layout ``core.host_meta.shard_halo_tables_np`` codes its
local indices against. The exchange moves rows and adds nothing, so both
forms give the same bits:

* ``halo_exchange_local`` is the loop form, all shards on one device (the
  counterpart of the JAX package's ``vmap(axis_name=...)`` path);
* ``halo_exchange`` is the process form, one shard a process: one
  ``torch.distributed.all_to_all_single`` of the halo rows in a process
  group (the JAX package's ``all_to_all`` under ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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
