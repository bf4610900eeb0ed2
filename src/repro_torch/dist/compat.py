"""Mesh construction over ``torch.distributed`` (port of
``repro.dist.compat``).

The JAX module smooths over three JAX API moves: ``AxisType``, the
``axis_types`` argument of ``jax.make_mesh`` and ``shard_map``'s renamed
replication check. Only ``make_mesh`` has a counterpart here: a
``DeviceMesh`` has no axis types, and a process group is the port's
``shard_map``, since each process runs the per-device body on its own block
(``dist.collectives``, ``dist.pipeline``, ``models.moe``).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(axis_shapes, axis_names, *, device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` with dims named ``axis_names``
    over the default process group, whose world size must equal the
    product of the shapes (``init_device_mesh`` raises otherwise)."""
    return init_device_mesh(torch.device(device).type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))
