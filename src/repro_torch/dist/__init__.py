"""Distributed execution of the port (port of ``repro.dist``): sharding
hints, rules, collectives and the pipeline, over ``torch.distributed``.

One contract, the JAX package's: everything is an exact no-op, or the
identity, without a mesh or at one rank, so single-device runs execute the
same code a meshed run does. A mesh is a ``DeviceMesh`` with
``mesh_dim_names``; a process group stands where the JAX package runs a
``shard_map`` body, each process holding its own block.

* ``hints``       — ``DP`` / ``constrain`` / ``use_mesh``: PartitionSpec-style
  hints that model code puts on activations.
* ``sharding``    — ``ShardingRules``: named shardings for params, optimizer
  state, batches and decode caches, read by ``training.checkpoint.restore``.
* ``collectives`` — ``compressed_psum`` (the EF-int8 gradient sum on
  ``training.grad_compress``), the expert all-to-all of ``models.moe``'s
  ``dispatch="a2a"``, and the halo exchange of sharded scenes.
* ``pipeline``    — ``stack_stages`` / ``pipeline_apply``: GPipe stages over
  a ``"pipe"`` mesh axis.
"""
from repro_torch.dist.collectives import (
    compressed_psum,
    expert_all_to_all,
    expert_all_to_all_local,
    halo_exchange,
    halo_exchange_local,
)
from repro_torch.dist.hints import DP, active_mesh, constrain, use_mesh
from repro_torch.dist.pipeline import pipeline_apply, stack_stages
from repro_torch.dist.sharding import ShardingRules

__all__ = [
    "DP",
    "ShardingRules",
    "active_mesh",
    "compressed_psum",
    "constrain",
    "expert_all_to_all",
    "expert_all_to_all_local",
    "halo_exchange",
    "halo_exchange_local",
    "pipeline_apply",
    "stack_stages",
    "use_mesh",
]
