"""Collectives of the port (port of part of ``repro.dist``): the halo
exchange of sharded scenes, as a loop over shards on one device
(``halo_exchange_local``) and across a process group
(``halo_exchange``). The rest of the JAX package's ``dist`` (sharding
hints, pipelines, compressed gradient sums, the expert all-to-all) comes
with the distribution slice (``ROADMAP.md``, queue 1, slice 11)."""
from repro_torch.dist.collectives import halo_exchange, halo_exchange_local

__all__ = ["halo_exchange", "halo_exchange_local"]
