"""PartitionSpec-style sharding hints for model code (port of
``repro.dist.hints``).

Model code annotates activations with ``constrain(x, DP, None, "model")``
style hints, one entry per dimension. The hints take effect only inside a
``use_mesh(mesh, dp=...)`` context; with no active mesh ``constrain``
returns its input itself, so single-device runs and the CPU tests run the
same code as a meshed run.

Entry semantics per dimension, as in the JAX package:

* ``DP``     — shard over the active data-parallel axes (the tuple
  ``use_mesh`` declared, e.g. ``("pod", "data")``).
* ``"name"`` — shard over that mesh axis. Dropped when the axis is absent,
  already taken by DP, of size 1, or does not divide the dimension.
* ``None``   — leave the dimension unsharded.

A spec is a tuple with one entry per dimension (``None``, an axis name, or
a tuple of names), the JAX ``PartitionSpec``'s entries; ``placements``
turns it into a ``DTensor``'s placements on a ``DeviceMesh``. In the
port's process form a rank's plain tensor is already its own block, so
``constrain`` leaves it as it is; a ``DTensor`` on the active mesh is
redistributed to the spec's placements.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

from torch.distributed.tensor import DTensor, Replicate, Shard


class _DPSentinel:
    """Placeholder for 'the active data-parallel axes' in constrain()."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "DP"


DP = _DPSentinel()

# (mesh, dp_axes) while a use_mesh() context is active, else None.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dist_active_mesh", default=None)


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``engine.context.
    mesh_axes``, imported here when called: the engine imports this
    package)."""
    from repro_torch.engine.context import mesh_axes as axes

    return axes(mesh)


@contextlib.contextmanager
def use_mesh(mesh, *, dp=("data",)):
    """Activate ``mesh`` for ``constrain`` hints; ``dp`` names the DP axes.

    DP axes absent from the mesh are dropped (call sites name the multi-pod
    superset, e.g. ``("pod", "data")`` on a single-pod mesh), but an entirely
    unknown dp set is a config error and raises.
    """
    names = tuple(mesh_axes(mesh))
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    present = tuple(a for a in dp if a in names)
    if dp and not present:
        raise ValueError(f"none of dp axes {dp} are in mesh axes {names}")
    token = _ACTIVE.set((mesh, present))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """Returns (mesh, dp_axes) inside use_mesh(), else None."""
    return _ACTIVE.get()


def constrain_spec(shape, entries, axes: dict[str, int], dp: tuple) -> tuple:
    """The spec ``constrain`` gives an array of ``shape`` under ``entries``
    on a mesh of ``axes`` ({name: size}) whose DP axes are ``dp``."""
    used = set(dp)
    spec = []
    for dim, entry in zip(shape, entries):
        if entry is DP:
            live = tuple(a for a in dp if axes[a] > 1)
            size = math.prod(axes[a] for a in live)
            if live and dim % size == 0 and dim > 0:
                spec.append(live if len(live) > 1 else live[0])
            else:
                spec.append(None)
        elif entry is None:
            spec.append(None)
        else:
            cand = (entry,) if isinstance(entry, str) else tuple(entry)
            names, size = [], 1
            for a in cand:
                if (a in axes and a not in used and axes[a] > 1
                        and dim % (size * axes[a]) == 0):
                    names.append(a)
                    size *= axes[a]
            used.update(names)
            if not names:
                spec.append(None)
            else:
                spec.append(tuple(names) if len(names) > 1 else names[0])
    return tuple(spec)


def placements(mesh, spec) -> tuple:
    """A spec as a ``DTensor``'s placements on ``mesh``: ``Shard(d)`` on
    every mesh dim that entry ``d`` names, ``Replicate()`` on the rest."""
    dims = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            dims[a] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh_axes(mesh))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``spec`` as the JAX package's ``NamedSharding.
    spec`` gives it, ``placements`` as a ``DTensor`` takes them."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def splittable(x, dim: int, outer: int):
    """``x`` ready to have dim ``dim`` split into ``(outer, rest)`` (a
    model's head split): a ``DTensor`` whose mesh dims cut ``dim`` into a
    count that does not divide ``outer`` has those mesh dims replicated
    first (an all-gather, where the JAX program's reshape lets XLA
    reshard); anything else is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    ways, placements = 1, list(x.placements)
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            if outer % (ways * x.device_mesh.size(i)) == 0:
                ways *= x.device_mesh.size(i)
            else:
                placements[i] = Replicate()
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, *entries):
    """Apply a per-dimension sharding hint; ``x`` itself when no mesh is
    active. A ``DTensor`` on the active mesh is redistributed to the
    hint's placements; any other tensor is returned as it is (a rank's
    plain tensor is its block already)."""
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, dp = active
    if len(entries) != x.dim():
        raise ValueError(
            f"constrain got {len(entries)} entries for rank-{x.dim()} array")
    spec = constrain_spec(tuple(x.shape), entries, mesh_axes(mesh), dp)
    if isinstance(x, DTensor) and x.device_mesh == mesh:
        return x.redistribute(mesh, placements(mesh, spec))
    return x
