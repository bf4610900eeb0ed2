"""What a kernel wrapper does with inputs it cannot launch on.

Two kinds of input reach the wrappers from the dry run
(``launch.dryrun``), which runs whole steps on ``DTensor``s whose shards
are fake tensors:

* **Fake or meta tensors** have a shape, a dtype and a device but no
  storage (``data_ptr()`` is 0), so a launch would hand the kernel null
  pointers. A wrapper given one returns an empty output of the right
  shape, dtype and device, adds its work (``launch.roofline``'s work
  function) to the active op walker (``launch.hlo_analysis``), launches
  nothing and leaves its ``launches`` count as it is. A fake tensor
  reports ``cpu`` or ``cuda``, so this test comes before the device
  branches. Real CPU tensors still take the plain version, real CUDA
  tensors still launch or raise.
* **``DTensor``s** have no sharding rule for a ``ctypes`` launch. Where
  their placements shard only dims the kernel treats independently (flash:
  batch and heads; the expert GEMM: experts and rows; the SSpNNA kernels:
  tiles and output channels), ``sharded_call`` runs the wrapper on each
  input's local shard and returns a ``DTensor`` with those placements.
  Any other placement raises and names the dim: the caller redistributes
  explicitly, so every collective is one the caller asked for.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_abstract(*xs) -> bool:
    """Whether any of ``xs`` is a fake or meta tensor (no data)."""
    return any(isinstance(x, FakeTensor) or x.device.type == "meta"
               for x in xs if isinstance(x, torch.Tensor))


def fake_launch(kernel: str, work, out: torch.Tensor) -> torch.Tensor:
    """A launch on fake or meta inputs: ``work`` goes to the active walker
    and ``out`` (an empty tensor made from an input) is returned."""
    from repro_torch.launch.hlo_analysis import record_kernel

    record_kernel(kernel, work)
    return out


def any_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def kernel_placements(inputs: dict, dims: dict) -> dict:
    """The placements ``sharded_call`` takes, nearest to the inputs': on
    each mesh dim, a shard of an independent dim is kept where every input
    holding that dim shards it alike. Otherwise (a partial sum, a summed
    dim sharded, inputs that disagree) the mesh dim moves to the first
    independent dim that every input holding it can split evenly once
    more, or, where none can, is replicated. -> {argument: placements}."""
    tensors = list(inputs.values())
    mesh = tensors[0].device_mesh
    out = {arg: [] for arg in inputs}

    def split(arg, name):   # how many ways ``name`` of ``arg`` is cut so far
        d = next(d for d, n in dims[arg].items() if n == name)
        return d, math.prod(mesh.size(j) for j, p in enumerate(out[arg])
                            if type(p) is Shard and p.dim == d)

    for i in range(mesh.ndim):
        names = {}
        for arg, x in inputs.items():
            p = x.placements[i]
            names[arg] = (dims[arg].get(p.dim, "?") if type(p) is Shard
                          else None if isinstance(p, Replicate) else "?")
        logical = {n for n in names.values() if n is not None}
        keep = (len(logical) == 1 and "?" not in logical
                and all(names[a] in logical for a in inputs
                        if set(dims[a].values()) & logical))
        if keep:
            for arg, x in inputs.items():
                out[arg].append(x.placements[i] if names[arg]
                                else Replicate())
            continue
        order = dict.fromkeys(n for arg in inputs for n in dims[arg].values())
        move = next((name for name in order if all(
            inputs[a].shape[split(a, name)[0]]
            % (split(a, name)[1] * mesh.size(i)) == 0
            for a in inputs if name in dims[a].values())), None)
        for arg in inputs:
            out[arg].append(Shard(split(arg, move)[0])
                            if move in dims[arg].values() else Replicate())
    return out


def redistribute_for(inputs: dict, dims: dict) -> dict:
    """Each ``DTensor`` of ``inputs`` redistributed to
    ``kernel_placements`` (the collectives a caller asks for before a
    kernel whose ``dims`` a ``DTensor`` may shard); plain tensors as they
    are."""
    if not any_dtensor(*inputs.values()):
        return inputs
    target = kernel_placements(inputs, dims)
    return {arg: x.redistribute(x.device_mesh, target[arg])
            for arg, x in inputs.items()}


def sharded_call(fn, kernel: str, inputs: dict, dims: dict, out_dims: dict,
                 **kw):
    """``fn(**locals, **kw)`` on every input's local shard -> a ``DTensor``
    (or a tuple of them, where ``fn`` returns outputs of one layout).

    ``inputs`` maps argument names to ``DTensor``s on one mesh; ``dims``
    maps each argument name to ``{tensor dim: name}`` of the dims the
    kernel treats independently, and ``out_dims`` the output's. On each
    mesh dim, the inputs that have a dim of one name must all shard it and
    the others must replicate it; all replicate is fine too. Anything else
    (a summed dim sharded, a partial sum, mixed placements) raises and
    names the dim."""
    tensors = list(inputs.values())
    if not all(isinstance(x, DTensor) for x in tensors):
        kinds = ", ".join(f"{k}: {type(v).__name__}"
                          for k, v in inputs.items())
        raise TypeError(f"{kernel}: mixed DTensor and plain tensor inputs "
                        f"({kinds})")
    mesh = tensors[0].device_mesh
    if any(x.device_mesh != mesh for x in tensors):
        raise ValueError(f"{kernel}: DTensor inputs on different meshes")
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    out_placements = []
    for i, mesh_dim in enumerate(names):
        sharded = {}
        for arg, x in inputs.items():
            p = x.placements[i]
            if isinstance(p, Replicate):
                continue
            if type(p) is not Shard or p.dim not in dims[arg]:
                raise ValueError(
                    f"{kernel}: mesh dim {mesh_dim!r} places {arg} "
                    f"{tuple(x.shape)} as {p!r}; the kernel takes shards of "
                    f"{', '.join(f'dim {d} ({n})' for d, n in dims[arg].items())} "
                    f"only (redistribute before the call)")
            sharded[arg] = dims[arg][p.dim]
        if not sharded:
            out_placements.append(Replicate())
            continue
        logical = set(sharded.values())
        missing = [a for a in inputs if a not in sharded
                   and set(dims[a].values()) & logical]
        if len(logical) > 1 or missing:
            raise ValueError(
                f"{kernel}: mesh dim {mesh_dim!r} shards "
                f"{', '.join(f'{a} on {n}' for a, n in sharded.items())}"
                + (f" but not {', '.join(missing)}" if missing else "")
                + "; every input holding the dim must shard it alike")
        (name,) = logical
        out_placements.append(Shard(next(d for d, n in out_dims.items()
                                         if n == name)))
    local = fn(**{k: v.to_local() for k, v in inputs.items()}, **kw)
    if isinstance(local, tuple):   # outputs that share the dims' layout
        return tuple(DTensor.from_local(x, mesh, out_placements,
                                        run_check=False) for x in local)
    return DTensor.from_local(local, mesh, out_placements, run_check=False)
