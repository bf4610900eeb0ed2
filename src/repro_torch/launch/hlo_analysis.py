"""Per-rank cost walker over the dispatched op stream (the port's
counterpart of ``repro.launch.hlo_analysis``).

The JAX package reads costs from the SPMD-partitioned HLO of a compiled
step. The port has no HLO: its step is a stream of ATen ops on
``DTensor``s. ``CostWalker`` is a ``TorchDispatchMode`` that watches that
stream while the step runs (on fake tensors, in the dry run) and counts
what one rank does:

* **Only local ops count.** The mode sees every ``DTensor`` op twice: once
  with the ``DTensor`` arguments at the global shape, and once per local
  op the ``DTensor`` dispatch runs on the rank's shards. An op with a
  ``DTensor`` among its arguments is skipped; the local ops are the
  per-device program, as the JAX package reads the per-device module.
* **FLOPs:** ``2 * |out| * K`` for ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``einsum`` and ``linear`` (K the contracted size).
* **Bytes:** operand bytes plus output bytes of every op that is not a
  view or an allocation. Eager PyTorch fuses nothing, so elementwise ops
  count too: this differs by design from the JAX walker, whose skip list
  models XLA:TPU's fusion.
* **Collectives:** ``_c10d_functional.*`` (and ``_dtensor``'s all-to-all)
  by kind; all-gather counts its output bytes, the others their operand
  bytes, as in the JAX package. On a CPU mesh ``DTensor`` stands in for an
  all-to-all with an all-gather and a chunk; that gather counts as the
  all-to-all a CUDA mesh issues (the shard's bytes).
* **Metadata** (``prim.device``, ``sym_size``), views and allocations
  count nothing.
* **Kernels:** a fake launch of one of the four hand-written kernels
  (``kernels.abstract.fake_launch``) adds its work function's FLOPs and
  bytes (``launch.roofline``), and counts under ``kernels``.
* **Loops** need no trip-count logic: eager runs every iteration, so the
  JAX walker's ``_trip_count`` has no counterpart.
* **Memory:** the local bytes of the step's arguments and outputs, and
  the peak of the bytes that ops allocate while the step runs, tracked by
  storage (a storage counts from the op that makes it until it is freed).

``FlopCounterMode``'s count of the global ops is kept beside it as a
cross-check (``global_flops``), as the JAX package keeps XLA's
``cost_analysis()``.
"""
from __future__ import annotations

import contextvars
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# _c10d_functional op -> collective kind (the JAX package's names)
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",   # _dtensor's, on a CUDA mesh
}

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "einsum", "linear", "matmul"}

# allocations, aliases and metadata: no traffic of their own
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "_local_scalar_dense", "set_", "wait_tensor",
         "resize_"}

# modules whose ops derive a DTensor op's global output metadata (run on
# empty global-shape tensors, never part of a rank's program)
_PROPAGATION = ("torch.distributed.tensor._sharding_prop",
                "torch.distributed.tensor._op_schema")
_COLLECTIVE_UTILS = "torch.distributed.tensor._collective_utils"
# where DTensor sizes a strided shard from an index table it reads back
_SHARD_SIZES = "torch.distributed.tensor.placement_types"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost_walker", default=None)


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs (nested lists, tuples
    and dicts)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _local(x: torch.Tensor) -> torch.Tensor:
    return x._local_tensor if isinstance(x, DTensor) else x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _called_from(match, depth: int = 8) -> bool:
    """Whether one of the dispatched op's ``depth`` nearest Python callers
    (frames outside this module) is a frame ``match`` accepts."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    for _ in range(depth):
        if f is None:
            return False
        if match(f):
            return True
        f = f.f_back
    return False


def _module(f) -> str:
    return f.f_globals.get("__name__", "")


def _in_propagation() -> bool:
    """Whether the op comes from the ``DTensor`` sharding propagator."""
    return _called_from(lambda f: _module(f) in _PROPAGATION)


def _in_shard_sizes() -> bool:
    """Whether the op builds ``DTensor``'s strided-shard index tables."""
    return _called_from(lambda f: _module(f) == _SHARD_SIZES)


def _in_cpu_alltoall() -> bool:
    """Whether the op is ``DTensor``'s all-gather-and-chunk stand-in for an
    all-to-all on a CPU mesh (``_collective_utils.shard_dim_alltoall``)."""
    return _called_from(lambda f: f.f_code.co_name == "shard_dim_alltoall"
                        and _module(f) == _COLLECTIVE_UTILS)


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    #: kernel name -> {"launches", "flops", "bytes"} of its fake launches
    kernels: dict = field(default_factory=dict)
    #: FlopCounterMode's count of the global (DTensor-level) ops
    global_flops: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    #: the most bytes ops had allocated and not yet freed at once
    peak_temp_bytes: int = 0

    def _badd(self, op: str, b: float) -> None:
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + b

    def memory(self) -> dict:
        """The JAX dry run's memory keys, for one rank: arguments, outputs,
        temporaries (the allocation peak less the outputs made during the
        step), the outputs that are arguments' storage, and their sum."""
        made_outputs = self.output_bytes - self.alias_bytes
        temp = max(self.peak_temp_bytes - made_outputs, 0)
        peak = (self.argument_bytes + self.output_bytes + temp
                - self.alias_bytes)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": temp, "alias_bytes": self.alias_bytes,
                "peak_bytes_per_device": peak}


class CostWalker(TorchDispatchMode):
    """Counts one rank's local ops into ``self.cost`` (module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._token = None
        self._known: set[int] = set()     # storages of the arguments
        self._live: dict[int, int] = {}   # storage -> bytes, while alive
        self._live_bytes = 0

    # -- memory ------------------------------------------------------------

    def add_arguments(self, tree) -> None:
        """The step's inputs: their local bytes are arguments, and their
        storages are not allocations of the step."""
        for x in _tensors(tree):
            loc = _local(x)
            self.cost.argument_bytes += _nbytes(loc)
            self._known.add(loc.untyped_storage()._cdata)

    def add_outputs(self, tree) -> None:
        for x in _tensors(tree):
            loc = _local(x)
            self.cost.output_bytes += _nbytes(loc)
            if loc.untyped_storage()._cdata in self._known:
                self.cost.alias_bytes += _nbytes(loc)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _allocated(self, outs) -> None:
        """Count each output whose storage is new until its tensor is
        freed (a view keeps its base, and so the storage, alive)."""
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(t, self._free, key)
        self.cost.peak_temp_bytes = max(self.cost.peak_temp_bytes,
                                        self._live_bytes)

    # -- the op stream -----------------------------------------------------

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(x, DTensor) for x in ins):
            # the global op: DTensor's own dispatch runs it, and its local
            # ops come back through this mode
            return NotImplemented
        if (not any(isinstance(x, FakeTensor) for x in ins)
                and _in_shard_sizes()):
            # an index table DTensor builds to size a strided shard and
            # reads back on the host: real tensors, outside the fake mode
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not _in_propagation():
            self._count(func, ins, _tensors(out), args)
        return out

    def _count(self, func, ins, outs, args) -> None:
        c = self.cost
        name = func._opname
        ns = func.namespace
        if ns in ("_c10d_functional", "_dtensor") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            if kind == "all-gather" and _in_cpu_alltoall():
                # a CPU mesh's stand-in for the all-to-all a CUDA mesh
                # issues: count the all-to-all (the shard's bytes)
                kind = "all-to-all"
            in_b = sum(_nbytes(x) for x in ins)
            out_b = sum(_nbytes(x) for x in outs)
            b = out_b if kind == "all-gather" else in_b
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + b
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c._badd(kind, in_b + out_b)
            self._allocated(outs)
            return
        if ns == "prim" or name.startswith("sym_"):
            return   # metadata queries (a tensor's device, sizes)
        if name in _FREE or func.is_view:
            if name.startswith("empty") or name.startswith("new_empty"):
                self._allocated(outs)
            return
        if name in _MATMULS and outs:
            a = next((x for x in (args[1:] if name in ("addmm", "baddbmm")
                                  else args) if isinstance(x, torch.Tensor)),
                     None)
            k = a.shape[-1] if a is not None and a.dim() else 1
            c.flops += 2.0 * outs[0].numel() * k
        seen, in_b = set(), 0
        for x in ins:
            if id(x) not in seen:
                seen.add(id(x))
                in_b += _nbytes(x)
        c._badd(name, in_b + sum(_nbytes(x) for x in outs))
        self._allocated(outs)

    def record_kernel(self, kernel: str, work) -> None:
        c = self.cost
        k = c.kernels.setdefault(kernel, {"launches": 0, "flops": 0.0,
                                          "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        c.flops += work.flops
        c._badd(kernel, work.bytes)


def record_kernel(kernel: str, work) -> None:
    """A kernel's fake launch: its work goes to the active walker, if any."""
    walker = _ACTIVE.get()
    if walker is not None:
        walker.record_kernel(kernel, work)


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a ``CostWalker`` and a
    ``FlopCounterMode`` -> (its result, the rank's ``OpCost``)."""
    from torch.utils.flop_counter import FlopCounterMode

    walker = CostWalker()
    walker.add_arguments((args, kwargs))
    counter = FlopCounterMode(display=False)
    with counter, walker:
        out = fn(*args, **kwargs)
    walker.add_outputs(out)
    walker.cost.global_flops = float(counter.get_total_flops())
    return out, walker.cost
