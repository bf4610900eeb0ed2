"""Gates on the port's artifacts (port of ``repro.analysis.hlo_gates``).

The fused SSpNNA kernel's whole contract is *what its call does not
contain*: no gather, no scatter, no (T, dI, C) working set in device
memory. The JAX package reads that from compiled HLO; the port has no HLO,
so its gates read what the port has:

* ``REPRO-H001`` — forbidden op in an op trace: aten names from a dispatch
  trace (``op_trace``) or the ops and kernels of a ``torch.profiler`` trace.
  ``"gather"`` is the gather family (``aten.gather``, ``index_select``,
  ``index.Tensor``, ``take``), ``"scatter"`` the scatter family
  (``scatter*``, ``index_add``, ``index_put``, ``index_copy``). Matches are
  exact on the op's name, so a ``_c10d_functional.all_gather_into_tensor``
  never trips ``gather`` (the JAX package's exact-opcode rule).
  ``only_kernels`` flags a device kernel outside an allowed set.
* ``REPRO-H002`` — signature budget exceeded: more captured graphs or
  planned signatures than a bucket family allows (``SceneEngine.
  n_compilations``, the keys of a ``serving.graphs.Graphs``, or a count).
* ``REPRO-H003`` — the fused kernel's modeled shared memory, from a Python
  copy of ``geometry()`` in ``kernels/csrc/sspnna_tile.cuh`` (the
  counterpart of the JAX package's modeled VMEM), over the card's opt-in
  limit per block, or no geometry at all (``smem < 0``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

DEFAULT_FORBIDDEN = ("gather", "scatter")

_GATHER = frozenset({"gather", "index_select", "index", "take"})
_SCATTER_OTHERS = frozenset({"index_add", "index_add_", "index_put",
                             "index_put_", "_index_put_impl_", "index_copy",
                             "index_copy_"})
_NAMESPACES = frozenset({"aten", "prims", "_c10d_functional", "c10d",
                         "_c10d_functional_autograd", "profiler"})

#: an H100's opt-in shared memory per block (227 KiB), H003's budget
DEFAULT_SMEM_BUDGET = 232_448
#: SMs of an H100 SXM (``cudaDevAttrMultiProcessorCount``)
H100_SMS = 132


def op_base(name: str) -> str:
    """The op's own name: ``aten::index_select``, ``aten.index.Tensor`` and
    ``index_select`` give ``index_select`` and ``index``."""
    if "::" in name:
        return name.split("::", 1)[1].split(".")[0]
    parts = name.split(".")
    return parts[1] if len(parts) > 1 and parts[0] in _NAMESPACES \
        else parts[0]


def op_family(name: str) -> str | None:
    """``"gather"``, ``"scatter"`` or None for an op name."""
    base = op_base(name)
    if base in _GATHER:
        return "gather"
    if base.startswith("scatter") or base in _SCATTER_OTHERS:
        return "scatter"
    return None


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def op_trace(fn, *args, **kw) -> tuple[object, list[str]]:
    """``fn(*args, **kw)`` -> (its result, the aten op names it
    dispatched, in order)."""
    rec = _OpRecorder()
    with rec:
        out = fn(*args, **kw)
    return out, rec.names


def forbidden_ops(trace, forbidden: tuple[str, ...] = DEFAULT_FORBIDDEN,
                  *, where: str = "ops") -> list[Finding]:
    """REPRO-H001 for every op of ``trace`` (op or kernel names) whose
    family is in ``forbidden``, one finding per op name."""
    hits: dict[str, int] = {}
    for name in trace:
        if op_family(name) in forbidden:
            hits[name] = hits.get(name, 0) + 1
    return [Finding("REPRO-H001", where,
                    f"forbidden {op_family(name)} op {name!r} appears {n}x")
            for name, n in sorted(hits.items())]


def only_kernels(kernels, allowed: tuple[str, ...], *,
                 where: str = "kernels") -> list[Finding]:
    """REPRO-H001 for every device kernel of a profiler trace whose name
    holds none of ``allowed``."""
    return [Finding("REPRO-H001", where,
                    f"kernel {name!r} runs where only kernels matching "
                    f"{list(allowed)} may")
            for name in sorted(set(kernels))
            if not any(a in name for a in allowed)]


# -- signature budgets ------------------------------------------------------

def signature_count(obj) -> int:
    """Signatures an object holds: an int as it is, a ``SceneEngine``'s
    ``n_compilations``, or the keys of a ``Graphs``."""
    if isinstance(obj, int):
        return obj
    if hasattr(obj, "n_compilations"):
        return int(obj.n_compilations)
    if hasattr(obj, "keys"):
        return len(obj.keys())
    raise TypeError(f"{obj!r} holds no signature count")


def gate_compile_budget(obj, max_signatures: int,
                        *, where: str = "graphs") -> list[Finding]:
    """REPRO-H002 when ``obj`` (see ``signature_count``) exceeds its
    bucket family's budget."""
    n = signature_count(obj)
    if n > max_signatures:
        return [Finding(
            "REPRO-H002", where,
            f"{n} signatures exceeds the bucket budget of {max_signatures} "
            f"(shape leak: something varies per call that the signature "
            f"family should pin)")]
    return []


# -- modeled shared memory ----------------------------------------------------

_MAX_THREADS = 256
_BLOCKS_PER_SM = 2
_TWO_BLOCKS_SMEM = 113 * 1024
_MAX_SMEM = 227 * 1024
_STAGES = 3


def _ceil_div(x: int, m: int) -> int:
    return (x + m - 1) // m


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


def geometry(rows: int, c: int, n: int, k: int, esize: int = 4,
             sms: int = H100_SMS) -> dict[str, int]:
    """The SSpNNA tile kernels' launch for ``rows`` = T * dO rows, C=``c``,
    N=``n``, ``k`` planes and ``esize``-byte elements on ``sms`` SMs: a
    line-for-line copy of ``geometry()`` and ``describe()`` in
    ``kernels/csrc/sspnna_tile.cuh``, keyed as ``sspnna.GEOMETRY`` (all but
    ``blocks_per_sm``, which the occupancy API gives on the card).
    ``smem_bytes`` < 0: no geometry fits."""
    cp = _round_up(c if c > 0 else 1, 8 if esize == 4 else 16)
    sa = cp + (4 if esize == 4 else 8)
    npad = _round_up(n, 8)
    want = _BLOCKS_PER_SM * sms
    split = _ceil_div(npad, 64)
    bm = 128
    while bm > 32 and _ceil_div(rows, bm) * split < want:
        bm //= 2
    bn = _round_up(_ceil_div(npad, split), 8)
    if _ceil_div(rows, bm) * split < want and bn >= 32:
        split *= 2   # few rows (the coarsest level): split N as well
        bn = _round_up(_ceil_div(npad, split), 8)
    q = bn // 8
    if q > 4:
        q += q & 1
    warps_n = 2 if q > 4 or (q % 2 == 0
                             and bm // 16 * 2 * 32 <= _MAX_THREADS) else 1
    bn = 8 * q
    while bm // 16 * warps_n * 32 > _MAX_THREADS:
        bm //= 2
    n_split = _ceil_div(n, bn)
    sw = bn + 8 if bn % 16 == 0 else bn
    w_bytes = cp * sw * esize

    def smem(m: int, stages: int) -> int:
        tables = (m * k + 2 * m + 2 * k + 1) * 4
        return stages * (m * sa * esize + w_bytes) + _round_up(tables, 16)

    g_smem, g_bm, g_stages = -1, 0, 0
    while bm >= 16 and g_smem < 0:
        for limit in (_TWO_BLOCKS_SMEM, _MAX_SMEM):
            s = _STAGES
            while s >= 2 and g_smem < 0:
                if smem(bm, s) <= limit:
                    g_stages, g_smem = s, smem(bm, s)
                s -= 1
        if g_smem >= 0:
            g_bm = bm
        bm //= 2
    return {"grid_x": _ceil_div(rows, g_bm) if g_bm else 0,
            "grid_y": n_split, "threads": 32 * (g_bm // 16) * warps_n,
            "rows_per_block": g_bm, "channels_per_block": bn,
            "stages": g_stages, "smem_bytes": g_smem}


def modeled_smem_bytes(*, n_tiles: int, delta_o: int, c_in: int,
                       c_out: int, k: int = 27, esize: int = 4,
                       sms: int = H100_SMS) -> int:
    """Dynamic shared memory of one block of the fused kernel's launch."""
    return geometry(n_tiles * delta_o, c_in, c_out, k, esize,
                    sms)["smem_bytes"]


def gate_smem_budget(*, n_tiles: int, delta_o: int, c_in: int, c_out: int,
                     k: int = 27, esize: int = 4,
                     budget: int = DEFAULT_SMEM_BUDGET, sms: int = H100_SMS,
                     where: str = "dispatch") -> list[Finding]:
    """REPRO-H003 when the modeled shared memory exceeds ``budget`` or no
    geometry fits."""
    need = modeled_smem_bytes(n_tiles=n_tiles, delta_o=delta_o, c_in=c_in,
                              c_out=c_out, k=k, esize=esize, sms=sms)
    shape = (f"T={n_tiles}, dO={delta_o}, C={c_in}, N={c_out}, K={k}, "
             f"{esize}-byte elements")
    if need < 0:
        return [Finding("REPRO-H003", where,
                        f"no launch geometry fits in shared memory ({shape})")]
    if need > budget:
        return [Finding("REPRO-H003", where,
                        f"modeled shared memory {need} B > budget {budget} B "
                        f"({shape})")]
    return []


def gate_plan_smem(plan, widths, *, budget: int = DEFAULT_SMEM_BUDGET,
                   where: str = "plan") -> list[Finding]:
    """``gate_smem_budget`` on every tiled conv of a ``ScenePlan``
    (``widths[li]`` is the level's channel count, in and out)."""
    out: list[Finding] = []
    for li, lvl in enumerate(plan.levels):
        tiles = getattr(lvl.sub, "tiles", None)
        if tiles is None:
            continue
        t, d_o, k = tuple(tiles.local_idx.shape)
        c = int(widths[li] if li < len(widths) else widths[-1])
        out.extend(gate_smem_budget(
            n_tiles=t, delta_o=d_o, c_in=c, c_out=c, k=k, budget=budget,
            where=f"{where}.levels[{li}].sub"))
    return out


def gate_geometry_matches(launch: dict, modeled: dict, *,
                          where: str = "geometry") -> list[Finding]:
    """REPRO-H003 when the modeled geometry differs from the launch's own
    (``sspnna.launch_geometry``) on any key they share."""
    diff = {k: (modeled[k], launch[k]) for k in modeled
            if k in launch and modeled[k] != launch[k]}
    if diff:
        return [Finding("REPRO-H003", where,
                        f"modeled geometry differs from the launch's "
                        f"(modeled, launch): {diff}")]
    return []


def device_kernels(fn) -> list[str]:
    """The device kernels ``fn`` ran, by name, from a ``torch.profiler``
    trace (needs the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
