"""Profile-guided SPADE: measured cost tables, autotune cache, re-profiling
(port of ``repro.engine.autotune``).

SPADE picks a dataflow per layer from the paper's analytical data-access
model (Eqn 5, ``core.spade``), and that model can be badly wrong on a real
target. This module closes the loop with measurements taken on the
device the port serves on:

* :func:`measure` — warm-up + median-of-``k`` timing of one call: CUDA
  events on the current stream (host launch time included) for work on
  the card, the host clock for work on the CPU.
* :class:`CostTable` — measured per-backend times keyed by a bucketed
  shape signature ``(n_in, n_out, C_in, C_out, K, density-bin, backend,
  block_n)`` (the JAX package's eight fields and encoding; ``block_n`` is
  always 0 here: the CUDA kernels have no N-block), with a persistent JSON
  cache (versioned with the plan-layout version and a torch/device
  fingerprint; corrupt or stale files are ignored, writes are atomic),
  seedable from ``bench-rows/v1`` artifacts (:func:`seed_cost_table`).
* dispatch consult — ``engine.plan.build_plan_spec`` and adaptive plan
  builds call :meth:`CostTable.adjust_dispatch` first and keep the
  analytical decision on a miss (recording the miss); a cold table builds
  exactly the plans the analytical dispatcher builds.
* plan rotation — when the measured winner of a signature flips, the table
  bumps its ``generation`` (part of its ``repr``, and so of every
  ``PlanCache`` key built with ``autotune=``) and fires its flip hooks
  (``ExecutionContext`` wires ``plan_cache.invalidate``).
* :func:`reprofile` — the budgeted idle-gap worker a ``SceneEngine`` runs
  between waves (``on_idle``): re-measures the hottest missed signatures,
  then the stalest still-consulted ones, on a synthetic workload at the
  signature's shape through every registered backend able to run it
  (:func:`measure_backends` walks the ``BackendRegistry``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis.runtime import ordered_rlock
from repro_torch.engine.plan import (
    _PLAN_VERSION,
    REFERENCE,
    REFERENCE_DISPATCH,
    SSPNNA,
    Dispatch,
    conv_plan_for_layer,
)

# the port's own schema, cache file and variable: a JAX cache and a port
# cache never overwrite or load each other
_SCHEMA = "repro_torch-autotune/v1"
_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

#: density-bin edges (log-spaced): scene sparsity matters to dispatch at
#: order-of-magnitude granularity, and coarse bins let measurements
#: transfer across scenes
_DENSITY_EDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Measurement:
    """One timed signature: median and IQR spread of ``k`` samples (us)."""

    median_us: float
    spread_us: float
    k: int
    times_us: tuple = ()


def _device_of(out) -> torch.device:
    """The device of the first tensor in a call's result (the CPU when it
    holds none)."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)):
        for x in out:
            if isinstance(x, torch.Tensor):
                return x.device
    return torch.device("cpu")


def measure(fn, *args, warmup: int = 1, k: int = 5,
            device: str | torch.device | None = None) -> Measurement:
    """Warm-up + median-of-``k`` time of one call ``fn(*args)`` in us.

    ``device`` is where ``fn``'s work runs (default: the device of the
    last warm-up call's result). On a CUDA device each sample is the span
    of CUDA events recorded on the current stream just before and just
    after the call, after a synchronize: the stream is idle when the start
    event is stamped, so the sample holds the call's host launch time as
    well as its device time (what an eager forward pays; inside a CUDA
    graph replay the host part vanishes). Elsewhere each sample is the
    host clock around the call. The median defeats one-off hiccups;
    ``spread_us`` (interquartile range) is the noise floor callers can
    gate on.
    """
    out = None
    for _ in range(max(int(warmup), 0)):
        out = fn(*args)
    dev = _device_of(out) if device is None else torch.device(device)
    times = []
    for _ in range(max(int(k), 1)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    spread = float(np.percentile(times, 75) - np.percentile(times, 25))
    return Measurement(float(np.median(times)), spread, len(times),
                       tuple(times))


# ---------------------------------------------------------------------------
# Shape signatures
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    """Round up to the next power of two (0 stays 0): measured costs must
    transfer across scenes, so row counts are bucketed, never exact."""
    n = int(n)
    return 1 << (n - 1).bit_length() if n > 0 else 0


def density_bin(density: float) -> int:
    """Log-spaced sparsity bucket of an active-voxel density in [0, 1]."""
    return int(np.searchsorted(_DENSITY_EDGES, max(float(density), 0.0),
                               side="right"))


def _bin_density(b: int) -> float:
    """Representative density of a bin (geometric midpoint): what the
    synthetic re-profiling workloads are generated at."""
    edges = (0.0,) + _DENSITY_EDGES + (1.0,)
    b = min(max(int(b), 0), len(edges) - 2)
    lo, hi = edges[b], edges[b + 1]
    return hi / 2.0 if lo == 0.0 else float(np.sqrt(lo * hi))


@dataclass(frozen=True)
class ShapeSig:
    """One cost-table key. ``n_in``/``n_out`` are power-of-two row-count
    buckets and ``density_bin`` a log-spaced sparsity bucket (exact values
    never repeat across scenes; buckets do). ``backend``/``block_n``
    distinguish measurements of the same shape; zeroing them
    (:meth:`group`) yields the lookup key dispatch consults. ``block_n``
    stays 0 in the port and is kept so that encodings equal the JAX
    package's."""

    n_in: int
    n_out: int
    c_in: int
    c_out: int
    k: int
    density_bin: int
    backend: str = ""
    block_n: int = 0

    def group(self) -> "ShapeSig":
        """The backend-free shape key measurements compete under."""
        if not self.backend and not self.block_n:
            return self
        return dataclasses.replace(self, backend="", block_n=0)

    def encode(self) -> str:
        return (f"{self.n_in}:{self.n_out}:{self.c_in}:{self.c_out}:"
                f"{self.k}:{self.density_bin}:{self.backend}:{self.block_n}")

    @classmethod
    def decode(cls, s: str) -> "ShapeSig":
        parts = s.split(":")
        if len(parts) != 8:
            raise ValueError(f"malformed ShapeSig {s!r}")
        nums = [int(p) for p in parts[:6]]
        return cls(*nums, backend=parts[6], block_n=int(parts[7]))


def signature(n_in: int, n_out: int, c_in: int, c_out: int, *,
              density: float, kernel_volume: int = 27, backend: str = "",
              block_n: int = 0) -> ShapeSig:
    """Bucketed signature of one conv site (the key everything agrees on:
    dispatch consults, profiling records, artifacts seed)."""
    return ShapeSig(_pow2(n_in), _pow2(n_out), int(c_in), int(c_out),
                    int(kernel_volume), density_bin(density), backend,
                    int(block_n))


# ---------------------------------------------------------------------------
# Cost table
# ---------------------------------------------------------------------------

@dataclass
class CostEntry:
    """One measured (signature, backend) cost. ``delta_o``/``delta_i`` are
    the tile shape the measurement ran at — what a reference->sspnna flip
    tiles the plan with; ``seq`` is the table-local recency stamp."""

    sig: ShapeSig
    median_us: float
    spread_us: float = 0.0
    k: int = 1
    delta_o: int = 0
    delta_i: int = 0
    seq: int = 0


def device_fingerprint() -> str:
    """torch version + the card's name and compute capability (``cpu``
    without a card): a cached measurement is only meaningful on the stack
    that produced it."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        kind = f"cuda|{torch.cuda.get_device_name(0)}|sm_{major}{minor}"
    else:
        kind = "cpu"
    return f"torch={torch.__version__}|{kind}"


def default_cache_path() -> str:
    """On-disk cache location; override with ``REPRO_TORCH_AUTOTUNE_CACHE``."""
    env = os.environ.get(_ENV_CACHE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


class CostTable:
    """Measured per-backend cost per shape signature, with flip tracking.

    Thread-safe (planner threads consult while an idle hook records).
    ``generation`` counts measured-winner flips; it is part of ``repr`` —
    and ``PlanCache.key_for`` reprs its build kwargs into every key — so
    passing ``autotune=table`` to a plan build makes cached plans
    self-invalidate on a flip, and :meth:`add_flip_hook` lets an
    ``ExecutionContext`` clear already-cached entries eagerly.

    A *miss* (consulted signature with no measurements) falls back to the
    analytical decision unchanged and is counted per signature; the idle
    re-profiler drains the hottest misses first.
    """

    def __init__(self, *, fingerprint: str | None = None):
        self.fingerprint = (device_fingerprint() if fingerprint is None
                            else fingerprint)
        self.generation = 0
        self.hits = 0
        #: how the table came to be: fresh | ok | missing | corrupt |
        #: version-mismatch | fingerprint-mismatch (see :meth:`load`)
        self.load_status = "fresh"
        self._groups: dict[ShapeSig, dict[ShapeSig, CostEntry]] = {}
        self._misses: dict[ShapeSig, dict] = {}
        self._group_hits: dict[ShapeSig, int] = {}
        self._seq = 0
        self._lock = ordered_rlock("autotune")
        self._flip_hooks: list = []

    def __repr__(self):
        # generation only: plan-cache keys embed this repr and must change
        # exactly when the measured winner flips, not on every sample
        return f"CostTable(gen={self.generation})"

    def __len__(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._groups.values())

    def entries(self) -> list[CostEntry]:
        with self._lock:
            return [e for g in self._groups.values() for e in g.values()]

    @property
    def miss_count(self) -> int:
        with self._lock:
            return sum(m["count"] for m in self._misses.values())

    def stats(self) -> dict:
        with self._lock:
            return {"entries": sum(len(g) for g in self._groups.values()),
                    "groups": len(self._groups), "hits": self.hits,
                    "misses": sum(m["count"] for m in self._misses.values()),
                    "generation": self.generation}

    # -- recording ---------------------------------------------------------

    def add_flip_hook(self, fn) -> None:
        """Call ``fn()`` whenever the measured winner of any signature
        flips (``ExecutionContext`` registers ``plan_cache.invalidate``)."""
        self._flip_hooks.append(fn)

    def _best_locked(self, gk: ShapeSig) -> CostEntry | None:
        g = self._groups.get(gk)
        if not g:
            return None
        return min(g.values(), key=lambda e: e.median_us)

    def record(self, sig: ShapeSig, median_us: float, *,
               spread_us: float = 0.0, k: int = 1, delta_o: int = 0,
               delta_i: int = 0) -> bool:
        """Record one measurement; returns True when it flipped the
        signature's winner (generation bumped, flip hooks fired). A first
        measurement of a signature that had recorded misses also counts as
        a flip — plans were built against the analytical fallback."""
        if not sig.backend:
            raise ValueError("record() needs sig.backend set")
        gk = sig.group()
        with self._lock:
            prev = self._best_locked(gk)
            prev_win = ((prev.sig.backend, prev.sig.block_n)
                        if prev is not None else None)
            had_miss = gk in self._misses
            self._seq += 1
            self._groups.setdefault(gk, {})[sig] = CostEntry(
                sig, float(median_us), float(spread_us), int(k),
                int(delta_o), int(delta_i), self._seq)
            self._misses.pop(gk, None)
            self._group_hits[gk] = 0
            best = self._best_locked(gk)
            win = (best.sig.backend, best.sig.block_n)
            flipped = (win != prev_win) if prev_win is not None else had_miss
            if flipped:
                self.generation += 1
            hooks = list(self._flip_hooks) if flipped else ()
        for fn in hooks:
            fn()
        return flipped

    # -- lookup ------------------------------------------------------------

    def best(self, sig: ShapeSig) -> CostEntry | None:
        """Cheapest measured entry for ``sig``'s shape group (any backend);
        None on a cold group. Counts as consultation interest for the
        staleness-driven re-profiler."""
        gk = sig.group()
        with self._lock:
            e = self._best_locked(gk)
            if e is not None:
                self._group_hits[gk] = self._group_hits.get(gk, 0) + 1
            return e

    def note_miss(self, sig: ShapeSig, *, delta_o: int = 0,
                  delta_i: int = 0, backend: str = "") -> None:
        """Count a consulted-but-unmeasured signature, remembering the
        analytical dispatch parameters so re-profiling can tile with them."""
        gk = sig.group()
        with self._lock:
            m = self._misses.setdefault(
                gk, {"count": 0, "delta_o": 0, "delta_i": 0, "backend": ""})
            m["count"] += 1
            if delta_o:
                m["delta_o"], m["delta_i"] = int(delta_o), int(delta_i)
            if backend:
                m["backend"] = backend

    def clear_miss(self, sig: ShapeSig) -> None:
        with self._lock:
            self._misses.pop(sig.group(), None)

    def hottest_misses(self, n: int | None = None) -> list[tuple[ShapeSig,
                                                                 dict]]:
        """Missed signatures by consult count, hottest first."""
        with self._lock:
            items = sorted(self._misses.items(),
                           key=lambda kv: -kv[1]["count"])
        return items if n is None else items[:n]

    def stalest_groups(self, n: int | None = None) -> list[ShapeSig]:
        """Measured groups consulted since their last measurement, oldest
        measurement first — the re-profiler's second-priority queue."""
        with self._lock:
            cands = [(gk, max(e.seq for e in g.values()))
                     for gk, g in self._groups.items()
                     if self._group_hits.get(gk, 0) > 0]
        cands.sort(key=lambda kv: kv[1])
        out = [gk for gk, _ in cands]
        return out if n is None else out[:n]

    # -- dispatch consult --------------------------------------------------

    def adjust_dispatch(self, dispatch: Dispatch, *, n_in: int, n_out: int,
                        c_in: int, c_out: int, density: float,
                        kernel_volume: int = 27) -> Dispatch:
        """Measured-winner override of one analytical ``Dispatch``.

        Cold group: the analytical decision is returned *unchanged* (the
        same object; the miss recorded). On a hit, the cheapest measured
        backend wins: a flip to reference drops the tile parameters; a
        flip to sspnna tiles with the winning measurement's
        ``delta_o``/``delta_i`` (from the analytical decision when the
        measurement carries none).
        """
        gk = signature(n_in, n_out, c_in, c_out, density=density,
                       kernel_volume=kernel_volume)
        best = self.best(gk)
        if best is None:
            self.note_miss(gk, delta_o=dispatch.delta_o,
                           delta_i=dispatch.delta_i,
                           backend=dispatch.backend)
            return dispatch
        with self._lock:
            self.hits += 1
        win = best.sig.backend
        if win == dispatch.backend:
            return dispatch
        if win == REFERENCE:
            return REFERENCE_DISPATCH
        if win == SSPNNA:
            d_o = best.delta_o or dispatch.delta_o
            d_i = best.delta_i or dispatch.delta_i
            if not (d_o and d_i):  # nothing to tile with; keep analytical
                return dispatch
            return Dispatch(SSPNNA, "CIRF", dispatch.walk or "OS",
                            int(d_o), int(d_i), 0)
        return dataclasses.replace(dispatch, backend=win)

    # -- persistence -------------------------------------------------------

    def to_payload(self) -> dict:
        with self._lock:
            entries = [{"sig": e.sig.encode(), "median_us": e.median_us,
                        "spread_us": e.spread_us, "k": e.k,
                        "delta_o": e.delta_o, "delta_i": e.delta_i}
                       for g in self._groups.values() for e in g.values()]
            return {"schema": _SCHEMA, "plan_version": _PLAN_VERSION,
                    "fingerprint": self.fingerprint,
                    "generation": self.generation, "entries": entries}

    def save(self, path: str | None = None) -> str:
        """Atomic write (tmp file + rename), so a crashed writer can never
        leave a truncated cache for the next process to trip on."""
        path = path or default_cache_path()
        payload = self.to_payload()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path: str | None = None, *,
             fingerprint: str | None = None) -> "CostTable":
        """Load a cached table; *any* problem — missing file, corrupt or
        truncated JSON, plan-version or device-fingerprint mismatch —
        yields an empty table (``load_status`` says why) rather than an
        error or a stale measurement."""
        path = path or default_cache_path()
        table = cls(fingerprint=fingerprint)
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            table.load_status = "missing"
            return table
        except (OSError, ValueError, UnicodeDecodeError):
            table.load_status = "corrupt"
            return table
        try:
            if (not isinstance(payload, dict)
                    or payload.get("schema") != _SCHEMA
                    or int(payload.get("plan_version", -1)) != _PLAN_VERSION):
                table.load_status = "version-mismatch"
                return table
            if payload.get("fingerprint") != table.fingerprint:
                table.load_status = "fingerprint-mismatch"
                return table
            for row in payload.get("entries", []):
                table.record(ShapeSig.decode(row["sig"]),
                             float(row["median_us"]),
                             spread_us=float(row.get("spread_us", 0.0)),
                             k=int(row.get("k", 1)),
                             delta_o=int(row.get("delta_o", 0)),
                             delta_i=int(row.get("delta_i", 0)))
            table.generation = int(payload.get("generation", 0))
        except (KeyError, TypeError, ValueError, AttributeError):
            fresh = cls(fingerprint=fingerprint)
            fresh.load_status = "corrupt"
            return fresh
        table.load_status = "ok"
        return table


# ---------------------------------------------------------------------------
# Seeding from bench artifacts
# ---------------------------------------------------------------------------

def _derived_tokens(derived: str) -> dict:
    out = {}
    for tok in derived.split():
        if "=" in tok:
            key, val = tok.split("=", 1)
            out[key] = val
    return out


_SSPNNA_ROW = re.compile(r"sspnna/r(\d+)_.*_(fused|xla)$")


def _seed_row(table: CostTable, name: str, us: float, derived: str,
              kernel_volume: int) -> bool:
    if us <= 0:
        return False
    toks = _derived_tokens(derived)
    if "sig" in toks:  # canonical form: an explicit encoded signature
        try:
            sig = ShapeSig.decode(toks["sig"])
        except ValueError:
            return False
        if not sig.backend:
            return False
        table.record(sig, us,
                     delta_o=int(toks.get("delta_o", 0) or 0),
                     delta_i=int(toks.get("delta_i", 0) or 0))
        return True
    m = _SSPNNA_ROW.match(name)  # sspnna sweep arms: fused / gather-einsum
    if m is None:
        return False
    res, arm = int(m.group(1)), m.group(2)
    try:
        density = float(toks["density"])
        c_in, c_out = int(toks["C"]), int(toks["N"])
        d_o, d_i = int(toks.get("dO", 0)), int(toks.get("dI", 0))
    except (KeyError, ValueError):
        return False
    n_active = max(int(round(density * res ** 3)), 1)
    backend = SSPNNA if arm == "fused" else REFERENCE
    sig = signature(n_active, n_active, c_in, c_out, density=density,
                    kernel_volume=kernel_volume, backend=backend)
    table.record(sig, us,
                 delta_o=d_o if backend == SSPNNA else 0,
                 delta_i=d_i if backend == SSPNNA else 0)
    return True


def seed_cost_table(table: CostTable, paths, *,
                    kernel_volume: int = 27) -> int:
    """Seed measurements from ``bench-rows/v1`` JSON artifacts.

    Two row shapes are understood: rows whose ``derived`` carries an
    explicit ``sig=<encoded>`` token, and SSpNNA sweep rows
    (``sspnna/r<res>_*_{fused,xla}`` — fused maps to the ``sspnna``
    backend, the gather-einsum to ``reference``; a pre-gathered arm matches
    no engine backend and is skipped), whose signature is reconstructed
    from the derived ``density/dO/dI/C/N`` tokens. Unreadable files and
    unrecognized rows are skipped. Returns the number of entries recorded.
    """
    n = 0
    for path in paths:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        for row in payload.get("rows", []) if isinstance(payload, dict) \
                else []:
            try:
                if _seed_row(table, str(row.get("name", "")),
                             float(row.get("us_per_call", 0.0)),
                             str(row.get("derived", "")), kernel_volume):
                    n += 1
            except (TypeError, ValueError):
                continue
    return n


# ---------------------------------------------------------------------------
# Backend profiling
# ---------------------------------------------------------------------------

def measure_backends(plan, feats, params, *, registry=None,
                     warmup: int = 1, k: int = 3,
                     **run_kw) -> dict[str, Measurement]:
    """Measured cost of every registered backend able to run ``plan``
    (one conv site, its tables on ``feats``' device), timed there by
    :func:`measure` under ``torch.inference_mode()``.

    Walks the ``BackendRegistry`` (default ``default_registry()``;
    scene-level backends and those whose ``supports(plan)`` says no are
    skipped), so a newly registered backend is profiled — and therefore
    eligible to win dispatch — without any tuner changes. Returns
    ``{backend_name: Measurement}``.
    """
    if registry is None:
        from repro_torch.engine.backends import default_registry
        registry = default_registry()
    out: dict[str, Measurement] = {}
    with torch.inference_mode():
        for name in registry.names():
            impl = registry.get(name)
            if impl.scene_level or not impl.supports(plan):
                continue
            try:
                out[name] = measure(
                    lambda impl=impl: impl.run(feats, params, plan, **run_kw),
                    warmup=warmup, k=k, device=feats.device)
            except NotImplementedError:
                continue
    return out


def _synth_workload(gk: ShapeSig, *, delta_o: int = 0, delta_i: int = 0,
                    seed: int = 0, device: str | torch.device = "cuda"):
    """A genuine tiled conv workload at a signature's bucketed shape, on
    ``device``: unique random voxels at the bin's representative density,
    real CIRF metadata and tile tables. None when the signature can't be
    realized (non-3^3 kernels, zero rows, un-tileable deltas). The voxels
    are uniform in a cube, not on a room's surfaces."""
    from repro_torch.core.hashgrid import kernel_offsets
    from repro_torch.core.host_meta import build_cirf_np
    from repro_torch.core.sparse_conv import SparseConvParams

    if gk.k != 27 or gk.n_out <= 0 or gk.c_in <= 0 or gk.c_out <= 0:
        return None
    n = max(int(gk.n_out), 8)
    density = _bin_density(gk.density_bin)
    res = int(np.ceil((n / density) ** (1.0 / 3.0)))
    res = min(max(res, 2), 512)
    while res ** 3 <= n:
        res += 1
    total = res ** 3
    rng = np.random.default_rng(seed)
    cells = np.unique(rng.integers(0, total, size=2 * n + 16))
    while cells.size < n:
        cells = np.unique(np.concatenate(
            [cells, rng.integers(0, total, size=n)]))
    cells = rng.permutation(cells)[:n]
    coords = np.stack(np.unravel_index(cells, (res, res, res)),
                      axis=1).astype(np.int32)
    mask = np.ones(n, bool)
    coir = build_cirf_np(coords, mask, coords, mask, kernel_offsets(3), res)
    ordering = np.flatnonzero(mask)
    d_o = min(int(delta_o) or min(64, max(8, n // 8)), n)
    d_i = int(delta_i) or (3 * d_o + gk.k)
    plan = None
    while plan is None:
        try:
            plan = conv_plan_for_layer(coir, ordering, d_o, d_i,
                                       device=device)
        except ValueError:  # plane-split tiles: widen the working set
            if d_i >= n + gk.k:
                return None
            d_i = min(2 * d_i, n + gk.k)
    dev = plan.coir.mask.device
    feats = torch.as_tensor(rng.normal(size=(n, gk.c_in)), dtype=torch.float32,
                            device=dev)
    params = SparseConvParams(
        torch.as_tensor(rng.normal(size=(gk.k, gk.c_in, gk.c_out)) * 0.1,
                        dtype=torch.float32, device=dev),
        torch.zeros((gk.c_out,), dtype=torch.float32, device=dev))
    return plan, feats, params


def profile_group(table: CostTable, sig: ShapeSig, *, delta_o: int = 0,
                  delta_i: int = 0, registry=None, ctx=None, k: int = 3,
                  seed: int = 0, **run_kw) -> dict[str, Measurement]:
    """Measure every runnable backend at one signature group, on
    ``ctx.device`` (the ambient context's without ``ctx``), and record the
    results (clearing the group's miss). Empty when the signature can't be
    synthesized — the miss is dropped so the re-profiler never spins on
    it."""
    if ctx is None:
        from repro_torch.engine.context import current_context
        ctx = current_context()
    gk = sig.group()
    work = _synth_workload(gk, delta_o=delta_o, delta_i=delta_i, seed=seed,
                           device=ctx.device)
    if work is None:
        table.clear_miss(gk)
        return {}
    plan, feats, params = work
    results = measure_backends(
        plan, feats, params,
        registry=ctx.registry if registry is None else registry, k=k,
        **run_kw)
    d = plan.dispatch
    for name, m in results.items():
        table.record(dataclasses.replace(gk, backend=name), m.median_us,
                     spread_us=m.spread_us, k=m.k,
                     delta_o=d.delta_o, delta_i=d.delta_i)
    if not results:
        table.clear_miss(gk)
    return results


def reprofile(table: CostTable, *, registry=None, ctx=None,
              budget_ms: float = 50.0, max_sigs: int | None = None,
              k: int = 2, seed: int = 0, **run_kw) -> int:
    """Budgeted re-profiling pass: hottest missed signatures first, then
    the stalest still-consulted measured ones.

    This is what a ``SceneEngine``'s idle hook runs between waves —
    strictly off the serving hot path (never inside a graph capture), and
    off entirely at ``budget_ms <= 0``. The wall-clock budget is checked
    before each signature, so one pass costs at most ``budget_ms`` plus a
    single signature's profiling time. Returns the number of signature
    groups profiled.
    """
    if budget_ms <= 0:
        return 0
    t0 = time.perf_counter()
    done = 0
    while max_sigs is None or done < max_sigs:
        if (time.perf_counter() - t0) * 1e3 >= budget_ms:
            break
        target, d_o, d_i = None, 0, 0
        misses = table.hottest_misses(1)
        if misses:
            target, m = misses[0]
            d_o, d_i = m["delta_o"], m["delta_i"]
        else:
            stale = table.stalest_groups(1)
            if stale:
                target = stale[0]
        if target is None:
            break
        profile_group(table, target, delta_o=d_o, delta_i=d_i,
                      registry=registry, ctx=ctx, k=k, seed=seed + done,
                      **run_kw)
        done += 1
    return done
