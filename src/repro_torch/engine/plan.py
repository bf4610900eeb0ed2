"""Scene plans: the engine's unit of metadata building and caching (port
of ``repro.engine.plan``).

A ``ScenePlan`` bundles everything the paper builds before running a layer,
per input scene: per-level COIR metadata (the AdMAC pass), the SOAR row
order, the SPADE-selected dataflow as a per-conv ``Dispatch``, and the tile
tables the fused SSpNNA kernel reads. ``build_scene_plan_host`` builds it in
numpy on the host; ``upload_scene_plan`` copies its tables to the device as
torch tensors. ``conv_plan_for_layer`` builds a tiled plan for one
standalone conv site.

Two plan-building modes:

* **adaptive** (``spec=None``): SPADE explores each level on this scene's
  own sparsity attributes. Tile counts match the scene, so plans of two
  scenes may differ in shape.
* **pinned** (``spec=build_plan_spec(...)``): dataflow decisions and tile
  budgets are frozen from representative scenes (the offline flow, §V-C).
  Every plan built from one spec has the same tables' shapes, which is what
  ``serving.scene_engine`` batches through one CUDA graph per capacity
  bucket (``SignatureFamily``).

``PlanCache`` keys plans by scene content, config and build mode, builds
each at most once across threads, and memoizes its device upload.
``StreamPlanState`` plans a LiDAR stream frame by frame, patching the
previous frame's host plan instead of rebuilding it.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.analysis.runtime import ordered_condition, ordered_lock
from repro_torch.core import spade
from repro_torch.core.coir import COIR
from repro_torch.core.hashgrid import kernel_offsets
from repro_torch.core.host_meta import (
    StreamMetaState,
    build_cirf_np,
    downsample_coords_np,
    transposed_coir_np,
)
from repro_torch.core.soar import raster_order, soar_order
from repro_torch.core.tiles import build_tile_plan, dma_tile_tables, max_tiles
from repro_torch.device import host_array, require_device
from repro_torch.serving import faults
from repro_torch.sparse.tensor import SparseVoxelTensor, compact_to_capacity

REFERENCE = "reference"
SSPNNA = "sspnna"

_K_SUB = 27  # submanifold 3^3 kernel volume

# Layout version of the plan's array leaves, mixed into every PlanCache key
# so a plan cached under an older table layout is never served to a kernel
# that reads the new one (the JAX package's number; the port's tables have
# its layout).
_PLAN_VERSION = 4

_NO_BLOCK_N = (
    "tune_block_n= has no counterpart in the port: the CUDA SSpNNA kernels "
    "have no N-block to tune (the launch geometry picks its own N split; "
    "ROADMAP.md, queue 1, slice 7)")


def _fault_injector():
    """The ambient serving-layer fault injector (``serving.faults``), if
    one is installed."""
    return faults.active()


@dataclass(frozen=True)
class Dispatch:
    """Static per-conv execution decision. ``n_tiles`` is the tile budget:
    a pinned spec's budget is honoured when a plan is built
    (``build_tile_plan(n_tiles=)``), and a scene that needs more tiles goes
    to ``reference`` (``info["tile_overflow"]``); an adaptive plan records
    the tiles it got. The JAX package's ``block_n`` has no counterpart: the
    CUDA kernel picks its own N split."""

    backend: str = REFERENCE
    flavor: str = "CIRF"
    walk: str = "OS"
    delta_o: int = 0
    delta_i: int = 0
    n_tiles: int = 0


REFERENCE_DISPATCH = Dispatch()


class TileArrays(NamedTuple):
    """Tile metadata in the kernel layout (``core.tiles.dma_tile_tables``):
    ``in_rows`` pads clamped to row 0, ``out_rows`` pads pointed at the
    trash row ``n_out``, ``pair_counts`` 0 on a dead tile."""

    out_rows: Any     # (T, dO) int32
    in_rows: Any      # (T, dI) int32
    local_idx: Any    # (T, dO, K) int32, -1 holes
    pair_counts: Any  # (T,) int32


@dataclass
class ConvPlan:
    """Plan for one conv site: COIR metadata + optional tile metadata."""

    coir: COIR
    tiles: TileArrays | None = None
    dispatch: Dispatch = REFERENCE_DISPATCH


class LevelPlan(NamedTuple):
    """One U-Net level: active set + its three conv sites."""

    coords: Any
    mask: Any
    sub: ConvPlan           # submanifold 3^3 conv at this level
    down: ConvPlan | None   # strided 2^3 s2 conv to the next level
    up: ConvPlan | None     # transposed conv back to this level


@dataclass
class ScenePlan:
    """Per-scene execution plan. ``stats`` holds host-only diagnostics (ARF,
    chosen dataflows) per level. ``n_scenes > 1`` marks a wave plan
    (``stack_plans``): the tables of ``n_scenes`` plans of one
    signature, concatenated along their rows, each scene's as it was
    built."""

    levels: tuple[LevelPlan, ...]
    stats: list[dict] | None = None
    n_scenes: int = 1

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device | None:
        """Device of the plan's tables; None for a host (numpy) plan."""
        mask = self.levels[0].mask
        return mask.device if isinstance(mask, torch.Tensor) else None


@dataclass(frozen=True)
class PlanSpec:
    """Pinned per-level dispatch decisions: every plan built from one spec
    has the same dispatches and tables' shapes (one CUDA graph)."""

    levels: tuple[Dispatch, ...]


@dataclass(frozen=True)
class SignatureFamily:
    """A small family of pinned signatures: voxel-capacity buckets.

    Single-signature serving pads every scene to one capacity; a family
    keeps a handful of capacity tiers chosen from observed request sizes,
    each tier its own pinned ``PlanSpec`` (``None``: reference plans at
    that capacity). The scene engine captures one CUDA graph per bucket on
    first use, so mixed traffic captures at most ``n_buckets``.

    ``capacities`` must be ascending; ``specs`` pairs each capacity with
    its spec.
    """

    capacities: tuple[int, ...]
    specs: tuple[PlanSpec | None, ...] = ()

    def __post_init__(self):
        if not self.capacities:
            raise ValueError("SignatureFamily needs at least one capacity")
        if list(self.capacities) != sorted(set(self.capacities)):
            raise ValueError(
                f"capacities must be ascending+unique, got {self.capacities}")
        if not self.specs:
            object.__setattr__(
                self, "specs", (None,) * len(self.capacities))
        if len(self.specs) != len(self.capacities):
            raise ValueError(
                f"{len(self.specs)} specs for {len(self.capacities)} buckets")

    @property
    def n_buckets(self) -> int:
        return len(self.capacities)

    @property
    def max_capacity(self) -> int:
        return self.capacities[-1]

    def bucket_for(self, n_voxels: int) -> int | None:
        """Smallest bucket capacity fitting ``n_voxels`` active voxels;
        None when the scene exceeds every bucket (callers shed it)."""
        for cap in self.capacities:
            if n_voxels <= cap:
                return cap
        return None

    def spec_for(self, capacity: int) -> PlanSpec | None:
        return self.specs[self.capacities.index(capacity)]


def choose_buckets(sizes, max_buckets: int = 4, *,
                   quantum: int = 64) -> tuple[int, ...]:
    """Capacity tiers from observed request sizes (active-voxel counts):
    quantile cuts over the observed distribution, rounded up to
    ``quantum`` multiples and deduplicated; the top tier covers the largest
    observed scene. Ascending, at most ``max_buckets`` of them."""
    sizes = [int(s) for s in sizes]
    if not sizes:
        raise ValueError("choose_buckets needs at least one observed size")
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    arr = np.sort(np.asarray(sizes))
    qs = np.linspace(0.0, 1.0, max_buckets + 1)[1:]
    caps = sorted({
        int(np.ceil(float(np.quantile(arr, q)) / quantum)) * quantum
        for q in qs})
    return tuple(caps)


def build_signature_family(
    scenes: list[SparseVoxelTensor],
    cfg,
    *,
    max_buckets: int = 4,
    quantum: int = 64,
    pin_specs: bool = True,
    **spec_kw,
) -> SignatureFamily:
    """Freeze a bucket family from representative scenes: buckets from
    their active-voxel counts (``choose_buckets``); with ``pin_specs`` each
    bucket gets the ``build_plan_spec`` of the scenes that fit it,
    compacted to its capacity (``spec_kw`` goes there). A bucket no scene
    fits keeps ``spec=None``."""
    sizes = [int(np.asarray(t.mask).sum()) for t in scenes]
    caps = choose_buckets(sizes, max_buckets, quantum=quantum)
    specs: list[PlanSpec | None] = []
    for cap in caps:
        reps = [compact_to_capacity(t, cap)[0]
                for t, n in zip(scenes, sizes) if n <= cap]
        if pin_specs and reps:
            specs.append(build_plan_spec(reps, replace(cfg, capacity=cap),
                                         **spec_kw))
        else:
            specs.append(None)
    return SignatureFamily(caps, tuple(specs))


# ---------------------------------------------------------------------------
# Scene keys + plan cache
# ---------------------------------------------------------------------------

def scene_key(t: SparseVoxelTensor, tag: str = "") -> str:
    """Content hash of a scene's active geometry (features do not change
    the plan, so they are left out)."""
    h = hashlib.sha1()
    h.update(host_array(t.coords).tobytes())
    h.update(host_array(t.mask).tobytes())
    h.update(tag.encode())
    return h.hexdigest()


class PlanCache:
    """Thread-safe LRU cache of ScenePlans keyed by scene content + config.

    Concurrent ``get_or_build`` calls for one scene coalesce: the first
    caller builds (outside the lock), the others wait on a per-key event and
    get the same plan object. Each entry holds the host plan (numpy leaves,
    what planner threads produce) and its device uploads, made on first
    request and memoized per device: ``device=False`` returns the host
    plan, ``device=True`` the upload to the card, ``device=<a device>`` the
    upload there.

    If a build raises, the key is released and every waiter coalesced on it
    raises the builder's exception; a later caller builds afresh, so a
    failing scene never wedges the cache. ``max_entries`` (default
    ``capacity``) bounds the entries, host and device copies together, with
    LRU eviction.
    """

    def __init__(self, capacity: int = 128, *,
                 max_entries: int | None = None):
        self.capacity = capacity
        self.max_entries = capacity if max_entries is None else int(max_entries)
        if self.max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._plans: OrderedDict[str, dict] = OrderedDict()
        # key -> {"ev": Event, "error": BaseException | None}; the error is
        # set before the event so coalesced waiters see the failure
        self._building: dict[str, dict] = {}
        self._lock = ordered_lock("plan_cache")
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def invalidate(self) -> int:
        """Drop every cached entry (in-flight builds insert theirs when they
        land); returns the number dropped."""
        with self._lock:
            n = len(self._plans)
            self._plans.clear()
            self.invalidations += 1
        return n

    @staticmethod
    def _new_entry(host: ScenePlan) -> dict:
        return {"host": host, "device": {},
                "dev_lock": ordered_lock("plan_cache.dev")}

    @staticmethod
    def _resolve(entry: dict, device) -> ScenePlan:
        """The host plan, or its memoized upload (made outside the global
        lock, so planner threads never stall behind an upload)."""
        if device is False:
            return entry["host"]
        dev = require_device("cuda" if device is True else device)
        uploads = entry["device"]
        if str(dev) not in uploads:
            with entry["dev_lock"]:
                if str(dev) not in uploads:
                    host = entry["host"]
                    upload = getattr(host, "device_upload", None)
                    uploads[str(dev)] = (upload(dev) if upload is not None
                                         else upload_scene_plan(host, dev))
        return uploads[str(dev)]

    def key_for(self, t: SparseVoxelTensor, cfg, *, topology: str | None = None,
                **build_kw) -> str:
        """Cache key of scene ``t`` under ``cfg`` and the build mode: an
        O(V) content hash (hot paths compute it once and pass ``key=``),
        with the table-layout version and ``topology``
        (``ExecutionContext.topology_key()``) mixed in."""
        tag = (f"v{_PLAN_VERSION}|top={topology}|{cfg!r}|"
               f"{sorted(build_kw.items())!r}")
        return scene_key(t, tag)

    def get_or_build(self, t: SparseVoxelTensor, cfg, *,
                     device: bool | str | torch.device = True,
                     key: str | None = None, topology: str | None = None,
                     builder=None, **build_kw) -> ScenePlan:
        """The plan of scene ``t`` under ``cfg``, built at most once across
        threads. ``key`` skips re-hashing (it must equal
        ``key_for(t, cfg, topology=..., **build_kw)``); ``builder`` swaps
        the host builder (default ``build_scene_plan_host``)."""
        if builder is None:
            builder = build_scene_plan_host
        if key is None:
            key = self.key_for(t, cfg, topology=topology, **build_kw)
        while True:
            with self._lock:
                entry = self._plans.get(key)
                if entry is not None:
                    self.hits += 1
                    self._plans.move_to_end(key)
                else:
                    rec = self._building.get(key)
                    if rec is None:  # this thread builds
                        rec = {"ev": threading.Event(), "error": None}
                        self._building[key] = rec
                        break
            if entry is not None:
                return self._resolve(entry, device)
            rec["ev"].wait()  # another thread is building this plan
            if rec["error"] is not None:
                raise rec["error"]
            # the build landed: loop and read the cache
        try:
            inj = _fault_injector()
            if inj is not None:
                inj.maybe_fail("plan_build", key=key)
            host = builder(t, cfg, **build_kw)
        except BaseException as e:
            with self._lock:
                self._building.pop(key, None)
            rec["error"] = e
            rec["ev"].set()
            raise
        entry = self._new_entry(host)
        with self._lock:
            self.misses += 1
            self._plans[key] = entry
            while len(self._plans) > self.max_entries:
                self._plans.popitem(last=False)
            self._building.pop(key, None)
            rec["ev"].set()
        return self._resolve(entry, device)

    def adopt(self, key: str, host_plan: ScenePlan, *,
              device: bool | str | torch.device = True) -> ScenePlan:
        """The entry at ``key`` for an already-built host plan, re-inserting
        ``host_plan`` if LRU pressure evicted it: never builds, never
        hashes, never counts. The dispatch stage's path: the plan stage
        built (and counted) the plan, dispatch needs its upload."""
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                self._plans.move_to_end(key)
            else:
                entry = self._new_entry(host_plan)
                self._plans[key] = entry
                while len(self._plans) > self.max_entries:
                    self._plans.popitem(last=False)
        return self._resolve(entry, device)

    def __len__(self) -> int:
        return len(self._plans)


def level_geometry(t: SparseVoxelTensor, cfg) -> list[tuple]:
    """(coords, mask, resolution) of each U-Net pyramid level, as numpy.
    ``cfg`` is any config exposing ``resolution`` and ``widths``."""
    out = []
    coords, mask, res = np.asarray(t.coords), np.asarray(t.mask), cfg.resolution
    for li in range(len(cfg.widths)):
        out.append((coords, mask, res))
        if li < len(cfg.widths) - 1:
            coords, mask = downsample_coords_np(coords, mask, res, 2)
            res //= 2
    return out


def _order_rows(sub_coir: COIR, coords, mask, how: str, chunk: int) -> np.ndarray:
    """Ordering of active rows for tiling: SOAR (paper), raster, or active
    (occupancy order, cheapest)."""
    mask_np = np.asarray(mask)
    if how == "soar":
        # the submanifold CIRF *is* the adjacency map (self at the center)
        return soar_order(np.asarray(sub_coir.indices), mask_np, chunk).order
    if how == "raster":
        return raster_order(np.asarray(coords), mask_np)
    return np.flatnonzero(mask_np)


def dispatch_from_dataflow(
    df: spade.Dataflow,
    attrs: spade.SparsityAttributes,
    n_majors: int,
    kernel_volume: int = _K_SUB,
) -> Dispatch:
    """Map a SPADE dataflow onto an engine backend decision.

    The tiled SSpNNA path serves out-major (CIRF) plans whose tile height is
    an actual tiling (``delta_o < n_majors``); CORF plans and whole-layer
    tiles are the coarse single dispatch, i.e. the reference product.
    ``delta_i`` is sized from the SST allocation attribute so tiles fit
    without splitting in the common case.
    """
    if df.flavor != "CIRF" or df.delta_major >= n_majors:
        return REFERENCE_DISPATCH
    d_o = int(df.delta_major)
    d_i = min(
        n_majors,
        int(np.ceil(d_o * attrs.at(d_o, "sa_minor_alloc_sst"))) + kernel_volume,
    )
    return Dispatch(SSPNNA, df.flavor, df.walk, d_o, d_i)


def _layer_spec(name: str, v: int, c: int) -> spade.LayerSpec:
    return spade.LayerSpec(name, v, v, _K_SUB, c, c, 2)


def build_plan_spec(
    scenes: list[SparseVoxelTensor],
    cfg,
    *,
    mem_budget: int = 64 * 1024,
    order: str = "soar",
    soar_chunk: int = 512,
    tile_margin: float = 2.0,
    tune_block_n=None,
    autotune=None,
) -> PlanSpec:
    """Freeze per-level dispatch decisions from representative scenes.

    The offline-SPADE flow (§V-C): extract sparsity attributes per scene and
    level, aggregate them into meta-attributes (MSA), run the design-space
    sweep once at ``cfg.capacity`` rows, and pin the winning dataflow. Tile
    budgets take the analytic bound capped at ``tile_margin`` times the
    worst observed count, so plans keep their shapes without drowning in
    padding tiles.

    ``autotune`` is an optional measured :class:`~repro_torch.engine.
    autotune.CostTable`: each level's analytical decision is overridden by
    the cheapest *measured* backend at the level's shape signature when the
    table has one, and left untouched (miss recorded) when it doesn't — a
    cold table reproduces the analytical spec exactly. ``tune_block_n``
    raises: the CUDA kernels have no N-block.
    """
    if tune_block_n is not None:
        raise NotImplementedError(_NO_BLOCK_N)
    offs3 = kernel_offsets(3)
    n_levels = len(cfg.widths)
    per_level: list[list[spade.SparsityAttributes]] = [[] for _ in range(n_levels)]
    observed_tiles = [0] * n_levels
    level_density = [0.0] * n_levels
    geo_attrs = []
    for t in scenes:
        rows = []
        for li, (coords, mask, res) in enumerate(level_geometry(t, cfg)):
            coir = build_cirf_np(coords, mask, coords, mask, offs3, res)
            ordering = _order_rows(coir, coords, mask, order, soar_chunk)
            per_level[li].append(spade.extract_attributes(
                np.asarray(coir.indices), np.asarray(mask), ordering))
            level_density[li] += (float(np.asarray(mask).sum())
                                  / float(max(res, 1)) ** 3 / len(scenes))
            rows.append((coir, ordering))
        geo_attrs.append(rows)

    dispatches = []
    for li in range(n_levels):
        msa = spade.meta_attributes(per_level[li])
        layer = _layer_spec(f"level{li}", cfg.capacity, cfg.widths[li])
        df = spade.explore(layer, {"CIRF": msa, "CORF": msa}, mem_budget)
        d = dispatch_from_dataflow(df, msa, cfg.capacity)
        if autotune is not None:
            d = autotune.adjust_dispatch(
                d, n_in=cfg.capacity, n_out=cfg.capacity,
                c_in=cfg.widths[li], c_out=cfg.widths[li],
                density=level_density[li], kernel_volume=_K_SUB)
        if d.backend == SSPNNA:
            # worst observed tile count across the representative scenes
            for rows in geo_attrs:
                coir, ordering = rows[li]
                tp = build_tile_plan(
                    np.asarray(coir.indices), ordering, d.delta_o, d.delta_i)
                observed_tiles[li] = max(observed_tiles[li], tp.n_tiles)
            bound = max_tiles(cfg.capacity, d.delta_o, d.delta_i, _K_SUB)
            n_tiles = min(bound,
                          int(np.ceil(tile_margin * observed_tiles[li])) + 2)
            d = replace(d, n_tiles=n_tiles)
        dispatches.append(d)
    return PlanSpec(tuple(dispatches))


def _tile_arrays(cirf_indices, ordering, dispatch: Dispatch,
                 n_out: int) -> TileArrays | None:
    """Fixed-shape tile metadata (kernel layout) for one conv, padded to
    the dispatch's tile budget when it has one (``n_tiles``); None when the
    scene needs more tiles than the budget, or shared-output-row tiles,
    which the fused kernel cannot serve (the caller then dispatches the
    conv to reference)."""
    try:
        tp = build_tile_plan(
            np.asarray(cirf_indices), ordering, dispatch.delta_o,
            dispatch.delta_i,
            n_tiles=dispatch.n_tiles if dispatch.n_tiles else None)
    except ValueError:  # over the budget
        return None
    if tp.n_row_splits:  # the kernel's store overwrites; can't share rows
        return None
    dma = dma_tile_tables(tp, n_out)
    return TileArrays(dma.out_rows, dma.in_rows,
                      np.asarray(tp.local_idx), dma.pair_counts)


def _assemble_level(
    sub_coir: COIR,
    coords,
    mask,
    li: int,
    cfg,
    *,
    spec: PlanSpec | None,
    plan_tiles: bool,
    mem_budget: int,
    order: str,
    soar_chunk: int,
    autotune=None,
    breakers=None,
) -> tuple[ConvPlan, dict]:
    """Dispatch, ordering and tile assembly for one level's submanifold
    conv: the spec's pinned decision, or SPADE on this scene's own
    attributes (overridden by ``autotune``'s measured winner where it has
    one). ``breakers`` (a ``BreakerBoard``) reroutes a tripped backend
    along its fallback chain. Deterministic in ``(sub_coir, coords,
    mask)`` for a fixed table and board state, which the streaming planner
    relies on."""
    n_active = int(np.asarray(mask).sum())
    info: dict = {"level": li, "n_active": n_active}
    dispatch = REFERENCE_DISPATCH
    tiles = None
    if plan_tiles and n_active > 0:
        if spec is not None:
            dispatch = spec.levels[li]
        else:
            ordering = _order_rows(sub_coir, coords, mask, order, soar_chunk)
            attrs = spade.extract_attributes(
                np.asarray(sub_coir.indices), np.asarray(mask), ordering)
            layer = _layer_spec(f"level{li}", n_active, cfg.widths[li])
            df = spade.explore(layer, {"CIRF": attrs, "CORF": attrs},
                               mem_budget)
            dispatch = dispatch_from_dataflow(df, attrs, n_active)
            info["arf"] = float(attrs.arf_avg[0])
            info["da_elems"] = df.da_elems
            if autotune is not None:
                # measured-winner consult; a miss (recorded) keeps the
                # analytical decision unchanged
                res3 = float(max(cfg.resolution >> li, 1)) ** 3
                dispatch = autotune.adjust_dispatch(
                    dispatch, n_in=n_active, n_out=n_active,
                    c_in=cfg.widths[li], c_out=cfg.widths[li],
                    density=n_active / res3, kernel_volume=_K_SUB)
                info["autotuned"] = dispatch.backend
        if breakers is not None and dispatch.backend != REFERENCE:
            # circuit-breaker consult at *build* time: the rerouted
            # dispatch lands in the plan's signature, so the serving
            # engine runs it on another graph
            routed = breakers.route(dispatch.backend)
            if routed != dispatch.backend:
                info["breaker_rerouted"] = (dispatch.backend, routed)
                dispatch = (REFERENCE_DISPATCH if routed == REFERENCE
                            else replace(dispatch, backend=routed))
        if dispatch.backend == SSPNNA:
            if spec is not None:
                ordering = _order_rows(sub_coir, coords, mask, order,
                                       soar_chunk)
            tiles = _tile_arrays(sub_coir.indices, ordering, dispatch,
                                 int(np.asarray(mask).shape[0]))
            if tiles is None:  # over the tile budget, or plane-split tiles
                info["tile_overflow"] = True
                dispatch = REFERENCE_DISPATCH
            elif not dispatch.n_tiles:  # adaptive: record the tile count
                dispatch = replace(dispatch,
                                   n_tiles=int(tiles.out_rows.shape[0]))
    info["dispatch"] = dispatch
    return ConvPlan(sub_coir, tiles, dispatch), info


def _build_scene_plan(t, cfg, *, spec, plan_tiles, mem_budget, order,
                      soar_chunk, autotune=None, breakers=None) -> ScenePlan:
    if spec is not None and len(spec.levels) != len(cfg.widths):
        raise ValueError(
            f"spec has {len(spec.levels)} levels but cfg has "
            f"{len(cfg.widths)}: was it built from another config?")
    offs2 = kernel_offsets(2, centered=False)
    offs3 = kernel_offsets(3)
    geometry = level_geometry(t, cfg)
    levels: list[LevelPlan] = []
    stats: list[dict] = []
    for li, (coords, mask, res) in enumerate(geometry):
        sub_coir = build_cirf_np(coords, mask, coords, mask, offs3, res)
        down = up = None
        if li < len(cfg.widths) - 1:
            dn_coords, dn_mask, _ = geometry[li + 1]
            down_coir = build_cirf_np(
                dn_coords, dn_mask, coords, mask, offs2, res, stride=2)
            up_coir = transposed_coir_np(dn_coords, dn_mask, coords, mask,
                                         res, 2, 2)
            # resolution-changing convs stay on the coarse single dispatch
            down = ConvPlan(down_coir)
            up = ConvPlan(up_coir)
        sub, info = _assemble_level(
            sub_coir, coords, mask, li, cfg, spec=spec, plan_tiles=plan_tiles,
            mem_budget=mem_budget, order=order, soar_chunk=soar_chunk,
            autotune=autotune, breakers=breakers)
        stats.append(info)
        levels.append(LevelPlan(coords, mask, sub, down, up))
    return ScenePlan(tuple(levels), stats)


def conv_plan_for_layer(
    coir: COIR,
    ordering: np.ndarray,
    delta_o: int,
    delta_i: int,
    *,
    walk: str = "OS",
    n_tiles: int | None = None,
    device: str | torch.device = "cuda",
) -> ConvPlan:
    """Tiled ConvPlan for a standalone conv site, its COIR and tile tables
    on ``device``. ``coir`` may hold numpy arrays or tensors on any device;
    the tiles are planned on the host.

    Plane-split plans (a ``delta_i`` below one row's working set, forcing
    shared output rows) are rejected here, as in the JAX package: pick a
    working-set budget that fits one row.
    """
    dev = require_device(device)
    tp = build_tile_plan(host_array(coir.indices), host_array(ordering),
                         delta_o, delta_i, n_tiles=n_tiles)
    if tp.n_row_splits:
        raise ValueError(
            f"delta_i={delta_i} forces {tp.n_row_splits} plane-split tiles; "
            "the fused kernel needs disjoint output rows — raise delta_i")
    dma = dma_tile_tables(tp, int(coir.mask.shape[0]))

    def put(x):
        return torch.as_tensor(host_array(x), device=dev)

    tiles = TileArrays(put(dma.out_rows), put(dma.in_rows), put(tp.local_idx),
                       put(dma.pair_counts))
    return ConvPlan(COIR(*(put(x) for x in coir)), tiles,
                    Dispatch(SSPNNA, "CIRF", walk, delta_o, delta_i,
                             tp.n_tiles))


def _map_leaves(plan: ScenePlan, convert) -> ScenePlan:
    """Apply ``convert`` to every array leaf, keeping the dispatch
    decisions and the host-only stats."""

    def conv(cp: ConvPlan | None) -> ConvPlan | None:
        if cp is None:
            return None
        coir = COIR(*(convert(x) for x in cp.coir))
        tiles = (None if cp.tiles is None
                 else TileArrays(*(convert(x) for x in cp.tiles)))
        return ConvPlan(coir, tiles, cp.dispatch)

    levels = tuple(
        LevelPlan(convert(lvl.coords), convert(lvl.mask), conv(lvl.sub),
                  conv(lvl.down), conv(lvl.up))
        for lvl in plan.levels)
    return ScenePlan(levels, plan.stats, plan.n_scenes)


def plan_leaves(plan: ScenePlan) -> list:
    """The plan's array leaves in ``_map_leaves``' order."""
    out: list = []
    _map_leaves(plan, lambda x: out.append(x) or x)
    return out


def plan_signature(plan: ScenePlan) -> tuple:
    """What a compiled forward depends on: the scene count, every conv's
    dispatch (None for a missing conv, and whether it has tiles), and each
    leaf's shape and dtype. Plans of one pinned spec and capacity share
    it."""
    convs = tuple(
        (cp.dispatch, cp.tiles is not None) if cp is not None else None
        for lvl in plan.levels for cp in (lvl.sub, lvl.down, lvl.up))
    shapes = tuple((tuple(x.shape), x.dtype) for x in plan_leaves(plan))
    return plan.n_scenes, convs, shapes


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 tables (the host bitmask) viewed as int32: the same bits, in a
    dtype every device op takes."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def stack_plans(plans: list[ScenePlan], out: ScenePlan | None = None
                ) -> ScenePlan:
    """A wave plan of ``len(plans)`` uploaded plans of one signature: each
    table concatenated along its rows, every scene's as it was built
    (``engine.api.apply_unet`` moves each scene's rows to its place in the
    wave). With ``out`` (a wave plan of the same signature) the tables are
    written into its leaves in place, which is what a captured CUDA graph
    reads; it is returned."""
    sig = plan_signature(plans[0])
    if any(plan_signature(p) != sig for p in plans[1:]):
        raise ValueError("stack_plans needs plans of one signature")
    columns = [[_as_int32(x) for x in col]
               for col in zip(*(plan_leaves(p) for p in plans))]
    if out is None:
        it = iter([torch.cat(col).view(first.dtype) for col, first
                   in zip(columns, plan_leaves(plans[0]))])
        return ScenePlan(_map_leaves(plans[0], lambda x: next(it)).levels,
                         None, len(plans))
    if (out.n_scenes != len(plans)
            or plan_signature(out)[1] != sig[1]):
        raise ValueError("out is not a wave plan of these plans' signature")
    for col, dst in zip(columns, plan_leaves(out), strict=True):
        dst = _as_int32(dst)
        if dst.shape != (sum(x.shape[0] for x in col),) + col[0].shape[1:]:
            raise ValueError(f"out's table {tuple(dst.shape)} does not hold "
                             f"{len(col)} of {tuple(col[0].shape)}")
        torch.cat(col, out=dst)
    return out


def build_scene_plan_host(
    t: SparseVoxelTensor,
    cfg,
    *,
    spec: PlanSpec | None = None,
    plan_tiles: bool = True,
    mem_budget: int = 64 * 1024,
    order: str = "soar",
    soar_chunk: int = 512,
    autotune=None,
    breakers=None,
) -> ScenePlan:
    """AdMAC metadata + SOAR ordering + SPADE selection (or the ``spec``'s
    pinned decisions) + tile tables for one scene, all leaves numpy. Pair
    with ``upload_scene_plan``; safe to call from planner threads.

    ``plan_tiles=False`` skips ordering and attribute extraction and gives
    an all-reference plan. ``autotune`` (a measured ``CostTable``) overrides
    adaptive decisions with measured winners; ``breakers`` (a
    ``BreakerBoard``) reroutes tripped backends."""
    plan = _build_scene_plan(t, cfg, spec=spec, plan_tiles=plan_tiles,
                             mem_budget=mem_budget, order=order,
                             soar_chunk=soar_chunk, autotune=autotune,
                             breakers=breakers)
    return _map_leaves(plan, np.asarray)


def build_scene_plan(
    t: SparseVoxelTensor,
    cfg,
    *,
    spec: PlanSpec | None = None,
    plan_tiles: bool = True,
    mem_budget: int = 64 * 1024,
    order: str = "soar",
    soar_chunk: int = 512,
    autotune=None,
    breakers=None,
    device: str | torch.device = "cuda",
) -> ScenePlan:
    """One AdMAC + SOAR + SPADE pass -> a ScenePlan on ``device``:
    ``build_scene_plan_host`` then ``upload_scene_plan``."""
    return upload_scene_plan(build_scene_plan_host(
        t, cfg, spec=spec, plan_tiles=plan_tiles, mem_budget=mem_budget,
        order=order, soar_chunk=soar_chunk, autotune=autotune,
        breakers=breakers), device)


def upload_scene_plan(plan: ScenePlan, device: str | torch.device = "cuda"
                      ) -> ScenePlan:
    """Copy a host plan's tables to ``device`` as torch tensors (same
    dtypes: int32 tables, bool masks, uint32 bitmasks)."""
    dev = require_device(device)
    return _map_leaves(plan, lambda x: torch.as_tensor(np.asarray(x), device=dev))


# ---------------------------------------------------------------------------
# Streaming plans
# ---------------------------------------------------------------------------

class StreamPlanState:
    """Per-stream incremental planner: cached host plan + device buffers.

    One instance per LiDAR stream. ``plan_frame`` diffs each frame against
    the stream's cached previous frame (``core.host_meta.StreamMetaState``),
    patches the host plan's metadata tables instead of rebuilding them, and
    reuses the previous frame's ``ConvPlan`` objects outright for levels the
    delta did not touch. A changed level reruns its ordering, tiles and
    dispatch (``_assemble_level``), as in the JAX package. Every frame's
    host plan is also registered in the shared :class:`PlanCache` under a
    version key (``stream|<id>|...|f<frame_no>``) so stream plans live under
    the same LRU budget as one-shot plans.

    Frames must be planned in order; ``plan_frame`` blocks until the
    previous frame of this stream has been planned. If the wait exceeds
    ``wait_s`` (a predecessor was shed or errored), the frame is planned as
    a full rebuild so a lost frame can never wedge the stream.

    ``device_plan`` uploads to ``device`` (the card unless the caller says
    otherwise) and memoizes uploads per leaf *identity*: unchanged tables
    keep their device tensors across frames, so a patched frame uploads
    only the arrays that changed (``last_upload`` counts them). It is not
    thread-safe — call it from a single dispatch thread (as
    ``serving.scene_engine`` does).
    """

    def __init__(self, cfg, *, cache: PlanCache | None = None,
                 spec: PlanSpec | None = None,
                 plan_tiles: bool | None = None,
                 mem_budget: int = 64 * 1024, order: str = "soar",
                 soar_chunk: int = 512, min_overlap: float = 0.5,
                 stream_id: str | None = None, topology: str | None = None,
                 wait_s: float = 5.0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.cache = cache if cache is not None else PlanCache()
        self.spec = spec
        self.plan_tiles = (spec is not None) if plan_tiles is None \
            else bool(plan_tiles)
        self.mem_budget = mem_budget
        self.order = order
        self.soar_chunk = soar_chunk
        self.min_overlap = float(min_overlap)
        self.wait_s = float(wait_s)
        self.device = torch.device(device)
        self.stream_id = stream_id if stream_id is not None \
            else f"s{id(self):x}"
        self._tag = (f"stream|{self.stream_id}|v{_PLAN_VERSION}"
                     f"|top={topology}|{cfg!r}|spec={spec is not None}"
                     f"|tiles={self.plan_tiles}|{order}|{soar_chunk}")
        self.meta = StreamMetaState(cfg.resolution, cfg.capacity,
                                    len(cfg.widths))
        self._cond = ordered_condition("stream.plan")
        self._next_frame = 0
        self._gap = False
        self._prev_plan: ScenePlan | None = None
        self._memo: dict = {}
        #: bytes and leaves the last ``device_plan`` copied, of the plan's
        self.last_upload: dict = {}
        self.counts = {"reused": 0, "patched": 0, "rebuilt": 0}
        self._overlap_sum = 0.0
        self._plan_ms_sum = 0.0

    # -- planning ----------------------------------------------------------

    def plan_frame(self, t: SparseVoxelTensor, frame_no: int,
                   ego_shift=(0, 0, 0)) -> tuple[str, ScenePlan, np.ndarray,
                                                 dict]:
        """Plan one stream frame; returns ``(key, host_plan, frame_rows,
        info)``. ``frame_rows`` maps the caller's rows into the stream's
        canonical layout (feed it to ``pack_stream_frame_np`` for features
        and to scatter per-row results back out)."""
        with self._cond:
            deadline = time.monotonic() + self.wait_s
            while self._next_frame < frame_no:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            try:
                t0 = time.perf_counter()
                if self._next_frame != frame_no or self._gap:
                    # gap in the stream (shed/failed predecessor, or an
                    # out-of-order replay): the cached delta base is stale
                    self.meta.n = None
                self._gap = False
                meta = self.meta.step(host_array(t.coords),
                                      host_array(t.mask), ego_shift,
                                      min_overlap=self.min_overlap)
                plan = self._assemble(meta)
                plan_ms = (time.perf_counter() - t0) * 1e3
                self._prev_plan = plan
                self.counts[meta.mode] += 1
                self._overlap_sum += meta.overlap
                self._plan_ms_sum += plan_ms
                key = f"{self._tag}|f{frame_no}"
                self.cache.adopt(key, plan, device=False)
                info = {"mode": meta.mode, "overlap": meta.overlap,
                        "plan_ms": plan_ms,
                        "n_active": meta.info.get("n_active")}
                if "fallback" in meta.info:
                    info["fallback"] = meta.info["fallback"]
                return key, plan, meta.frame_rows, info
            finally:
                self._next_frame = max(self._next_frame, frame_no + 1)
                self._cond.notify_all()

    def skip_frame(self, frame_no: int) -> None:
        """Mark a shed/failed frame so its successors stop waiting for it.

        The serving layer calls this when admission sheds a stream frame
        (deadline/overload): the next planned frame rebuilds from scratch
        — its delta base, and the reference point of the caller's
        ``ego_shift``, is the frame that never arrived."""
        with self._cond:
            if frame_no >= self._next_frame:
                self._gap = True
                self._next_frame = frame_no + 1
                self._cond.notify_all()

    def _assemble(self, meta) -> ScenePlan:
        prev = self._prev_plan
        if meta.mode == "reused" and prev is not None:
            return prev
        n_levels = self.meta.n_levels
        levels: list[LevelPlan] = []
        stats: list[dict] = []
        for li in range(n_levels):
            coords, mask, sub_coir = meta.levels[li]
            if prev is not None and not meta.changed[li]:
                # untouched level: identical tables => identical ordering,
                # tiles and dispatch; reuse the ConvPlan object wholesale
                sub = prev.levels[li].sub
                info = dict(prev.stats[li]) if prev.stats else {"level": li}
            else:
                sub, info = _assemble_level(
                    sub_coir, coords, mask, li, self.cfg, spec=self.spec,
                    plan_tiles=self.plan_tiles, mem_budget=self.mem_budget,
                    order=self.order, soar_chunk=self.soar_chunk)
            down = up = None
            if li < n_levels - 1:
                if prev is not None and not meta.pair_changed[li]:
                    down = prev.levels[li].down
                    up = prev.levels[li].up
                else:
                    down_coir, up_coir = meta.pairs[li]
                    down = ConvPlan(down_coir)
                    up = ConvPlan(up_coir)
            levels.append(LevelPlan(coords, mask, sub, down, up))
            stats.append(info)
        return ScenePlan(tuple(levels), stats)

    # -- device upload with per-leaf memoization ---------------------------

    def device_plan(self, host_plan: ScenePlan) -> ScenePlan:
        """Upload a stream host plan to the state's device, reusing the
        device tensors of leaves that are the *same array object* as the
        previous frame's (patched frames share every untouched table).
        Single-threaded by contract."""
        dev = require_device(self.device)
        new_memo: dict = {}
        old_memo = self._memo
        sent = {"bytes": 0, "leaves": 0, "of_bytes": 0, "of_leaves": 0}

        def convert(x):
            k = id(x)
            hit = new_memo.get(k) or old_memo.get(k)
            # the identity check keeps a recycled id() from returning
            # another array's tensor
            if hit is None or hit[0] is not x:
                hit = (x, torch.as_tensor(np.asarray(x), device=dev))
                sent["bytes"] += hit[1].nbytes
                sent["leaves"] += 1
            if k not in new_memo:
                sent["of_bytes"] += hit[1].nbytes
                sent["of_leaves"] += 1
            new_memo[k] = hit
            return hit[1]

        out = _map_leaves(host_plan, convert)
        self._memo = new_memo
        self.last_upload = sent
        return out

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate per-stream reuse counters (for ``WaveStats.notes``)."""
        frames = sum(self.counts.values())
        return {
            "frames": frames,
            **self.counts,
            "mean_overlap": self._overlap_sum / max(frames, 1),
            "mean_plan_ms": self._plan_ms_sum / max(frames, 1),
        }
