"""Scene plans (port of ``repro.engine.plan``, main-path subset).

A ``ScenePlan`` bundles everything the paper builds before running a layer,
per input scene: per-level COIR metadata (the AdMAC pass), the SOAR row
order, the SPADE-selected dataflow as a per-conv ``Dispatch``, and the tile
tables the fused SSpNNA kernel reads. ``build_scene_plan_host`` builds it in
numpy on the host (adaptive mode: SPADE explores each level on this scene's
own sparsity attributes); ``upload_scene_plan`` copies its tables to the
device as torch tensors. ``conv_plan_for_layer`` builds a tiled plan for
one standalone conv site.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import spade
from repro_torch.core.coir import COIR
from repro_torch.core.hashgrid import kernel_offsets
from repro_torch.core.host_meta import (
    build_cirf_np,
    downsample_coords_np,
    transposed_coir_np,
)
from repro_torch.core.soar import raster_order, soar_order
from repro_torch.core.tiles import build_tile_plan, dma_tile_tables
from repro_torch.device import host_array, require_device
from repro_torch.sparse.tensor import SparseVoxelTensor

REFERENCE = "reference"
SSPNNA = "sspnna"

_K_SUB = 27  # submanifold 3^3 kernel volume


@dataclass(frozen=True)
class Dispatch:
    """Static per-conv execution decision."""

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
    chosen dataflows) per level."""

    levels: tuple[LevelPlan, ...]
    stats: list[dict] | None = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device | None:
        """Device of the plan's tables; None for a host (numpy) plan."""
        mask = self.levels[0].mask
        return mask.device if isinstance(mask, torch.Tensor) else None


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


def _tile_arrays(cirf_indices, ordering, dispatch: Dispatch,
                 n_out: int) -> TileArrays | None:
    """Fixed-shape tile metadata (kernel layout) for one conv; None when the
    plan needs shared-output-row tiles, which the fused kernel cannot serve
    (the caller then dispatches the conv to reference)."""
    tp = build_tile_plan(np.asarray(cirf_indices), ordering, dispatch.delta_o,
                         dispatch.delta_i)
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
    plan_tiles: bool,
    mem_budget: int,
    order: str,
    soar_chunk: int,
) -> tuple[ConvPlan, dict]:
    """Dispatch, ordering and tile assembly for one level's submanifold conv."""
    n_active = int(np.asarray(mask).sum())
    info: dict = {"level": li, "n_active": n_active}
    dispatch = REFERENCE_DISPATCH
    tiles = None
    if plan_tiles and n_active > 0:
        ordering = _order_rows(sub_coir, coords, mask, order, soar_chunk)
        attrs = spade.extract_attributes(
            np.asarray(sub_coir.indices), np.asarray(mask), ordering)
        layer = _layer_spec(f"level{li}", n_active, cfg.widths[li])
        df = spade.explore(layer, {"CIRF": attrs, "CORF": attrs}, mem_budget)
        dispatch = dispatch_from_dataflow(df, attrs, n_active)
        info["arf"] = float(attrs.arf_avg[0])
        info["da_elems"] = df.da_elems
        if dispatch.backend == SSPNNA:
            tiles = _tile_arrays(sub_coir.indices, ordering, dispatch,
                                 int(np.asarray(mask).shape[0]))
            if tiles is None:  # plane-split tiles: coarse dispatch
                info["tile_overflow"] = True
                dispatch = REFERENCE_DISPATCH
            else:  # record the realized tile count
                dispatch = Dispatch(
                    dispatch.backend, dispatch.flavor, dispatch.walk,
                    dispatch.delta_o, dispatch.delta_i,
                    int(tiles.out_rows.shape[0]))
    info["dispatch"] = dispatch
    return ConvPlan(sub_coir, tiles, dispatch), info


def _build_scene_plan(t, cfg, *, plan_tiles, mem_budget, order,
                      soar_chunk) -> ScenePlan:
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
            sub_coir, coords, mask, li, cfg, plan_tiles=plan_tiles,
            mem_budget=mem_budget, order=order, soar_chunk=soar_chunk)
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
    return ScenePlan(levels, plan.stats)


def build_scene_plan_host(
    t: SparseVoxelTensor,
    cfg,
    *,
    plan_tiles: bool = True,
    mem_budget: int = 64 * 1024,
    order: str = "soar",
    soar_chunk: int = 512,
) -> ScenePlan:
    """AdMAC metadata + SOAR ordering + SPADE selection + tile tables for
    one scene, all leaves numpy. Pair with ``upload_scene_plan``.

    ``plan_tiles=False`` skips ordering and attribute extraction and gives
    an all-reference plan."""
    plan = _build_scene_plan(t, cfg, plan_tiles=plan_tiles,
                             mem_budget=mem_budget, order=order,
                             soar_chunk=soar_chunk)
    return _map_leaves(plan, np.asarray)


def upload_scene_plan(plan: ScenePlan, device: str | torch.device = "cuda"
                      ) -> ScenePlan:
    """Copy a host plan's tables to ``device`` as torch tensors (same
    dtypes: int32 tables, bool masks, uint32 bitmasks)."""
    dev = require_device(device)
    return _map_leaves(plan, lambda x: torch.as_tensor(np.asarray(x), device=dev))
