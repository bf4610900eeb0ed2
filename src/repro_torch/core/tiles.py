"""Tiled COIR metadata for SSpNNA execution (port of ``repro.core.tiles``).

Each tile owns a run of dO consecutive (SOAR-ordered) output rows, the
tile's unique input rows (its working set) and tile-local partner indices.
Tiles whose working set overshoots ``delta_i`` are split in two; a single
row that overshoots is split across plane groups (unbudgeted mode) or is a
planning error (budgeted mode), so pairs are never dropped.

Host-side numpy. ``dma_tile_tables`` re-emits a plan in the layout the
fused kernel reads: input pads clamped to row 0, output pads pointed at the
trash row ``n_out``, and the per-tile pair counts (0 marks a dead tile).
``plan_dma_tables`` and ``modeled_hbm_bytes`` count a plan's descriptor
entries and model the device-memory traffic of the fused and the
pre-gathered paths.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


@dataclass
class TilePlan:
    out_rows: np.ndarray    # (T, dO) int32 global output row per tile slot, -1 pad
    in_rows: np.ndarray     # (T, dI) int32 global input rows (tile working set), -1 pad
    local_idx: np.ndarray   # (T, dO, K) int32 index into the tile's in_rows, -1 hole
    pair_counts: np.ndarray  # (T,) int32 valid pairs per tile
    n_row_splits: int = 0   # tiles created by splitting one row across planes
    dropped_pairs: int = 0  # invariant: always 0 (kept so callers can assert it)

    @property
    def n_tiles(self) -> int:
        return self.out_rows.shape[0]

    @property
    def delta_o(self) -> int:
        return self.out_rows.shape[1]

    @property
    def delta_i(self) -> int:
        return self.in_rows.shape[1]


class DmaTileTables(NamedTuple):
    """``TilePlan`` in the fused kernel's layout: ``in_rows`` (T, dI) with
    pads clamped to row 0 (validity lives in ``local_idx``), ``out_rows``
    (T, dO) with pads redirected to the trash row ``n_out``, and
    ``pair_counts`` (T,), 0 for a dead tile."""

    in_rows: np.ndarray
    out_rows: np.ndarray
    pair_counts: np.ndarray


def dma_tile_tables(plan: TilePlan, n_out: int) -> DmaTileTables:
    """Emit ``plan``'s tables in kernel layout for an ``n_out``-row scene."""
    in_rows = np.maximum(plan.in_rows, 0).astype(np.int32)
    out_rows = np.where(plan.out_rows < 0, n_out, plan.out_rows).astype(np.int32)
    return DmaTileTables(in_rows, out_rows,
                         plan.pair_counts.astype(np.int32))


def max_tiles(n_rows: int, delta_o: int, delta_i: int, kernel_volume: int) -> int:
    """Upper bound on the tile count of the budgeted (``n_tiles``) planner.

    A tile closes either full-by-rows (at most ceil(n/dO) such tiles) or
    full-by-inputs, holding more than ``delta_i - K`` unique inputs; since
    per-tile unique inputs sum to at most ``n_rows * K`` pairs, the second
    kind is bounded too.
    """
    n = max(n_rows, 1)
    by_rows = math.ceil(n / delta_o)
    by_inputs = math.ceil(n * kernel_volume / max(delta_i - kernel_volume + 1, 1))
    return by_rows + by_inputs + 1


def _split_row_by_planes(part: np.ndarray, delta_i: int) -> list[np.ndarray]:
    """Partition one row's K planes into groups whose unique partner sets fit
    ``delta_i``. Each plane contributes at most one partner, so the greedy
    walk needs at most ceil(n_unique / delta_i) groups and drops nothing."""
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_uniq: set[int] = set()
    for p in range(part.shape[0]):
        partner = int(part[p])
        new = {partner} if partner >= 0 else set()
        if cur and len(cur_uniq | new) > delta_i:
            groups.append(cur)
            cur, cur_uniq = [], set()
        cur.append(p)
        cur_uniq |= new
    if cur:
        groups.append(cur)
    return [np.asarray(g, np.int64) for g in groups]


def build_tile_plan(
    cirf_indices: np.ndarray,
    order: np.ndarray,
    delta_o: int,
    delta_i: int,
    n_tiles: int | None = None,
) -> TilePlan:
    """Regroup out-major COIR into fixed-shape tile metadata.

    cirf_indices: (V, K) global partner indices (-1 holes).
    order: SOAR (or raster) ordering of active output rows.
    n_tiles: when given, use the budgeted greedy planner (close a tile
        before a row would overflow it) and pad the stack to exactly
        ``n_tiles``. Raises ``ValueError`` if the scene needs more tiles, or
        if one row's working set cannot fit ``delta_i``.

    In unbudgeted mode a single row whose unique partners overshoot
    ``delta_i`` (only possible when ``delta_i < K``) is split across plane
    groups into tiles that share the output row; ``n_row_splits > 0`` flags
    such plans, which the fused kernel's overwriting store cannot serve.
    """
    cirf_indices = np.asarray(cirf_indices)
    k = cirf_indices.shape[1]

    # each planned tile: (rows, planes); planes is None for "all K planes"
    tiles: list[tuple[np.ndarray, np.ndarray | None]] = []
    n_row_splits = 0

    if n_tiles is not None:
        if delta_i < k:
            raise ValueError(f"delta_i {delta_i} < kernel volume {k}")
        cur: list[int] = []
        cur_uniq: set[int] = set()
        for r in np.asarray(order, np.int64):
            part = cirf_indices[r]
            new = set(part[part >= 0].tolist())
            if len(new) > delta_i:  # can't happen while delta_i >= K; be loud
                raise ValueError(
                    f"row {int(r)} working set {len(new)} > delta_i {delta_i} "
                    "in budgeted mode (would drop pairs)")
            if cur and (len(cur) == delta_o or len(cur_uniq | new) > delta_i):
                tiles.append((np.asarray(cur, np.int64), None))
                cur, cur_uniq = [], set()
            cur.append(int(r))
            cur_uniq |= new
        if cur:
            tiles.append((np.asarray(cur, np.int64), None))
        if len(tiles) > n_tiles:
            raise ValueError(
                f"scene needs {len(tiles)} tiles > budget {n_tiles} "
                f"(delta_o={delta_o}, delta_i={delta_i})")
    else:
        def emit(rows: np.ndarray):
            """Split until the unique-input working set fits delta_i."""
            part = cirf_indices[rows]
            uniq = np.unique(part[part >= 0])
            if len(uniq) > delta_i:
                if len(rows) > 1:
                    mid = len(rows) // 2
                    emit(rows[:mid])
                    emit(rows[mid:])
                else:  # single-row overshoot: split across plane groups
                    nonlocal n_row_splits
                    groups = _split_row_by_planes(part[0], delta_i)
                    n_row_splits += len(groups) - 1
                    for g in groups:
                        tiles.append((rows, g))
            else:
                tiles.append((rows, None))

        for s in range(0, len(order), delta_o):
            emit(np.asarray(order[s:s + delta_o], np.int64))

    t = n_tiles if n_tiles is not None else len(tiles)
    out_rows = np.full((t, delta_o), -1, np.int32)
    in_rows = np.full((t, delta_i), -1, np.int32)
    local_idx = np.full((t, delta_o, k), -1, np.int32)
    pair_counts = np.zeros((t,), np.int32)
    for ti, (rows, planes) in enumerate(tiles):
        out_rows[ti, : len(rows)] = rows
        part = cirf_indices[rows].copy()  # (r, K)
        if planes is not None:  # plane-split tile: hole the other planes
            keep = np.zeros((k,), bool)
            keep[planes] = True
            part[:, ~keep] = -1
        valid = part >= 0
        uniq = np.unique(part[valid])
        if len(uniq) > delta_i:
            raise AssertionError("planner invariant: working set fits delta_i")
        in_rows[ti, : len(uniq)] = uniq
        loc = np.searchsorted(uniq, part)
        loc = np.clip(loc, 0, max(len(uniq) - 1, 0))
        hit = valid & (uniq[loc] == part) if len(uniq) else np.zeros_like(valid)
        local_idx[ti, : len(rows)] = np.where(hit, loc, -1)
        pair_counts[ti] = int(hit.sum())
    return TilePlan(out_rows, in_rows, local_idx, pair_counts,
                    n_row_splits=n_row_splits, dropped_pairs=0)


def plan_dma_tables(plan: TilePlan) -> dict:
    """Descriptor accounting (paper §V-A-3): the ordered side needs one
    block entry per tile, the unordered side one entry per voxel. Returns
    entry counts and transferred rows."""
    in_valid = int((plan.in_rows >= 0).sum())
    return {
        "block_entries": plan.n_tiles,
        "voxel_entries": in_valid,
        "in_rows_transferred": in_valid,
        "out_rows_transferred": int((plan.out_rows >= 0).sum()),
    }


def modeled_hbm_bytes(plan: TilePlan, c_in: int, n_out: int,
                      itemsize: int = 4) -> dict:
    """Modeled device-memory feature traffic of the execution paths for one
    conv with ``c_in`` input and ``n_out`` output channels (the JAX
    package's model, unchanged).

    The fused path moves every table slot of every live tile (pad slots
    included, dead tiles skipped). The pre-gathered paths move the valid
    rows through the gather and the scatter and round-trip the whole
    ``(T, dI, C)`` working-set stack and ``(T, dO, N)`` tile outputs
    (padded, dead tiles included). The int32 tables count once for every
    path.
    """
    d = plan_dma_tables(plan)
    t, d_o, d_i = plan.n_tiles, plan.delta_o, plan.delta_i
    k = plan.local_idx.shape[2]
    meta = (t * d_i + t * d_o + t * d_o * k + t) * 4  # int32 tables
    valid_read = d["in_rows_transferred"] * c_in * itemsize
    valid_write = d["out_rows_transferred"] * n_out * itemsize
    alive = int((plan.pair_counts > 0).sum())
    gathered = t * d_i * c_in * itemsize       # full (T, dI, C) copy
    tile_out = t * d_o * n_out * itemsize      # full (T, dO, N) stack
    # gather write + kernel read of the copy, tile-out write + scatter read
    roundtrip = meta + valid_read + valid_write + 2 * gathered + 2 * tile_out
    return {
        "alive_tiles": alive,
        "fused": meta + alive * (d_i * c_in + d_o * n_out) * itemsize,
        "pregathered": roundtrip,
        "reference_gather": roundtrip,
    }
