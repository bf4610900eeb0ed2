"""Ops-sorted multi-core tile scheduling (§V-A-4, Fig 14-b; port of
``repro.core.schedule``, numpy, line for line).

SPADE produces uniform tile *shapes* but region-dependent sparsity makes
ops-per-tile asymmetric. The paper sorts spatial tiles by ops descending and
round-robins them over core groups; this evens out core finish times and
keeps the shared DMA bus busy — on a 1000-node system the same policy is the
first line of straggler mitigation for sparse work (slow shards get fewer
heavy tiles, not fewer tiles).

Also provides the greedy LPT variant (beyond-paper) and a phase-overlap
makespan model of the paper's serialized-DMA execution (Fig 14-a).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Assignment:
    core_of_tile: np.ndarray      # (T,) core id per tile
    order_within: list[np.ndarray]  # execution order per core
    makespan: float
    per_core_work: np.ndarray


def ops_per_tile(pair_counts: np.ndarray, delta_c: int, delta_n: int) -> np.ndarray:
    """MACs per tile: pairs(tile) * dC * dN (the M-V dispatch granularity)."""
    return pair_counts.astype(np.float64) * delta_c * delta_n


def schedule_round_robin_sorted(work: np.ndarray, n_cores: int) -> Assignment:
    """The paper's policy: sort by work desc, deal round-robin."""
    order = np.argsort(-work, kind="stable")
    core_of = np.empty(len(work), np.int32)
    core_of[order] = np.arange(len(work)) % n_cores
    per_core = np.zeros(n_cores)
    np.add.at(per_core, core_of, work)
    order_within = [order[np.flatnonzero(core_of[order] == c)] for c in range(n_cores)]
    return Assignment(core_of, order_within, float(per_core.max()), per_core)


def schedule_lpt(work: np.ndarray, n_cores: int) -> Assignment:
    """Longest-Processing-Time greedy (beyond-paper refinement)."""
    order = np.argsort(-work, kind="stable")
    load = np.zeros(n_cores)
    core_of = np.empty(len(work), np.int32)
    for t in order:
        c = int(np.argmin(load))
        core_of[t] = c
        load[c] += work[t]
    order_within = [order[np.flatnonzero(core_of[order] == c)] for c in range(n_cores)]
    return Assignment(core_of, order_within, float(load.max()), load)


def schedule_naive(work: np.ndarray, n_cores: int) -> Assignment:
    """Unsorted round-robin baseline (Fig 14-b left)."""
    core_of = (np.arange(len(work)) % n_cores).astype(np.int32)
    per_core = np.zeros(n_cores)
    np.add.at(per_core, core_of, work)
    order_within = [np.flatnonzero(core_of == c) for c in range(n_cores)]
    return Assignment(core_of, order_within, float(per_core.max()), per_core)


def phase_overlap_makespan(
    assign: Assignment,
    work: np.ndarray,
    xfer: np.ndarray,
    macs_per_cycle: float,
    bus_elems_per_cycle: float,
) -> float:
    """Model of the paper's distinct compute/data-exchange phases with a
    shared round-robin L1<->L2 bus (Fig 14-a): each core alternates
    (transfer tile_i+1) -> (compute tile_i), transfers serialized on the bus.

    Returns modeled cycles. `work` in MACs and `xfer` in elements per tile.
    """
    n_cores = len(assign.order_within)
    core_time = np.zeros(n_cores)
    bus_free = 0.0
    # interleave transfers in round-robin over cores, in each core's order
    ptrs = [0] * n_cores
    pending = sum(len(o) for o in assign.order_within)
    while pending:
        for c in range(n_cores):
            o = assign.order_within[c]
            if ptrs[c] >= len(o):
                continue
            t = o[ptrs[c]]
            ptrs[c] += 1
            pending -= 1
            start = max(bus_free, core_time[c])
            t_xfer = xfer[t] / max(bus_elems_per_cycle, 1e-9)
            bus_free = start + t_xfer
            core_time[c] = bus_free + work[t] / max(macs_per_cycle, 1e-9)
    return float(core_time.max())
