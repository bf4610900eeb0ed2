"""SOAR: Surface-Orientation-Aware Reordering of pointclouds (§IV-B).

Port of ``repro.core.soar`` (host-side numpy, the paper's algorithm):

1. The adjacency map is the submanifold CIRF neighbour table.
2. Pick the unselected voxel with the fewest neighbours as the root.
3. Grow an m-ary tree breadth-first: pop voxels from the Neighbour Queue,
   skip selected ones, otherwise append to the chunk and push its
   neighbours.
4. When the chunk reaches the size bound, emit it; the next root is the
   minimum-degree voxel in the Neighbour Queue, which is then flushed.

Hierarchical SOAR (§V-B): chunks are reinterpreted as points (adjacent iff
any member voxels are adjacent) and SOAR recurses with the outer level's
size bound, innermost to outermost.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class SoarResult:
    order: np.ndarray        # (n_active,) permutation: new position -> old index
    chunk_starts: np.ndarray  # (n_chunks + 1,) boundaries into `order`

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_starts) - 1


def _neighbor_lists(neighbor_table: np.ndarray) -> list[np.ndarray]:
    """Per-voxel neighbour index lists from a (V, K) table (-1 holes),
    excluding self-edges."""
    lists = []
    for i in range(neighbor_table.shape[0]):
        nb = neighbor_table[i]
        lists.append(nb[(nb >= 0) & (nb != i)])
    return lists


def soar_order(
    neighbor_table: np.ndarray,
    active_mask: np.ndarray,
    max_chunk_voxels: int,
) -> SoarResult:
    """Chunked breadth-first reordering of the active voxels."""
    v = neighbor_table.shape[0]
    nbrs = _neighbor_lists(neighbor_table)
    degree = np.array([len(n) for n in nbrs])
    active = np.asarray(active_mask, bool).copy()
    selected = np.zeros(v, bool)
    # min-degree order among active voxels, used for root selection
    root_order = np.argsort(degree + np.where(active, 0, 1 << 30), kind="stable")
    root_ptr = 0

    order: list[int] = []
    chunk_starts = [0]
    queue: deque[int] = deque()
    n_active = int(active.sum())
    chunk_count = 0

    def next_root() -> int:
        nonlocal root_ptr
        # prefer the min-degree voxel from the Neighbour Queue (paper), else
        # the globally min-degree unselected voxel
        if queue:
            cands = [q for q in queue if active[q] and not selected[q]]
            if cands:
                return min(cands, key=lambda q: degree[q])
        while root_ptr < v:
            r = root_order[root_ptr]
            root_ptr += 1
            if active[r] and not selected[r]:
                return int(r)
        return -1

    while len(order) < n_active:
        root = next_root()
        if root < 0:
            break
        queue.clear()
        queue.append(root)
        while queue and chunk_count < max_chunk_voxels:
            u = queue.popleft()
            if selected[u] or not active[u]:
                continue
            selected[u] = True
            order.append(u)
            chunk_count += 1
            for w in nbrs[u]:
                if active[w] and not selected[w]:
                    queue.append(int(w))
        if chunk_count >= max_chunk_voxels or not queue:
            if chunk_count:
                chunk_starts.append(len(order))
                chunk_count = 0
            # the queue is flushed after the next chunk's root selection
            # (paper): next_root() inspects it, then the loop clears it
    if chunk_starts[-1] != len(order):
        chunk_starts.append(len(order))
    return SoarResult(np.array(order, np.int64), np.array(chunk_starts, np.int64))


def soar_hierarchical(
    neighbor_table: np.ndarray,
    active_mask: np.ndarray,
    chunk_sizes: list[int],
) -> SoarResult:
    """Multi-level SOAR: innermost chunk size first (§V-B).

    Returns the flattened voxel order with chunk boundaries of the
    *innermost* level; outer levels permute whole inner chunks.
    """
    assert chunk_sizes, "need at least one level"
    inner = soar_order(neighbor_table, active_mask, chunk_sizes[0])
    if len(chunk_sizes) == 1:
        return inner
    # chunk-level adjacency: chunks are adjacent iff any voxel pair is
    n_chunks = inner.n_chunks
    chunk_of = np.full(neighbor_table.shape[0], -1, np.int64)
    for c in range(n_chunks):
        seg = inner.order[inner.chunk_starts[c]:inner.chunk_starts[c + 1]]
        chunk_of[seg] = c
    adj = [set() for _ in range(n_chunks)]
    for i in np.flatnonzero(np.asarray(active_mask)):
        ci = chunk_of[i]
        if ci < 0:
            continue
        for w in neighbor_table[i]:
            if w >= 0 and chunk_of[w] >= 0 and chunk_of[w] != ci:
                adj[ci].add(int(chunk_of[w]))
    kmax = max((len(a) for a in adj), default=1) or 1
    chunk_nbr = np.full((n_chunks, kmax), -1, np.int64)
    for c, a in enumerate(adj):
        lst = sorted(a)
        chunk_nbr[c, : len(lst)] = lst
    outer_budget = max(chunk_sizes[1] // max(chunk_sizes[0], 1), 1)
    outer = soar_hierarchical(
        chunk_nbr, np.ones(n_chunks, bool), [outer_budget] + [
            s // max(chunk_sizes[0], 1) for s in chunk_sizes[2:]
        ],
    )
    # flatten: permute the inner chunks by the outer order
    order = np.concatenate(
        [
            inner.order[inner.chunk_starts[c]:inner.chunk_starts[c + 1]]
            for c in outer.order
        ]
    )
    sizes = np.diff(inner.chunk_starts)[outer.order]
    chunk_starts = np.concatenate([[0], np.cumsum(sizes)])
    return SoarResult(order, chunk_starts)


def raster_order(coords: np.ndarray, active_mask: np.ndarray,
                 axes=(0, 1, 2)) -> np.ndarray:
    """Raster-scan baseline ordering: lexicographic sort along the given
    axis priority."""
    act = np.flatnonzero(np.asarray(active_mask))
    keycols = [coords[act, a] for a in reversed(axes)]
    return act[np.lexsort(keycols)]


def tiled_unique_input_accesses(
    order: np.ndarray, cirf_indices: np.ndarray, tile_out: int
) -> int:
    """Data-access cost model of Fig 23: process outputs in ``order`` in
    tiles of ``tile_out``; each tile fetches its unique input partners once.
    Returns the total input-row fetches across tiles."""
    total = 0
    for s in range(0, len(order), tile_out):
        rows = cirf_indices[order[s:s + tile_out]]
        ids = rows[rows >= 0]
        total += len(np.unique(ids))
    return total
