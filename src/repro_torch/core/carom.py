"""CAROM: Constrained-Access Reuse-Opportunity Maximization (§V-B; port of
``repro.core.carom``, line for line over ``core.spade``).

Hierarchical dataflow search over a multi-level memory hierarchy that avoids
the classic greedy failure (minimizing outer-level accesses can starve inner
levels of reuse). At each level L_q (outer -> inner):

  1. Candidate set  D^Lq = { D : DA(D) <= DA_th } ∪ { argmin DA }   (Eqn 6)
  2. DA_th = Ops^Lq * BW^Lq / TotalComp^Lq                           (Eqn 7)
     with Ops^Lq = SA_MO(O^Lq) * O^Lq * N^Lq * C^Lq                  (Eqn 8)
  3. Pick the candidate maximizing reuse opportunity for L_{q-1}, i.e. the
     ops available on the chosen working set (Eqn 9); the chosen tile is the
     next level's working set.
  4. Innermost level: plain argmin DA.

The levels are the caller's, outer to inner, each with its capacity, its
bandwidth toward the next-outer level in elements/cycle and the compute it
feeds in MACs/cycle; this module holds no table of any chip's levels.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.spade import (
    FLAVORS,
    WALK_PATTERNS,
    Dataflow,
    LayerSpec,
    SparsityAttributes,
    _pow2_range,
    data_accesses,
    tile_footprint,
)


@dataclass(frozen=True)
class MemLevel:
    name: str
    capacity_bytes: int
    bw_elems_per_cycle: float   # toward the next-outer level
    macs_per_cycle: float       # compute fed from this level


def _candidates(
    layer: LayerSpec,
    attrs_by_flavor: dict[str, SparsityAttributes],
    budget_bytes: int,
    tiling: str,
) -> list[Dataflow]:
    budget_elems = budget_bytes / layer.dtype_bytes
    out = []
    for flavor in FLAVORS:
        if flavor not in attrs_by_flavor:
            continue
        attrs = attrs_by_flavor[flavor]
        majors = layer.n_out if flavor == "CIRF" else layer.n_in
        for dm in _pow2_range(max(majors, 8), 32):
            for dc in _pow2_range(layer.c_in, 8):
                for dn in _pow2_range(layer.c_out, 8):
                    t = tile_footprint(layer, attrs, dm, dc, dn, flavor, tiling)
                    if t > budget_elems:
                        continue
                    for wp in WALK_PATTERNS:
                        da, br = data_accesses(layer, attrs, dm, dc, dn, wp, flavor)
                        out.append(
                            Dataflow(dm, dc, dn, wp, flavor, tiling, t, da, br)
                        )
    return out


def _ops(layer: LayerSpec, attrs: SparsityAttributes, d: Dataflow) -> float:
    """Ops on the working set defined by candidate d (Eqn 8 analogue for a
    tile): MACs = ARF * dMajor * dC * dN."""
    arf = attrs.at(d.delta_major, "arf_avg")
    return arf * d.delta_major * d.delta_c * d.delta_n


def carom_search(
    layer: LayerSpec,
    attrs_by_flavor: dict[str, SparsityAttributes],
    levels: list[MemLevel],
    tiling: str = "RST",
) -> list[Dataflow]:
    """Outer->inner search. Returns one Dataflow per level; level i's tile is
    level i+1's working set (its totals replace I/O/C/N)."""
    plans: list[Dataflow] = []
    cur_layer = layer
    for qi, level in enumerate(levels):
        cands = _candidates(cur_layer, attrs_by_flavor, level.capacity_bytes, tiling)
        if not cands:
            break
        innermost = qi == len(levels) - 1
        if innermost:
            best = min(cands, key=lambda d: d.da_elems)
        else:
            attrs0 = attrs_by_flavor.get("CIRF") or next(iter(attrs_by_flavor.values()))
            total_ops = (
                attrs0.at(attrs0.delta_majors[-1], "arf_avg")
                * cur_layer.n_out * cur_layer.c_in * cur_layer.c_out
            )
            da_min = min(d.da_elems for d in cands)
            da_th = max(
                total_ops * level.bw_elems_per_cycle / max(level.macs_per_cycle, 1e-9),
                da_min,
            )
            feasible = [d for d in cands if d.da_elems <= da_th]
            if not feasible:
                feasible = [min(cands, key=lambda d: d.da_elems)]
            best = max(
                feasible,
                key=lambda d: _ops(cur_layer, attrs_by_flavor[d.flavor], d),
            )
        plans.append(best)
        # The chosen tile becomes the next level's layer totals.
        attrs_b = attrs_by_flavor[best.flavor]
        sa = attrs_b.at(best.delta_major, "sa_minor_avg")
        if best.flavor == "CIRF":
            n_out = best.delta_major
            n_in = max(int(sa * best.delta_major), 1)
        else:
            n_in = best.delta_major
            n_out = max(int(sa * best.delta_major), 1)
        cur_layer = LayerSpec(
            name=f"{cur_layer.name}@{level.name}",
            n_in=n_in,
            n_out=n_out,
            kernel_volume=cur_layer.kernel_volume,
            c_in=best.delta_c,
            c_out=best.delta_n,
            dtype_bytes=cur_layer.dtype_bytes,
        )
    return plans


def greedy_search(
    layer: LayerSpec,
    attrs_by_flavor: dict[str, SparsityAttributes],
    levels: list[MemLevel],
    tiling: str = "RST",
) -> list[Dataflow]:
    """Baseline hierarchical search: plain min-DA at every level (the
    strategy CAROM improves on — used by the Fig 22 ablation)."""
    plans: list[Dataflow] = []
    cur_layer = layer
    for level in levels:
        cands = _candidates(cur_layer, attrs_by_flavor, level.capacity_bytes, tiling)
        if not cands:
            break
        best = min(cands, key=lambda d: d.da_elems)
        plans.append(best)
        attrs_b = attrs_by_flavor[best.flavor]
        sa = attrs_b.at(best.delta_major, "sa_minor_avg")
        n_major = best.delta_major
        n_minor = max(int(sa * best.delta_major), 1)
        cur_layer = LayerSpec(
            name=f"{cur_layer.name}@{level.name}",
            n_in=n_minor if best.flavor == "CIRF" else n_major,
            n_out=n_major if best.flavor == "CIRF" else n_minor,
            kernel_volume=cur_layer.kernel_volume,
            c_in=best.delta_c,
            c_out=best.delta_n,
            dtype_bytes=cur_layer.dtype_bytes,
        )
    return plans
