"""SPADE: SParsity-Aware Dataflow Explorer (§IV-C), port of ``repro.core.spade``.

Sparsity attributes are extracted in one pass over COIR metadata, then the
analytical data-access model (Eqn 5) is swept over (tile x walk pattern x
metadata flavor) under a tile-footprint budget (Eqn 1). Host-side numpy.

  SA_I(R, dO)  = f_I / dO   : unique minor points per major point in a
                              region of dO consecutive (ordered) majors
  SA_MO(R, dO) = f_MO / dO  : average receptive/response field (ARF)

Tile footprint (Eqn 1):  dT = dI*dC + dO*dN + K*dC*dN + dM
Data accesses (Eqn 5):
  DA = F_WS(WP, ceil(O/dO)) * (C*N*K)
     + F_IS(WP, ceil(N/dN)) * (SA_I_avg(dO) * O * C)
     + F_OS(WP, ceil(C/dC)) * (O*N + SA_MO_avg(dO) * O)
  with F_X(Y, Z) = 1 if Y == X else Z.

SST tiling allocates for the worst-case region; RST for the q-th quantile
and models overshooting tiles as split in two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

WALK_PATTERNS = ("IS", "OS", "WS")
FLAVORS = ("CIRF", "CORF")


@dataclass
class SparsityAttributes:
    """Per-(region-size) attribute summaries for one layer + one ordering."""

    delta_majors: np.ndarray          # (D,) region sizes examined
    sa_minor_avg: np.ndarray          # (D,) mean SA_I over regions
    sa_minor_alloc_sst: np.ndarray    # (D,) max  SA_I (SST allocation)
    sa_minor_alloc_rst: np.ndarray    # (D,) q-quantile SA_I (RST)
    arf_avg: np.ndarray               # (D,) mean SA_MO
    arf_alloc_sst: np.ndarray
    arf_alloc_rst: np.ndarray
    rst_overshoot_frac: np.ndarray    # (D,) fraction of tiles above quantile
    quantile: float = 0.90

    def at(self, delta: int, name: str) -> float:
        i = int(np.searchsorted(self.delta_majors, delta))
        i = min(i, len(self.delta_majors) - 1)
        return float(getattr(self, name)[i])


def extract_attributes(
    major_indices: np.ndarray,
    major_mask: np.ndarray,
    order: np.ndarray | None = None,
    deltas: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096),
    quantile: float = 0.90,
) -> SparsityAttributes:
    """One pass over COIR metadata -> sparsity attributes for all region
    sizes. ``major_indices`` is COIR.indices (V, K) as numpy."""
    act = np.flatnonzero(np.asarray(major_mask))
    if order is None:
        order = act
    rows = np.asarray(major_indices)[order]
    n = len(order)
    d_list, sa_avg, sa_max, sa_q, arf_a, arf_m, arf_q, over = ([] for _ in range(8))
    for d in deltas:
        d_eff = min(d, max(n, 1))
        sa_i, sa_mo = [], []
        for s in range(0, n, d_eff):
            blk = rows[s:s + d_eff]
            ids = blk[blk >= 0]
            cnt = len(blk)
            if cnt == 0:
                continue
            sa_i.append(len(np.unique(ids)) / cnt)
            sa_mo.append(len(ids) / cnt)
        sa_i = np.array(sa_i) if sa_i else np.array([1.0])
        sa_mo = np.array(sa_mo) if sa_mo else np.array([1.0])
        d_list.append(d)
        sa_avg.append(sa_i.mean())
        sa_max.append(sa_i.max())
        sa_q.append(np.quantile(sa_i, quantile))
        arf_a.append(sa_mo.mean())
        arf_m.append(sa_mo.max())
        arf_q.append(np.quantile(sa_mo, quantile))
        over.append(float(np.mean(sa_i > np.quantile(sa_i, quantile))))
    return SparsityAttributes(
        np.array(d_list), np.array(sa_avg), np.array(sa_max), np.array(sa_q),
        np.array(arf_a), np.array(arf_m), np.array(arf_q), np.array(over),
        quantile,
    )


@dataclass(frozen=True)
class LayerSpec:
    name: str
    n_in: int        # I
    n_out: int       # O
    kernel_volume: int
    c_in: int
    c_out: int
    dtype_bytes: int = 2


@dataclass(frozen=True)
class Dataflow:
    delta_major: int     # dO (CIRF) or dI (CORF)
    delta_c: int
    delta_n: int
    walk: str            # IS | OS | WS
    flavor: str          # CIRF | CORF
    tiling: str          # SST | RST
    tile_elems: float
    da_elems: float
    da_breakdown: tuple[float, float, float] = (0.0, 0.0, 0.0)


def _f(cur: str, want: str, repeats: float) -> float:
    return 1.0 if cur == want else repeats


def data_accesses(
    layer: LayerSpec,
    attrs: SparsityAttributes,
    delta_major: int,
    delta_c: int,
    delta_n: int,
    walk: str,
    flavor: str,
) -> tuple[float, tuple[float, float, float]]:
    """Eqn 5, in elements. For CORF, I and O swap roles (paper §IV-C note)."""
    k, c, n = layer.kernel_volume, layer.c_in, layer.c_out
    if flavor == "CIRF":
        majors, minor_ch, major_ch = layer.n_out, c, n
    else:
        majors, minor_ch, major_ch = layer.n_in, n, c
    sa_i = attrs.at(delta_major, "sa_minor_avg")
    arf = attrs.at(delta_major, "arf_avg")
    w_term = _f(walk, "WS", math.ceil(majors / delta_major)) * (c * n * k)
    i_term = _f(walk, "IS", math.ceil((n if flavor == "CIRF" else c) / delta_n)) * (
        sa_i * majors * minor_ch
    )
    o_term = _f(walk, "OS", math.ceil((c if flavor == "CIRF" else n) / delta_c)) * (
        majors * major_ch + arf * majors
    )
    return w_term + i_term + o_term, (w_term, i_term, o_term)


def tile_footprint(
    layer: LayerSpec,
    attrs: SparsityAttributes,
    delta_major: int,
    delta_c: int,
    delta_n: int,
    flavor: str,
    tiling: str,
) -> float:
    """Eqn 1 in elements, using SST/RST allocation attributes."""
    which = "sa_minor_alloc_sst" if tiling == "SST" else "sa_minor_alloc_rst"
    arf_which = "arf_alloc_sst" if tiling == "SST" else "arf_alloc_rst"
    sa_alloc = attrs.at(delta_major, which)
    arf_alloc = attrs.at(delta_major, arf_which)
    d_minor = sa_alloc * delta_major
    d_m = (2.0 + arf_alloc) * delta_major  # COIR words (header + self + list)
    if flavor == "CIRF":
        return (
            d_minor * delta_c
            + delta_major * delta_n
            + layer.kernel_volume * delta_c * delta_n
            + d_m
        )
    return (
        delta_major * delta_c
        + d_minor * delta_n
        + layer.kernel_volume * delta_c * delta_n
        + d_m
    )


def _pow2_range(hi: int, lo: int = 8) -> list[int]:
    vals, v = [], lo
    while v < hi:
        vals.append(v)
        v *= 2
    vals.append(hi)
    return sorted(set(vals))


def explore(
    layer: LayerSpec,
    attrs_by_flavor: dict[str, SparsityAttributes],
    mem_budget_bytes: int,
    tiling: str = "RST",
    walks: tuple[str, ...] = WALK_PATTERNS,
    flavors: tuple[str, ...] = FLAVORS,
) -> Dataflow:
    """Full design-space sweep: min-DA dataflow under the footprint
    constraint. ``attrs_by_flavor`` maps flavor -> attributes extracted from
    that flavor's COIR."""
    budget_elems = mem_budget_bytes / layer.dtype_bytes
    best: Dataflow | None = None
    for flavor in flavors:
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
                    for wp in walks:
                        da, br = data_accesses(layer, attrs, dm, dc, dn, wp, flavor)
                        if tiling == "RST":
                            # overshooting tiles split in two -> extra weight
                            # refetches on the split fraction
                            over = attrs.at(dm, "rst_overshoot_frac")
                            da = da * (1.0 + 0.5 * over)
                        cand = Dataflow(dm, dc, dn, wp, flavor, tiling, t, da, br)
                        if best is None or cand.da_elems < best.da_elems:
                            best = cand
    if best is None:  # nothing fits: smallest legal tile
        flavor = flavors[0]
        attrs = attrs_by_flavor[flavor]
        t = tile_footprint(layer, attrs, 32, 8, 8, flavor, tiling)
        da, br = data_accesses(layer, attrs, 32, 8, 8, "OS", flavor)
        best = Dataflow(32, 8, 8, "OS", flavor, tiling, t, da, br)
    return best


def meta_attributes(per_cloud: list[SparsityAttributes]) -> SparsityAttributes:
    """MSA: average SA_I across a representative pointcloud set (Eqn 10),
    keeping the most conservative allocation columns."""
    ref = per_cloud[0]

    def stack(name):
        return np.stack([getattr(a, name) for a in per_cloud])

    return SparsityAttributes(
        ref.delta_majors,
        stack("sa_minor_avg").mean(0),
        stack("sa_minor_alloc_sst").max(0),
        stack("sa_minor_alloc_rst").mean(0),
        stack("arf_avg").mean(0),
        stack("arf_alloc_sst").max(0),
        stack("arf_alloc_rst").mean(0),
        stack("rst_overshoot_frac").mean(0),
        ref.quantile,
    )
