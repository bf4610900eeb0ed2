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

Offline mode (§V-C): SA_I is a *meta* attribute (MSA_I, consistent across
pointclouds; it tracks the surface-to-volume ratio alpha_m / v^(1/m)), and
ARF is the input-specific attribute (JSA). ``build_offline_table``
precomputes the optimal dataflow per ARF bin; ``otf_lookup`` then only
measures ARF and looks the plan up.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

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


def surface_ratio_model(delta_o: np.ndarray, alpha: float, m: int = 3) -> np.ndarray:
    """The paper's observed fit: SA_I(v) ~ 1 + alpha_m / v^(1/m)
    (surface-to-volume ratio of an m-cube)."""
    return 1.0 + alpha / np.maximum(delta_o, 1) ** (1.0 / m)


def fit_surface_ratio(attrs: SparsityAttributes, m: int = 3) -> tuple[float, float]:
    """Least-squares alpha and correlation of SA_I_avg against the
    surface-ratio model (the Fig 15 observation). A constant series gives a
    nan correlation, as ``np.corrcoef`` does."""
    x = 1.0 / attrs.delta_majors ** (1.0 / m)
    y = attrs.sa_minor_avg - 1.0
    alpha = float(np.dot(x, y) / max(np.dot(x, x), 1e-12))
    pred = alpha * x
    corr = float(np.corrcoef(pred, y)[0, 1]) if len(x) > 2 else 1.0
    return alpha, corr


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


# ---------------------------------------------------------------------------
# Offline SPADE (MSA tables indexed by ARF), §V-C
# ---------------------------------------------------------------------------

@dataclass
class OfflineTable:
    arf_bins: np.ndarray                     # bin upper edges
    plans: dict[tuple[str, int], Dataflow] = field(default_factory=dict)

    def lookup(self, layer_name: str, arf: float) -> Dataflow:
        # left-sided: an ARF on an edge takes that edge's bin; past the last
        # edge it clamps to the last bin
        b = int(np.searchsorted(self.arf_bins, arf))
        b = min(b, len(self.arf_bins) - 1)
        return self.plans[(layer_name, b)]


def build_offline_table(
    layers: list[LayerSpec],
    msa: SparsityAttributes,
    mem_budget_bytes: int,
    arf_bins: np.ndarray | None = None,
) -> OfflineTable:
    """Precompute optimal dataflows per (layer, ARF bin) using MSA_I and a
    synthetic constant-ARF attribute per bin (ARF is the JSA)."""
    bins = arf_bins if arf_bins is not None else np.array(
        [2, 4, 6, 8, 10, 13, 16, 20, 27], float
    )
    table = OfflineTable(bins)
    for layer in layers:
        for b, arf in enumerate(bins):
            synth = SparsityAttributes(
                msa.delta_majors,
                msa.sa_minor_avg,
                msa.sa_minor_alloc_sst,
                msa.sa_minor_alloc_rst,
                np.full_like(msa.arf_avg, arf),
                np.full_like(msa.arf_avg, arf),
                np.full_like(msa.arf_avg, arf),
                msa.rst_overshoot_frac,
                msa.quantile,
            )
            table.plans[(layer.name, b)] = explore(
                layer, {"CIRF": synth, "CORF": synth}, mem_budget_bytes
            )
    return table


def otf_lookup(table: OfflineTable, layer: LayerSpec, arf: float) -> Dataflow:
    """On-the-fly SPADE: one ARF measurement -> table lookup (near-zero
    latency; the paper overlaps it with the first layer's execution)."""
    return table.lookup(layer.name, arf)
