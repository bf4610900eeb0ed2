"""Sparse conv through the SSpNNA kernels and a tile plan (port of
``repro.kernels.sspnna.ops``).

``run_sspnna_conv`` is what the engine's ``sspnna`` backend drives. Its
default (fused) path hands the global feature array and the tile tables to
``sspnna_fused``. The pre-gathered path (``fused=False``, or
``use_kernel=False``) gathers each tile's working set into a ``(T, dI, C)``
stack, runs ``sspnna_tiles`` (or, with ``use_kernel=False``, its plain
version, the JAX package's oracle branch), and scatters the tile outputs
back with an accumulate: the accumulate, not an overwrite, is what makes
plane-split plans (``TilePlan.n_row_splits > 0``, tiles sharing an output
row) correct. The gather and the accumulating scatter are plain PyTorch
ops, as they are plain XLA ops in the JAX package. On CUDA the scatter
(``index_add_``) uses atomics, so shared rows are summed in no fixed
order; on the CPU it is sequential.

``sspnna_conv`` and ``sspnna_conv_from_plan`` are the old direct entry
points, kept as deprecation shims as in the JAX package.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.tiles import TilePlan
from repro_torch.kernels.sspnna.ref import sspnna_tile_ref
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles


def run_sspnna_conv(
    feats: torch.Tensor,       # (V_in, C) global input features
    weights: torch.Tensor,     # (K, C, N)
    out_rows: torch.Tensor,    # (T, dO) from TilePlan / dma_tile_tables
    in_rows: torch.Tensor,     # (T, dI)
    local_idx: torch.Tensor,   # (T, dO, K)
    *,
    n_out: int,
    pair_counts: torch.Tensor | None = None,  # (T,) enables the fused path
    use_kernel: bool = True,
    fused: bool | None = None,
) -> torch.Tensor:
    """Tiled sparse convolution -> (n_out, N) features (no bias/mask).

    ``fused=None`` resolves to the fused kernel whenever ``use_kernel`` is
    on and ``pair_counts`` is given (the engine always passes the plan's);
    ``fused=True`` without counts derives them from ``local_idx``. Plans
    whose tiles share output rows (``n_row_splits > 0``) must pass
    ``fused=False``: the fused kernel's store overwrites, the pre-gathered
    scatter accumulates. ``fused=True`` with ``use_kernel=False`` raises.
    """
    if fused is None:
        fused = use_kernel and pair_counts is not None
    if fused and not use_kernel:
        raise ValueError("fused=True requires use_kernel=True "
                         "(the fused path is the CUDA kernel)")
    if fused:
        counts = (pair_counts if pair_counts is not None
                  else (local_idx >= 0).sum(dim=(1, 2)).to(torch.int32))
        return sspnna_fused(feats, weights, out_rows, in_rows, local_idx,
                            counts, n_out=n_out)
    n = weights.shape[2]
    in_ok = (in_rows >= 0).unsqueeze(-1)
    tile_feats = torch.where(in_ok, feats[in_rows.clamp(min=0).long()], 0)
    if use_kernel:
        tile_out = sspnna_tiles(tile_feats, local_idx, weights)
    else:
        tile_out = sspnna_tile_ref(tile_feats, local_idx, weights)
    rows = torch.where(out_rows >= 0, out_rows, n_out).long()
    out = torch.zeros((n_out + 1, n), dtype=tile_out.dtype,
                      device=tile_out.device)
    # accumulate (not overwrite): plane-split tiles may share an output row;
    # for disjoint-row plans adding into zeros is the same result
    out.index_add_(0, rows.reshape(-1), tile_out.reshape(-1, n))
    return out[:n_out]


def sspnna_conv(feats, weights, out_rows, in_rows, local_idx, *, n_out: int,
                use_kernel: bool = True) -> torch.Tensor:
    """Deprecated: call ``repro_torch.engine.sparse_conv(backend='sspnna')``."""
    warnings.warn(
        "sspnna_conv is deprecated; route through repro_torch.engine."
        "sparse_conv with a tiled ConvPlan instead", DeprecationWarning,
        stacklevel=2)
    return run_sspnna_conv(feats, weights, out_rows, in_rows, local_idx,
                           n_out=n_out, use_kernel=use_kernel)


def sspnna_conv_from_plan(feats, weights, plan: TilePlan, *, n_out: int,
                          use_kernel: bool = True) -> torch.Tensor:
    """Deprecated: call ``repro_torch.engine.sparse_conv(backend='sspnna')``.

    ``plan``'s numpy tables are copied to ``feats``' device."""
    warnings.warn(
        "sspnna_conv_from_plan is deprecated; route through "
        "repro_torch.engine.sparse_conv with a tiled ConvPlan instead",
        DeprecationWarning, stacklevel=2)

    def put(x):
        return torch.as_tensor(x, device=feats.device)

    return run_sspnna_conv(
        feats, weights, put(plan.out_rows), put(plan.in_rows),
        put(plan.local_idx), n_out=n_out,
        # shared-row (plane-split) plans need the accumulating scatter
        pair_counts=(put(plan.pair_counts)
                     if use_kernel and plan.n_row_splits == 0 else None),
        use_kernel=use_kernel)
