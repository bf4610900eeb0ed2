"""SPADE/COIR machinery applied to MoE dispatch (port of
``repro.core.moe_spade``).

Expert routing is token-level spatial sparsity: an expert plays the part of
a weight plane, routed tokens of active voxels, and the dispatch table
``(E, cap)`` of the COIR index list. ``plan_capacity`` is the paper's RST
rule applied to router statistics (host numpy); ``build_dispatch`` builds
the expert-major table that ``models.moe`` gathers by and the grouped
expert GEMM (``kernels/moe_gemm``) runs over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.abstract import any_dtensor, redistribute_for, sharded_call

# a DTensor's groups (dim 0 of expert_idx, slot and table) are independent
_GROUP_DIMS = {"expert_idx": {0: "groups"}}


def plan_capacity(
    expert_loads: np.ndarray,
    n_experts: int,
    tokens_per_batch: int,
    top_k: int,
    mode: str = "RST",
    quantile: float = 0.90,
    round_to: int = 8,
) -> int:
    """Static expert capacity from observed load samples.

    expert_loads: (samples, E) token counts per expert per batch.
    SST allocates the observed max (never drops, wastes memory); RST
    allocates the q-quantile (the paper's relaxed static tiling; overshoot
    tokens are dropped-to-residual exactly like overshooting tiles split).
    """
    loads = np.asarray(expert_loads, np.float64)
    if mode == "SST":
        cap = float(loads.max())
    else:
        cap = float(np.quantile(loads, quantile))
    cap = max(cap, 1.0)
    uniform = tokens_per_batch * top_k / n_experts
    cap = max(cap, uniform)  # never below perfectly-balanced load
    return int(np.ceil(cap / round_to) * round_to)


def capacity_factor(capacity: int, tokens: int, top_k: int,
                    n_experts: int) -> float:
    return capacity * n_experts / max(tokens * top_k, 1)


def build_dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """COIR-style dispatch metadata for top-k routing.

    expert_idx: (..., T, k) integer expert of each token assignment; leading
    dimensions are independent groups.
    Returns (slot (..., T, k) int32 position within the expert's capacity or
    -1 if dropped, table (..., E, capacity) int32 token id or -1): the
    expert-major index list (CIRF analogue) plus the token-major slots (CORF
    analogue). An assignment's slot is the number of earlier assignments (in
    token-major order) to the same expert; those at or past ``capacity``
    are dropped.

    The JAX package scatters every assignment with dropped ones sent out of
    bounds under ``mode="drop"``. Here the dropped ones go to a trash row
    ``E`` that is cut off afterwards: the same table, and no boolean
    indexing, so nothing waits on the device. A ``DTensor`` (the dry run's)
    is built on each rank's shard of groups (dim 0).
    """
    if any_dtensor(expert_idx):
        return sharded_call(build_dispatch, "build_dispatch",
                            redistribute_for({"expert_idx": expert_idx},
                                             _GROUP_DIMS),
                            _GROUP_DIMS, {0: "groups"}, n_experts=n_experts,
                            capacity=capacity)
    *lead, t, k = expert_idx.shape
    flat = expert_idx.reshape(-1, t * k).long()                # (G, T*k)
    g = flat.shape[0]
    # the one-hot cumsum runs along the last dimension: a scan along an
    # outer one gives each of the G*E columns a single thread
    onehot = torch.nn.functional.one_hot(flat, n_experts).transpose(1, 2)
    pos = onehot.contiguous().cumsum(2) - 1                    # (G, E, T*k)
    slot = pos.gather(1, flat[:, None])[:, 0]                  # (G, T*k)
    keep = slot < capacity
    slot = torch.where(keep, slot, -1)
    token_of = torch.arange(t * k, device=flat.device) // k
    rows = torch.where(keep, flat, n_experts)
    cols = torch.where(keep, slot, 0)
    grp = torch.arange(g, device=flat.device)[:, None].expand_as(flat)
    table = torch.full((g, n_experts + 1, capacity), -1, dtype=torch.int32,
                       device=flat.device)
    table.index_put_((grp, rows, cols),
                     token_of.to(torch.int32).expand_as(flat).contiguous())
    return (slot.to(torch.int32).reshape(*lead, t, k),
            table[:, :n_experts].reshape(*lead, n_experts, capacity))


def expert_load_stats(expert_idx: np.ndarray, n_experts: int) -> np.ndarray:
    """(E,) token counts — the MoE 'sparsity attribute' extraction pass."""
    return np.bincount(np.asarray(expert_idx).reshape(-1), minlength=n_experts)
