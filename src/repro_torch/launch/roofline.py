"""Roofline terms of a dry-run step on H100s, and the four kernels' work
(port of ``repro.launch.roofline``).

Three terms per (arch, shape, mesh), from one rank's share of the step
(``launch.hlo_analysis``, the op-level walker):
    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / ICI_BW

The walker counts the local ops each rank runs (the ``DTensor`` dispatch's
shard-level ops, and the fake launches of the kernels), so every number is
per device, as the JAX package reads its per-device SPMD module. Collective
bytes are the operands of every functional collective the dispatch issues
(all-gather its output), all-reduce counted twice (ring = reduce-scatter +
all-gather).

MODEL_FLOPS uses 6*N*D (dense) / 6*N_active*D (MoE) + the attention term,
so the useful-compute ratio flags remat and dispatch waste.

The H100 SXM constants (NVIDIA's H100 data sheet, SXM part, dense rates
without sparsity, at the 700 W power limit):

* ``PEAK_FLOPS`` (= ``PEAK_BF16_FLOPS``): 989 TFLOP/s bf16 on the tensor
  cores; ``PEAK_FP32_FLOPS``: 67 TFLOP/s f32 on the CUDA cores;
  ``PEAK_TF32X3_FLOPS``: the SSpNNA kernels' f32 product is 3xTF32 on the
  tensor cores, three TF32 products (495 TFLOP/s dense) for each f32 one.
* ``HBM_BW``: 3.35 TB/s of HBM3.
* ``ICI_BW``: 450 GB/s a direction, NVLink 4 (18 links of 25 GB/s) inside
  one node of 8 cards. A 16x16 mesh spans 32 such nodes, whose traffic
  between nodes crosses the network at a fraction of that rate, so this
  term is optimistic for any collective that leaves a node.

Each kernel's *work* (the FLOPs and bytes one launch needs, each input read
once and each output written once) is one function here, used both for the
card's bound (``chip_smoke.py``) and for the dry run's fake launches. On
real tensors it counts what the data needs (pairs, valid rows, referenced
rows); on fake or meta tensors, whose values are unknown, every slot.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.abstract import is_abstract

# --- H100 SXM constants (data sheet; see the module docstring) ---
PEAK_BF16_FLOPS = 989e12
PEAK_FLOPS = PEAK_BF16_FLOPS
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
HBM_BW = 3.35e12
ICI_BW = 450e9


# ---------------------------------------------------------------------------
# Kernel work
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Work:
    """One launch's FLOPs and bytes, and the peak its FLOPs run at."""

    flops: float
    bytes: float
    peak: float

    def bound(self, peak: float | None = None) -> tuple[float, str]:
        """Least time (ms) the card could take, and what bounds it: the
        FLOPs over ``peak`` (default the work's own) against the bytes over
        the memory rate."""
        t_ops = self.flops / (self.peak if peak is None else peak)
        t_bytes = self.bytes / HBM_BW
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops > t_bytes else "bytes")


def sspnna_fused_work(feats, weights, out_rows, in_rows, local_idx,
                      pair_counts, n_out: int) -> Work:
    """``sspnna_fused``: 2*C*N FLOPs a pair the plan holds, against each
    referenced input row (of live tiles), the weights and the tables read
    once and the output written once."""
    c, n = feats.shape[1], weights.shape[2]
    if is_abstract(feats, in_rows, pair_counts):
        pairs, rows_in = local_idx.numel(), in_rows.numel()
    else:
        live = pair_counts > 0
        pairs = float(pair_counts.sum())
        rows_in = int(torch.unique(in_rows[live]).numel())
    flops = 2.0 * float(pairs) * c * n
    nbytes = 4.0 * (rows_in * c + weights.numel() + out_rows.numel()
                    + in_rows.numel() + local_idx.numel()
                    + pair_counts.numel() + n_out * n)
    return Work(flops, nbytes, PEAK_FP32_FLOPS)


def sspnna_tiles_work(feats, local_idx, weights) -> Work:
    """``sspnna_tiles``: 2*C*N FLOPs a pair (non-hole index), against each
    (tile, row) of the (T, dI, C) stack that ``local_idx`` references, W
    and ``local_idx`` read once and the (T, dO, N) output written once.
    Padded slots and the rows of dead tiles are never read, so they are
    not counted."""
    t, d_o, _ = local_idx.shape
    d_i, c, n = feats.shape[1], feats.shape[2], weights.shape[2]
    if is_abstract(feats, local_idx):
        pairs, rows_in = local_idx.numel(), t * d_i
    else:
        live = local_idx >= 0
        pairs = int(live.sum())
        t_index = torch.arange(t, device=local_idx.device).view(t, 1, 1)
        rows_in = int(torch.unique((t_index * d_i + local_idx)[live]).numel())
    flops = 2.0 * pairs * c * n
    nbytes = float(feats.element_size() * (rows_in * c + weights.numel()
                                           + t * d_o * n)
                   + 4 * local_idx.numel())
    return Work(flops, nbytes, PEAK_FP32_FLOPS)


def mask_pairs(sq: int, skv: int, *, causal: bool,
               window: int | None) -> int:
    """(query, key) pairs that ``kernels.flash.ref.attention_mask`` keeps:
    query row i sits at position Skv - Sq + i, a causal mask keeps keys at
    or before it, a window those after ``position - window``."""
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q_pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = (np.maximum(q_pos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, v, causal: bool, window: int | None) -> Work:
    """Flash attention forward: 4*D FLOPs per unmasked (q, k) pair and
    query head at the bf16 dense peak, against Q, K, V read once and O
    written once."""
    b, sq, hq, d = q.shape
    pairs = mask_pairs(sq, k.shape[1], causal=causal, window=window)
    flops = 4.0 * d * pairs * b * hq
    nbytes = float(q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
    return Work(flops, nbytes, PEAK_BF16_FLOPS)


def moe_gemm_work(xin, w, valid, out_dtype) -> Work:
    """The grouped expert GEMM: 2*d*f FLOPs per valid row at the peak of
    the inputs' type, against the valid rows of x, the w of experts with a
    valid row and the validity read once and all of out written once. On
    fake tensors every slot counts as valid."""
    e, c, d = xin.shape
    f = w.shape[2]
    if is_abstract(valid):
        rows, live = e * c, e
    else:
        rows = int(valid.sum())
        live = int(valid.any(1).sum())
    flops = 2.0 * rows * d * f
    peak = PEAK_BF16_FLOPS if xin.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    nbytes = float(xin.element_size() * (rows * d + live * d * f)
                   + valid.numel() + e * c * f * out_dtype.itemsize)
    return Work(flops, nbytes, peak)


# ---------------------------------------------------------------------------
# Step roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    model_flops_global: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        # all-reduce ring = RS + AG: count twice
        ar2 = self.coll_breakdown["bytes"].get("all-reduce", 0)
        return (self.coll_bytes_per_device + ar2) / self.ici_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        counted_global = self.flops_per_device * self.n_devices
        return self.model_flops_global / max(counted_global, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        return self.model_flops_global / (
            self.n_devices * self.peak_flops * max(t, 1e-12))

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """6*N_active*D (+ attention quadratic/window term), global per step."""
    from repro_torch.configs.base import GLOBAL, LOCAL

    n_active = cfg.active_param_count()
    if shape_kind == "train":
        tokens = batch * seq
        mult = 6.0
    elif shape_kind == "prefill":
        tokens = batch * seq
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = batch * 1
        mult = 2.0
    base = mult * n_active * tokens
    # attention score+value flops: 2 * 2 * H * hd * S_eff per token
    attn = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == GLOBAL:
            s_eff = seq / 2 if shape_kind != "decode" else seq
        elif kind == LOCAL:
            s_eff = min(cfg.window, seq)
        else:
            continue
        per_tok = 4.0 * cfg.n_heads * cfg.head_dim * s_eff
        attn += per_tok * tokens * (3.0 if shape_kind == "train" else 1.0)
    return base + attn


def build_roofline(arch, shape, mesh_name, n_devices, cost, cfg,
                   shape_spec) -> Roofline:
    """Terms from the walker's per-rank ``cost`` (``hlo_analysis.
    OpCost``); ``FlopCounterMode``'s count of the global ops is kept as a
    cross-check field, as the JAX package keeps XLA's ``cost_analysis``."""
    coll = {"bytes": dict(cost.coll_bytes), "counts": dict(cost.coll_counts),
            "kernels": {k: dict(v) for k, v in cost.kernels.items()},
            "flop_counter_global_flops": float(cost.global_flops)}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        coll_bytes_per_device=float(sum(cost.coll_bytes.values())),
        coll_breakdown=coll,
        model_flops_global=model_flops(cfg, shape_spec.kind,
                                       shape_spec.global_batch,
                                       shape_spec.seq_len),
    )
