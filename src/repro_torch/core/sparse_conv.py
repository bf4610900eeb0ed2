"""Spatially-sparse 3D convolution on COIR metadata (port of
``repro.core.sparse_conv``).

Three layer types, matching SCN U-Nets:

* **submanifold** (k=3, s=1): output active set == input active set;
* **strided** (k=2, s=2): output set = unique(coords // 2); downsamples;
* **transposed** (k=2, s=2): restores a saved finer active set; upsamples.

The reference dataflow gathers every partner feature per weight plane and
runs one ``(V, K*C) @ (K*C, N)`` product: the coarse single dispatch the
engine's ``reference`` backend runs, and the numerical oracle of the tiled
SSpNNA path. The JAX package leaves this to plain XLA ops, so it stays
plain PyTorch here. The layer helpers build their COIR on the tensors'
device (``core.coir``); ``dense_submanifold_reference`` is a numpy oracle.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.coir import COIR, build_cirf, build_corf
from repro_torch.core.hashgrid import downsample_coords, kernel_offsets
from repro_torch.device import require_device
from repro_torch.sparse.tensor import SparseVoxelTensor


class SparseConvParams(NamedTuple):
    weight: torch.Tensor  # (K, C, N)
    bias: torch.Tensor    # (N,)


def init_sparse_conv(generator: torch.Generator, kernel_volume: int,
                     c_in: int, c_out: int, dtype: torch.dtype = torch.float32,
                     *, device: str | torch.device = "cuda") -> SparseConvParams:
    """Weights ~ N(0, 1/(K*C_in)) drawn from ``generator`` on its own
    device, then moved to ``device``; zero bias."""
    dev = require_device(device)
    fan_in = kernel_volume * c_in
    w = torch.randn((kernel_volume, c_in, c_out), generator=generator,
                    dtype=dtype, device=generator.device) / np.sqrt(fan_in)
    return SparseConvParams(w.to(dev), torch.zeros((c_out,), dtype=dtype,
                                                   device=dev))


# zero rows appended to a gather's input, which its holes read
HOLE_ROWS = 1024


def gather_partners(feats: torch.Tensor, coir: COIR) -> torch.Tensor:
    """(V, K, C) partner features; zeros at holes.

    A hole reads one of ``HOLE_ROWS`` zero rows appended to ``feats``
    (output row r reads zero row ``r % HOLE_ROWS``) in one ``index_select``,
    the same values as the JAX package's clamped take and mask. Under
    autograd the backward is a scatter-add into those rows: most of a
    plan's ``V*K`` entries are holes, and sent to one row (a clamp to 0)
    they made autograd's backward of an indexed gather serialize on it: a
    training step of the SCN at its published widths on 131,072 rows took
    25 s on an H100 that way, and takes 0.09 s this way."""
    v, k = coir.indices.shape
    n, c = feats.shape
    hole = n + torch.arange(v, device=feats.device) % HOLE_ROWS
    idx = torch.where(coir.valid(), coir.indices.long(), hole[:, None])
    padded = torch.cat([feats, feats.new_zeros((HOLE_ROWS, c))])
    return padded.index_select(0, idx.reshape(-1)).view(v, k, c)


def reference_conv_cirf(
    feats_in: torch.Tensor, coir: COIR, params: SparseConvParams
) -> torch.Tensor:
    """Out-major (CIRF) evaluation: gather + one contraction with f32
    accumulation, then bias and the output mask."""
    g = gather_partners(feats_in, coir)
    v, k, c = g.shape
    w = params.weight
    out = (g.reshape(v, k * c).float() @ w.reshape(k * c, -1).float()
           ).to(feats_in.dtype)
    out = out + params.bias.to(out.dtype)
    return out * coir.mask.unsqueeze(-1).to(out.dtype)


def sparse_conv_cirf(feats_in: torch.Tensor, coir: COIR,
                     params: SparseConvParams) -> torch.Tensor:
    """Deprecated: call ``repro_torch.engine.sparse_conv`` with a plan."""
    warnings.warn(
        "sparse_conv_cirf is deprecated; use repro_torch.engine.sparse_conv "
        "with a ConvPlan (backend='reference' reproduces these numerics "
        "exactly)", DeprecationWarning, stacklevel=2)
    from repro_torch.engine import api as engine_api  # the engine imports us

    return engine_api.sparse_conv(feats_in, params,
                                  engine_api.reference_plan(coir),
                                  backend="reference")


def masked_batchnorm_relu(x, mask, scale, offset, eps: float = 1e-5, *,
                          n_scenes: int = 1):
    """BN + ReLU over active rows only (the SCN conv-block epilogue).
    ``n_scenes > 1``: ``x`` holds that many scenes of equal capacity one
    after the other, and each is normalised by its own statistics (a
    reduction over a ``(n_scenes, capacity, C)`` view: no atomics)."""
    v, c = x.shape
    xs = x.reshape(n_scenes, v // n_scenes, c)
    m = mask.reshape(n_scenes, -1, 1).to(x.dtype)
    n = m.sum(1, keepdim=True).clamp(min=1.0)
    mean = (xs * m).sum(1, keepdim=True) / n
    var = ((xs - mean).square() * m).sum(1, keepdim=True) / n
    y = (xs - mean) * torch.rsqrt(var + eps) * scale + offset
    return (torch.relu(y) * m).reshape(v, c)


def sparse_conv_corf(feats_in: torch.Tensor, coir_in_major: COIR,
                     params: SparseConvParams, n_out: int) -> torch.Tensor:
    """In-major (CORF) evaluation: per-plane product, then a scatter-add
    into the response field (the paper's 'Output Write')."""
    n = params.weight.shape[-1]
    x = feats_in * coir_in_major.mask.unsqueeze(-1).to(feats_in.dtype)
    contrib = torch.einsum("ic,kcn->ikn", x.float(), params.weight.float())
    ok = coir_in_major.valid()
    rows = torch.where(ok, coir_in_major.indices, n_out).long().reshape(-1)
    out = torch.zeros((n_out + 1, n), dtype=torch.float32,
                      device=feats_in.device)
    out.index_add_(0, rows, torch.where(ok.unsqueeze(-1), contrib, 0.0)
                   .reshape(-1, n))
    out = out[:n_out].to(feats_in.dtype) + params.bias.to(feats_in.dtype)
    # a row is valid iff some valid pair targets it (invalid pairs go to
    # the trash row n_out, so real rows only ever receive True)
    valid_row = torch.zeros((n_out + 1,), dtype=torch.bool,
                            device=feats_in.device)
    valid_row[rows] = ok.reshape(-1)
    return out * valid_row[:n_out].unsqueeze(-1).to(out.dtype)


# ---------------------------------------------------------------------------
# Layer-level helpers on SparseVoxelTensor
# ---------------------------------------------------------------------------

def submanifold_coir(t: SparseVoxelTensor, resolution: int,
                     kernel_size: int = 3) -> COIR:
    """The submanifold conv's CIRF, built on ``t``'s device."""
    return build_cirf(t.coords, t.mask, t.coords, t.mask,
                      kernel_offsets(kernel_size), resolution)


def submanifold_conv(t: SparseVoxelTensor, coir: COIR,
                     params: SparseConvParams) -> SparseVoxelTensor:
    return t.replace_feats(reference_conv_cirf(t.feats, coir, params))


def strided_conv(t: SparseVoxelTensor, resolution: int,
                 params: SparseConvParams, kernel_size: int = 2,
                 stride: int = 2, capacity_out: int | None = None):
    """Downsampling conv; returns (out tensor, out resolution, coir)."""
    out_coords, out_mask = downsample_coords(t.coords, t.mask, resolution,
                                             stride, capacity_out)
    coir = build_cirf(out_coords, out_mask, t.coords, t.mask,
                      kernel_offsets(kernel_size, centered=False), resolution,
                      stride)
    feats = reference_conv_cirf(t.feats, coir, params)
    return (SparseVoxelTensor(out_coords, feats, out_mask),
            resolution // stride, coir)


def transposed_coir(coarse: SparseVoxelTensor, fine_coords: torch.Tensor,
                    fine_mask: torch.Tensor, fine_resolution: int,
                    kernel_size: int = 2, stride: int = 2) -> COIR:
    """CIRF of a transposed conv restoring the saved finer active set.

    Fine output o draws from coarse input i when ``o == i*stride + d``;
    this is the CORF probe with the roles swapped.
    """
    return build_corf(coarse.coords, coarse.mask, fine_coords, fine_mask,
                      kernel_offsets(kernel_size, centered=False),
                      fine_resolution, stride)


def transposed_conv(coarse: SparseVoxelTensor, coir_fine_major: COIR,
                    fine_coords: torch.Tensor, fine_mask: torch.Tensor,
                    params: SparseConvParams) -> SparseVoxelTensor:
    feats = reference_conv_cirf(coarse.feats, coir_fine_major, params)
    return SparseVoxelTensor(fine_coords, feats, fine_mask)


def batchnorm_relu(t: SparseVoxelTensor, scale: torch.Tensor,
                   offset: torch.Tensor, eps: float = 1e-5) -> SparseVoxelTensor:
    """Masked batch-norm + ReLU over active voxels only."""
    return t.replace_feats(
        masked_batchnorm_relu(t.feats, t.mask, scale, offset, eps))


# ---------------------------------------------------------------------------
# Dense oracle (for tests): sparse conv == masked dense conv
# ---------------------------------------------------------------------------

def dense_submanifold_reference(dense: np.ndarray, weight: np.ndarray,
                                bias: np.ndarray) -> np.ndarray:
    """O(R^3 K C N) dense evaluation of a submanifold conv, numpy oracle.

    dense: (R, R, R, C); weight: (K^3, C, N) in lexicographic offset order.
    An output voxel is active iff its input voxel is (submanifold rule).
    """
    r = dense.shape[0]
    occ = np.any(dense != 0, axis=-1)
    k = round(weight.shape[0] ** (1 / 3))
    out = np.zeros(dense.shape[:3] + (weight.shape[-1],), np.float32)
    for ki, (dx, dy, dz) in enumerate(kernel_offsets(k)):
        src = np.zeros_like(dense, dtype=np.float32)
        xs = slice(max(0, -dx), r - max(0, dx))
        xd = slice(max(0, dx), r - max(0, -dx))
        ys = slice(max(0, -dy), r - max(0, dy))
        yd = slice(max(0, dy), r - max(0, -dy))
        zs = slice(max(0, -dz), r - max(0, dz))
        zd = slice(max(0, dz), r - max(0, -dz))
        src[xs, ys, zs] = dense[xd, yd, zd]
        out += src.astype(np.float32) @ weight[ki].astype(np.float32)
    out += bias.astype(np.float32)
    return out * occ[..., None]
