"""Plain PyTorch reference of the SCN U-Net (SparseConvNet's ScanNet U-Net:
Graham et al., arXiv:1711.10275), one scene at a time, in f32.

It builds its own rulebooks from the voxel coordinates: each level's
active set is the unique coordinates of the level below halved; a
submanifold 3^3 conv reads, for each active voxel and each of the 27
offsets (lexicographic, x major, from -1 to 1), the active neighbour there;
the 2^3 stride-2 conv sums, into each coarse voxel, its fine voxels' rows,
each through the plane of its offset from twice the coarse voxel
(lexicographic over {0, 1}^3); the transposed conv gives each fine voxel
its coarse parent's row through the same plane. A conv adds its bias.
BatchNorm normalises over the scene's active voxels with their mean and
biased variance (eps 1e-5), then scales, offsets and applies a ReLU. The
network: a stem conv (no norm), then at each level ``reps`` conv blocks and
a down conv; back up, a transposed conv, the skip concatenated before the
upsampled features, ``reps`` conv blocks; a linear head.

Weights are the benchmark's dict (``weight_shapes``), named like the
program's module; ``pairs`` counts each conv's rulebook pairs.
"""
from __future__ import annotations

import itertools

import torch

from portbench.reference.precision import exact_f32, matmul

BN_EPS = 1e-5


def offsets(size: int, centered: bool) -> torch.Tensor:
    lo = -(size // 2) if centered else 0
    rng = range(lo, lo + size)
    return torch.tensor(list(itertools.product(rng, rng, rng)),
                        dtype=torch.int64)


def weight_shapes(widths, reps: int, in_channels: int,
                  n_classes: int) -> dict[str, tuple]:
    """Name -> shape of every weight, in the program module's names."""
    out = {"stem.weight": (27, in_channels, widths[0]),
           "stem.bias": (widths[0],)}
    for li, w in enumerate(widths):
        blocks = [("enc", r, w) for r in range(reps)]
        if li < len(widths) - 1:
            out[f"levels.{li}.down.weight"] = (8, w, widths[li + 1])
            out[f"levels.{li}.down.bias"] = (widths[li + 1],)
            out[f"levels.{li}.up.weight"] = (8, widths[li + 1], w)
            out[f"levels.{li}.up.bias"] = (w,)
            blocks += [("dec", r, 2 * w if r == 0 else w) for r in range(reps)]
        for kind, r, c_in in blocks:
            p = f"levels.{li}.{kind}.{r}"
            out[f"{p}.conv.weight"] = (27, c_in, w)
            out[f"{p}.conv.bias"] = (w,)
            out[f"{p}.bn_scale"] = (w,)
            out[f"{p}.bn_offset"] = (w,)
    out["head.w"] = (widths[0], n_classes)
    out["head.b"] = (n_classes,)
    return out


class Rulebooks:
    """One scene's levels: coordinates, the submanifold neighbours (n, 27)
    (-1 where none), and each voxel's parent row one level down with the
    plane of its offset."""

    def __init__(self, coords: torch.Tensor, resolution: int, n_levels: int):
        self.coords, self.nbrs, self.parent, self.plane = [], [], [], []
        c, res = coords.long(), resolution
        off3 = offsets(3, True).to(c.device)
        for li in range(n_levels):
            self.coords.append(c)
            self.nbrs.append(self._neighbours(c, res, off3))
            if li == n_levels - 1:
                break
            coarse, inv = torch.unique(c // 2, dim=0, return_inverse=True)
            d = c - 2 * coarse[inv]
            self.parent.append(inv)
            self.plane.append(d[:, 0] * 4 + d[:, 1] * 2 + d[:, 2])
            c, res = coarse, res // 2

    @staticmethod
    def _neighbours(c: torch.Tensor, res: int, off: torch.Tensor):
        key = (c[:, 0] * res + c[:, 1]) * res + c[:, 2]
        skey, perm = torch.sort(key)
        q = c[:, None, :] + off[None]
        inside = ((q >= 0) & (q < res)).all(-1)
        qk = (q[..., 0] * res + q[..., 1]) * res + q[..., 2]
        pos = torch.searchsorted(skey, qk).clamp(max=len(skey) - 1)
        hit = inside & (skey[pos] == qk)
        return torch.where(hit, perm[pos], -1)

    def pairs(self) -> dict[str, list[int]]:
        """Rulebook pairs of each level's submanifold conv, and of its down
        and up conv (one a fine voxel)."""
        return {"sub": [int((n >= 0).sum()) for n in self.nbrs],
                "down": [len(p) for p in self.parent],
                "rows": [len(c) for c in self.coords]}


def _sub_conv(x, nbr, w, b, precision):
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx = torch.where(nbr >= 0, nbr, x.shape[0])
    out = b.float().expand(x.shape[0], -1).clone()
    for k in range(w.shape[0]):
        out += matmul(pad[idx[:, k]], w[k], precision)
    return out


def _down_conv(x, parent, plane, n_coarse, w, b, precision):
    out = b.float().expand(n_coarse, -1).clone()
    for d in range(8):
        sel = plane == d
        out.index_add_(0, parent[sel], matmul(x[sel], w[d], precision))
    return out


def _up_conv(xc, parent, plane, w, b, precision):
    out = b.float().expand(len(parent), -1).clone()
    for d in range(8):
        sel = plane == d
        out[sel] += matmul(xc[parent[sel]], w[d], precision)
    return out


def _bn_relu(x, scale, offset):
    mean = x.mean(0, keepdim=True)
    var = (x - mean).square().mean(0, keepdim=True)
    return torch.relu((x - mean) * torch.rsqrt(var + BN_EPS) * scale.float()
                      + offset.float())


@torch.no_grad()
def forward(weights: dict, rb: Rulebooks, feats: torch.Tensor,
            n_levels: int, reps: int, precision: str = "f32") -> torch.Tensor:
    """Logits (n active voxels, n_classes) of one scene, its active rows in
    the order of ``rb.coords[0]``."""
    W = weights

    def block(x, li, kind, r):
        p = f"levels.{li}.{kind}.{r}"
        y = _sub_conv(x, rb.nbrs[li], W[f"{p}.conv.weight"],
                      W[f"{p}.conv.bias"], precision)
        return _bn_relu(y, W[f"{p}.bn_scale"], W[f"{p}.bn_offset"])

    with exact_f32():
        x = _sub_conv(feats.float(), rb.nbrs[0], W["stem.weight"],
                      W["stem.bias"], precision)
        skips = []
        for li in range(n_levels):
            for r in range(reps):
                x = block(x, li, "enc", r)
            if li < n_levels - 1:
                skips.append(x)
                x = _down_conv(x, rb.parent[li], rb.plane[li],
                               len(rb.coords[li + 1]),
                               W[f"levels.{li}.down.weight"],
                               W[f"levels.{li}.down.bias"], precision)
        for li in range(n_levels - 2, -1, -1):
            up = _up_conv(x, rb.parent[li], rb.plane[li],
                          W[f"levels.{li}.up.weight"],
                          W[f"levels.{li}.up.bias"], precision)
            x = torch.cat([skips[li], up], dim=-1)
            for r in range(reps):
                x = block(x, li, "dec", r)
        return matmul(x, W["head.w"], precision) + W["head.b"].float()
