"""Synthetic ScanNet-like rooms: a copy of the port's
``repro_torch.data.scenes.make_scene``, with its per-voxel loop turned into
array operations (feature means summed in float64, so a mean may differ from
the loop's float32 one in its last bit; labels are the same majority, ties to
the lowest class).

Classes: 0 floor, 1 wall, 2 box, 3 cylinder, 4 sphere. Features per point:
(nx, ny, nz, height). Padding rows have coordinates -1 and mask False.
"""
from __future__ import annotations

import numpy as np

N_CLASSES = 5
N_FEATURES = 4
PAD_COORD = -1


def _box_surface(rng, n, lo, hi):
    pts = rng.uniform(lo, hi, (n, 3))
    face = rng.integers(0, 6, n)
    axis, side = face // 2, face % 2
    pts[np.arange(n), axis] = np.where(side == 0, lo[axis], hi[axis])
    normals = np.zeros((n, 3))
    normals[np.arange(n), axis] = np.where(side == 0, -1.0, 1.0)
    return pts, normals


def _sphere_surface(rng, n, center, radius):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    return center + radius * v, v


def _cylinder_surface(rng, n, center, radius, height):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, height, n)
    pts = np.stack(
        [center[0] + radius * np.cos(theta), center[1] + radius * np.sin(theta),
         center[2] + z], axis=1)
    normals = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], axis=1)
    return pts, normals


def make_scene(seed: int, resolution: int = 64, capacity: int = 8192,
               points_per_unit: float = 60000.0, n_objects: int = 4):
    """-> coords (V,3) int32, feats (V,4) f32, labels (V,) int32, mask (V,)
    bool, active rows first in (x, y, z) order."""
    rng = np.random.default_rng(seed)
    pts_list, nrm_list, lbl_list = [], [], []

    def add(pts, normals, label):
        pts_list.append(pts)
        nrm_list.append(normals)
        lbl_list.append(np.full(len(pts), label, np.int32))

    nf = int(points_per_unit * 0.015)
    floor = np.stack(
        [rng.uniform(0.02, 0.98, nf), rng.uniform(0.02, 0.98, nf),
         np.full(nf, 0.03) + rng.normal(0, 0.002, nf)], axis=1)
    add(floor, np.tile([0.0, 0.0, 1.0], (nf, 1)), 0)
    for wall_axis in (0, 1):
        nw = int(points_per_unit * 0.01)
        w = np.stack(
            [rng.uniform(0.02, 0.98, nw), rng.uniform(0.02, 0.98, nw),
             rng.uniform(0.03, 0.7, nw)], axis=1)
        w[:, wall_axis] = 0.03 + rng.normal(0, 0.002, nw)
        nrm = np.zeros((nw, 3))
        nrm[:, wall_axis] = 1.0
        add(w, nrm, 1)

    for _ in range(n_objects):
        kind = rng.integers(2, 5)
        npts = int(points_per_unit * 0.004)
        cx, cy = rng.uniform(0.2, 0.8, 2)
        if kind == 2:
            size = rng.uniform(0.06, 0.18, 3)
            lo = np.array([cx, cy, 0.03])
            pts, nrm = _box_surface(rng, npts, lo, lo + size)
        elif kind == 3:
            pts, nrm = _cylinder_surface(
                rng, npts, np.array([cx, cy, 0.03]),
                rng.uniform(0.03, 0.08), rng.uniform(0.1, 0.3))
        else:
            r = rng.uniform(0.04, 0.1)
            pts, nrm = _sphere_surface(rng, npts, np.array([cx, cy, 0.03 + r]),
                                       r)
        add(pts, nrm, int(kind))

    pts = np.clip(np.concatenate(pts_list), 0.0, 0.999)
    nrm = np.concatenate(nrm_list)
    lbl = np.concatenate(lbl_list)
    feats = np.concatenate([nrm, pts[:, 2:3]], axis=1).astype(np.float32)

    # voxelize: mean features and the majority label of each voxel's points
    ijk = np.clip((pts * resolution).astype(np.int64), 0, resolution - 1)
    key = (ijk[:, 0] * resolution + ijk[:, 1]) * resolution + ijk[:, 2]
    order = np.argsort(key, kind="stable")
    key_s, lbl_s, feat_s = key[order], lbl[order], feats[order]
    uniq, start, counts = np.unique(key_s, return_index=True,
                                    return_counts=True)
    n = min(len(uniq), capacity)
    sums = np.add.reduceat(feat_s.astype(np.float64), start, axis=0)
    means = (sums / counts[:, None]).astype(np.float32)
    voxel = np.repeat(np.arange(len(uniq)), counts)
    votes = np.zeros((len(uniq), N_CLASSES), np.int64)
    np.add.at(votes, (voxel, lbl_s), 1)
    coords = np.full((capacity, 3), PAD_COORD, np.int32)
    out_feats = np.zeros((capacity, N_FEATURES), np.float32)
    out_lbl = np.zeros((capacity,), np.int32)
    mask = np.zeros((capacity,), bool)
    coords[:n, 0] = uniq[:n] // (resolution * resolution)
    coords[:n, 1] = (uniq[:n] // resolution) % resolution
    coords[:n, 2] = uniq[:n] % resolution
    out_feats[:n] = means[:n]
    out_lbl[:n] = votes[:n].argmax(1)
    mask[:n] = True
    return coords, out_feats, out_lbl, mask
