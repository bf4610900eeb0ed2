"""Synthetic ScanNet-like labelled indoor scenes (port of ``repro.data.scenes``).

Procedurally builds rooms (floor, walls, furniture primitives), samples
surface points with normals, voxelizes, and labels each voxel by its
generating object class. ``make_lidar_sweep`` gives a LiDAR stream instead:
an ego window sliding over a persistent world. Host-side numpy: the same
seed gives byte-identical arrays to the JAX package's generators.

Classes: 0 floor, 1 wall, 2 box, 3 cylinder, 4 sphere. Features per point:
(nx, ny, nz, height).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.tensor import PAD_COORD

N_CLASSES = 5
N_FEATURES = 4


def _box_surface(rng, n, lo, hi):
    """n points on the surface of an axis-aligned box, with outward normals."""
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
         center[2] + z], axis=1,
    )
    normals = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], axis=1)
    return pts, normals


def make_scene(
    seed: int,
    resolution: int = 64,
    capacity: int = 8192,
    points_per_unit: float = 60000.0,
    n_objects: int = 4,
):
    """-> coords (V,3) int32, feats (V,4) f32, labels (V,) int32, mask (V,)."""
    rng = np.random.default_rng(seed)
    pts_list, nrm_list, lbl_list = [], [], []

    def add(pts, normals, label):
        pts_list.append(pts)
        nrm_list.append(normals)
        lbl_list.append(np.full(len(pts), label, np.int32))

    # Floor (z ~ 0.03) and two walls.
    nf = int(points_per_unit * 0.015)
    floor = np.stack(
        [rng.uniform(0.02, 0.98, nf), rng.uniform(0.02, 0.98, nf),
         np.full(nf, 0.03) + rng.normal(0, 0.002, nf)], axis=1,
    )
    add(floor, np.tile([0.0, 0.0, 1.0], (nf, 1)), 0)
    for wall_axis in (0, 1):
        nw = int(points_per_unit * 0.01)
        w = np.stack(
            [rng.uniform(0.02, 0.98, nw), rng.uniform(0.02, 0.98, nw),
             rng.uniform(0.03, 0.7, nw)], axis=1,
        )
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
                rng.uniform(0.03, 0.08), rng.uniform(0.1, 0.3),
            )
        else:
            r = rng.uniform(0.04, 0.1)
            pts, nrm = _sphere_surface(rng, npts, np.array([cx, cy, 0.03 + r]), r)
        add(pts, nrm, int(kind))

    pts = np.clip(np.concatenate(pts_list), 0.0, 0.999)
    nrm = np.concatenate(nrm_list)
    lbl = np.concatenate(lbl_list)
    feats = np.concatenate([nrm, pts[:, 2:3]], axis=1).astype(np.float32)

    # Voxelize with per-voxel majority label.
    ijk = np.clip((pts * resolution).astype(np.int64), 0, resolution - 1)
    key = (ijk[:, 0] * resolution + ijk[:, 1]) * resolution + ijk[:, 2]
    order = np.argsort(key, kind="stable")
    key_s, lbl_s, feat_s = key[order], lbl[order], feats[order]
    uniq, start, counts = np.unique(key_s, return_index=True, return_counts=True)
    n = min(len(uniq), capacity)
    coords = np.full((capacity, 3), PAD_COORD, np.int32)
    out_feats = np.zeros((capacity, N_FEATURES), np.float32)
    out_lbl = np.zeros((capacity,), np.int32)
    mask = np.zeros((capacity,), bool)
    coords[:n, 0] = (uniq[:n] // (resolution * resolution))
    coords[:n, 1] = (uniq[:n] // resolution) % resolution
    coords[:n, 2] = uniq[:n] % resolution
    for i in range(n):
        s, c = start[i], counts[i]
        out_feats[i] = feat_s[s:s + c].mean(0)
        out_lbl[i] = np.bincount(lbl_s[s:s + c], minlength=N_CLASSES).argmax()
    mask[:n] = True
    return coords, out_feats, out_lbl, mask


def _world_feats(wcoords: np.ndarray) -> np.ndarray:
    """Deterministic per-world-voxel features: a voxel retained between
    sweep frames carries bit-identical features in both (what a mapped
    static world looks like to the network)."""
    x = wcoords.astype(np.float64)
    f = np.stack(
        [np.sin(0.37 * x[:, 0] + 0.1), np.cos(0.53 * x[:, 1] + 0.2),
         np.sin(0.71 * x[:, 2] + 0.3), (x[:, 2] % 7) / 7.0], axis=1)
    return f.astype(np.float32)


def make_lidar_sweep(
    seed: int,
    n_frames: int,
    resolution: int = 32,
    capacity: int = 1024,
    *,
    step: int = 4,
    churn: float = 0.05,
    fill: float = 0.6,
):
    """Synthetic LiDAR sweep: an ego window sliding over a persistent world.

    A static "world" corridor of voxels (span ``resolution + step *
    (n_frames-1)`` along x) is sampled once from ``seed``; frame *i* sees
    the window ``[i*step, i*step + resolution)`` re-based to the ego frame
    (world x minus ``i*step``). Two churn mechanisms perturb the static
    picture per frame: a ``churn`` fraction of visible world voxels is
    dropped (occlusion / dynamic objects leaving) and a matching number of
    frame-local voxels appears. Steady-state voxel overlap between
    consecutive frames is roughly ``(1 - step/resolution) * (1-churn)^2``
    — tune ``step`` and ``churn`` to sweep it.

    Active voxels land on *random rows* each frame (no canonical order),
    so consumers exercise the streaming planner's row re-packing. Features
    are a deterministic function of *world* position (retained voxels are
    bit-identical across frames); labels likewise. Everything derives from
    ``seed``.

    ``step`` should stay divisible by ``2**(n_levels-1)`` of the consuming
    U-Net (the default 4 covers 3 levels) — an unaligned ego shift makes
    the incremental planner fall back to full rebuilds.

    Returns ``(frames, ego_shifts)``: ``frames[i] = (coords (V,3) int32,
    feats (V,4) f32, labels (V,) int32, mask (V,))`` with ``V=capacity``,
    and ``ego_shifts[i]`` the ego translation since frame *i-1*
    (``(0,0,0)`` for frame 0).
    """
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    rng = np.random.default_rng(seed)
    span = resolution + step * (n_frames - 1)
    total = span * resolution * resolution
    n_world = min(int(fill * capacity * span / resolution), total)
    wkeys = np.sort(rng.choice(total, size=n_world, replace=False))
    wx = (wkeys // (resolution * resolution)).astype(np.int64)

    def decode(keys):
        r = resolution
        return np.stack([keys // (r * r), (keys // r) % r, keys % r],
                        axis=1).astype(np.int64)

    frames = []
    ego_shifts = []
    for i in range(n_frames):
        f_rng = np.random.default_rng((seed, 1000 + i))
        x0 = i * step
        vis = wkeys[(wx >= x0) & (wx < x0 + resolution)]
        keep = f_rng.random(len(vis)) >= churn
        statics = vis[keep]
        # frame-local appearances: window cells outside the static world
        n_dyn = int(round(churn * len(vis)))
        cand = (f_rng.integers(x0, x0 + resolution, size=4 * n_dyn + 8)
                * resolution * resolution
                + f_rng.integers(0, resolution * resolution,
                                 size=4 * n_dyn + 8))
        cand = np.unique(cand)
        cand = cand[~np.isin(cand, wkeys)][:n_dyn]
        keys = np.concatenate([statics, cand])
        if len(keys) > capacity:
            keys = keys[np.sort(f_rng.choice(len(keys), size=capacity,
                                             replace=False))]
        wc = decode(keys)
        n = len(keys)
        rows = f_rng.choice(capacity, size=n, replace=False)
        coords = np.full((capacity, 3), PAD_COORD, np.int32)
        feats = np.zeros((capacity, N_FEATURES), np.float32)
        labels = np.zeros((capacity,), np.int32)
        mask = np.zeros((capacity,), bool)
        ego = wc.copy()
        ego[:, 0] -= x0
        coords[rows] = ego.astype(np.int32)
        feats[rows] = _world_feats(wc)
        labels[rows] = (wc.sum(axis=1) % N_CLASSES).astype(np.int32)
        mask[rows] = True
        frames.append((coords, feats, labels, mask))
        ego_shifts.append((step, 0, 0) if i else (0, 0, 0))
    return frames, ego_shifts


def scene_batch_iterator(seed: int, batch: int, resolution: int, capacity: int):
    """Deterministic, restartable scene stream (state = next seed)."""
    step = 0
    while True:
        out = [make_scene(seed + step * batch + b, resolution, capacity)
               for b in range(batch)]
        coords, feats, labels, mask = (np.stack(x) for x in zip(*out))
        yield {"coords": coords, "feats": feats, "labels": labels,
               "mask": mask, "state": {"seed": seed, "step": step + 1}}
        step += 1
