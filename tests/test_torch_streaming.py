"""Port parity for SCN streaming: the port's incremental LiDAR planner
(``UpdatableSortedGrid``, ``StreamMetaState``, ``StreamPlanState``), its
sweep generator and voxelizer, its fault injector and
``SceneEngine.open_stream`` / ``serve_stream`` against the JAX package's,
on the same numpy inputs.

Tables, plans, frame rows and modes are compared exactly: the port's
planner is numpy, as the JAX package's is. Patched tables are also held
against the port's own from-scratch pyramid on the re-packed frame.
Logits are compared as max |got - want| / max(|want|, 1) against the JAX
package (f32 sums in another order), and bit for bit within the port.
Every grid is a fixed ``parametrize`` list, so no run writes a
Hypothesis database.
"""
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import hashgrid as jhashgrid
from repro.core import host_meta as jhost_meta
from repro.data.scenes import make_lidar_sweep as jmake_lidar_sweep
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.serving import faults as jfaults
from repro.serving.scene_engine import SceneEngine as JSceneEngine
from repro.serving.scene_engine import SceneRequest as JSceneRequest
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro.sparse.voxelize import voxelize as jvoxelize
from repro_torch import engine
from repro_torch.core.hashgrid import UpdatableSortedGrid, kernel_offsets
from repro_torch.core.host_meta import (
    StreamMetaState,
    build_cirf_np,
    diff_scene_np,
    downsample_coords_np,
    linear_key_np,
    pack_stream_frame_np,
    transposed_coir_np,
)
from repro_torch.data.scenes import N_CLASSES, make_lidar_sweep, make_scene
from repro_torch.engine.backends import DEFAULT_REGISTRY
from repro_torch.models.scn import SCNUNet, UNetConfig, params_from_jax
from repro_torch.serving import faults
from repro_torch.serving.api import AdmissionPolicy, ServeRequest
from repro_torch.serving.scene_engine import (
    SceneEngine,
    SceneRequest,
    StreamHandle,
)
from repro_torch.serving.scheduler import WaveScheduler
from repro_torch.sparse.tensor import PAD_COORD, SparseVoxelTensor
from repro_torch.sparse.voxelize import voxelize

ROOT = Path(__file__).resolve().parents[1]
# the table tests' sweeps: three pyramid levels, so ego shifts of 4 and 8
# are aligned
RES, CAP, LEVELS = 16, 256, 3
OFFS3 = kernel_offsets(3)
OFFS2 = kernel_offsets(2, centered=False)
# the plan and serving tests' sweeps: big enough that a pinned spec puts
# every level on sspnna
SRES, SCAP = 32, 4096
SCFG = dict(widths=(16, 32, 48), reps=1, resolution=SRES, capacity=SCAP,
            n_classes=N_CLASSES)
TOL = 1e-4


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def _eq(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _coir_eq(got, want, msg):
    for leaf in ("indices", "bitmask", "mask"):
        _eq(getattr(got, leaf), getattr(want, leaf), f"{msg}.{leaf}")


def _scratch_pyramid(coords, mask, res, n_levels):
    """From-scratch reference: geometry + sub/down/up COIRs per level."""
    geo, c, m, r = [], coords, mask, res
    for li in range(n_levels):
        geo.append((c, m, r))
        if li < n_levels - 1:
            c, m = downsample_coords_np(c, m, r, 2)
            r //= 2
    subs = [build_cirf_np(c, m, c, m, OFFS3, r) for c, m, r in geo]
    downs, ups = [], []
    for li in range(n_levels - 1):
        fc, fm, fr = geo[li]
        cc, cm, _ = geo[li + 1]
        downs.append(build_cirf_np(cc, cm, fc, fm, OFFS2, fr, stride=2))
        ups.append(transposed_coir_np(cc, cm, fc, fm, fr, 2, 2))
    return geo, subs, downs, ups


def _pack_frame(coords, mask, frame_rows, cap):
    """Re-pack a caller-layout frame into the stream's canonical rows."""
    act = np.flatnonzero(mask)
    assert (frame_rows[act] >= 0).all()
    pc = np.full((cap, 3), PAD_COORD, np.int32)
    pm = np.zeros(cap, bool)
    pc[frame_rows[act]] = coords[act]
    pm[frame_rows[act]] = True
    return pc, pm


def _assert_meta_equal(got, want, ctx):
    """A port StreamFrameMeta against the JAX package's, field by field."""
    assert (got.mode, got.overlap) == (want.mode, want.overlap), ctx
    assert got.info == want.info, ctx
    assert got.changed == want.changed, ctx
    assert got.pair_changed == want.pair_changed, ctx
    _eq(got.frame_rows, want.frame_rows, f"frame_rows {ctx}")
    for li, ((c, m, s), (jc, jm, js)) in enumerate(
            zip(got.levels, want.levels, strict=True)):
        _eq(c, jc, f"coords L{li} {ctx}")
        _eq(m, jm, f"mask L{li} {ctx}")
        _coir_eq(s, js, f"sub L{li} {ctx}")
    for li, ((d, u), (jd, ju)) in enumerate(
            zip(got.pairs, want.pairs, strict=True)):
        _coir_eq(d, jd, f"down L{li} {ctx}")
        _coir_eq(u, ju, f"up L{li} {ctx}")


def _assert_meta_matches_scratch(meta, state, ctx):
    coords, mask = state.coords[0], state.mask[0]
    geo, subs, downs, ups = _scratch_pyramid(coords, mask, state.resolution,
                                             state.n_levels)
    for li in range(state.n_levels):
        gc, gm, _ = geo[li]
        sc, sm, scoir = meta.levels[li]
        _eq(sc, gc, f"coords L{li} {ctx}")
        _eq(sm, gm, f"mask L{li} {ctx}")
        _coir_eq(scoir, subs[li], f"sub L{li} {ctx} mode={meta.mode}")
    for li in range(state.n_levels - 1):
        d, u = meta.pairs[li]
        _coir_eq(d, downs[li], f"down L{li} {ctx}")
        _coir_eq(u, ups[li], f"up L{li} {ctx}")


def _dispatch_fields(d) -> dict:
    return {f: getattr(d, f) for f in
            ("backend", "flavor", "walk", "delta_o", "delta_i", "n_tiles")}


def _assert_plan_equal(got, want, ctx):
    """A port host plan against the JAX package's: every leaf, dispatch
    and tile-overflow note."""
    assert len(got.levels) == len(want.levels), ctx
    for li, (a, b) in enumerate(zip(got.levels, want.levels)):
        _eq(a.coords, b.coords, f"coords L{li} {ctx}")
        _eq(a.mask, b.mask, f"mask L{li} {ctx}")
        for name in ("sub", "down", "up"):
            ca, cb = getattr(a, name), getattr(b, name)
            assert (ca is None) == (cb is None), f"{name} L{li} {ctx}"
            if ca is None:
                continue
            _coir_eq(ca.coir, cb.coir, f"{name} L{li} {ctx}")
            assert (ca.tiles is None) == (cb.tiles is None), ctx
            if ca.tiles is not None:
                for f in ("out_rows", "in_rows", "local_idx", "pair_counts"):
                    _eq(getattr(ca.tiles, f), getattr(cb.tiles, f),
                        f"{name}.tiles.{f} L{li} {ctx}")
            assert _dispatch_fields(ca.dispatch) == \
                _dispatch_fields(cb.dispatch), f"{name} L{li} {ctx}"
    for a, b in zip(got.stats, want.stats, strict=True):
        assert a.get("tile_overflow") == b.get("tile_overflow"), ctx


# -- UpdatableSortedGrid ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_updatable_grid_matches_jax(seed):
    """The same from_coords / delete / shift / insert sequence on both
    packages' grids: equal keys, rows and lookups (and the lookups equal
    a dict of the live voxels)."""
    rng = np.random.default_rng(seed)
    res, cap = 16, 200
    keys = rng.choice(res**3, size=120, replace=False)
    coords = np.full((cap, 3), PAD_COORD, np.int32)
    mask = np.zeros(cap, bool)
    rows = rng.choice(cap, size=120, replace=False)
    coords[rows] = np.stack([keys // (res * res), (keys // res) % res,
                             keys % res], 1)
    mask[rows] = True
    ours = UpdatableSortedGrid.from_coords(coords, mask, res)
    theirs = jhashgrid.UpdatableSortedGrid.from_coords(coords, mask, res)
    table = {int(k): int(r) for k, r in zip(ours.keys, ours.rows)}
    koff = -(4 * res * res)  # ego shift of (4, 0, 0)
    drop = np.sort(rng.choice(ours.keys, size=40, replace=False))
    oob = ours.keys[ours.keys + koff < 0]
    gone = np.union1d(drop, oob)
    fresh = np.sort(np.setdiff1d(rng.choice(res**3, size=50, replace=False),
                                 ours.keys[~np.isin(ours.keys, gone)] + koff))
    fresh = fresh.astype(np.int32)
    frows = (1000 + np.arange(len(fresh))).astype(np.int32)
    for grid in (ours, theirs):
        grid.delete(gone)
        grid.shift(koff)
        grid.insert(fresh, frows)
    table = {k + koff: v for k, v in table.items() if k not in set(gone.tolist())}
    table.update(zip(fresh.tolist(), frows.tolist()))
    _eq(ours.keys, theirs.keys, "keys")
    _eq(ours.rows, theirs.rows, "rows")
    assert len(ours) == len(table)
    assert np.all(np.diff(ours.keys) > 0)
    q = rng.integers(-1, res + 1, (500, 3)).astype(np.int32)
    valid = rng.random(500) < 0.9
    got = ours.lookup(q, valid)
    _eq(got, theirs.lookup(q, valid), "lookup")
    want = [table.get(int((c[0] * res + c[1]) * res + c[2]), -1)
            if v and np.all((c >= 0) & (c < res)) else -1
            for c, v in zip(q, valid)]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        ours.delete(np.array([res**3 + 5], np.int32))


# -- frame diff, packing, sweeps, voxelize ----------------------------------


SWEEPS = [(7, 0.0, 4), (11, 0.05, 8), (3, 0.3, 4)]


@pytest.mark.parametrize("seed,churn,step", SWEEPS)
def test_lidar_sweep_matches_jax(seed, churn, step):
    ours, o_shifts = make_lidar_sweep(seed, 3, resolution=RES, capacity=CAP,
                                      step=step, churn=churn)
    theirs, t_shifts = jmake_lidar_sweep(seed, 3, resolution=RES,
                                         capacity=CAP, step=step, churn=churn)
    assert o_shifts == t_shifts
    for fo, ft in zip(ours, theirs, strict=True):
        for i, (a, b) in enumerate(zip(fo, ft, strict=True)):
            _eq(a, b, f"frame array {i}")
    with pytest.raises(ValueError):
        make_lidar_sweep(seed, 0)


@pytest.mark.parametrize("seed,churn,step", SWEEPS)
def test_diff_and_pack_match_jax(seed, churn, step):
    frames, shifts = make_lidar_sweep(seed, 2, resolution=RES, capacity=CAP,
                                      step=step, churn=churn)
    (c0, f0, _, m0), (c1, f1, _, m1) = frames
    for shift in (shifts[1], (0, 0, 0), (step + 4, 0, 0)):
        got = diff_scene_np(c0, m0, c1, m1, RES, shift)
        want = jhost_meta.diff_scene_np(c0, m0, c1, m1, RES, shift)
        for f in ("retained_prev_rows", "retained_new_rows",
                  "added_new_rows", "removed_prev_rows"):
            _eq(getattr(got, f), getattr(want, f), f)
        assert (got.n_prev, got.n_new, got.overlap) == \
            (want.n_prev, want.n_new, want.overlap)
    rows = np.where(m1, np.random.default_rng(seed).permutation(CAP),
                    -1).astype(np.int32)
    _eq(pack_stream_frame_np(rows, f1),
        jhost_meta.pack_stream_frame_np(rows, f1), "packed feats")


@pytest.mark.parametrize("n_points,capacity", [(500, None), (2000, 64),
                                               (1, 8)])
def test_voxelize_matches_jax(n_points, capacity):
    rng = np.random.default_rng(n_points)
    pts = rng.random((n_points, 3))
    feats = rng.normal(size=(n_points, 4)).astype(np.float32)
    got = voxelize(pts, feats, 16, capacity)
    want = jvoxelize(pts, feats, 16, capacity)
    for a, b in zip(got, want, strict=True):
        _eq(a, b, "voxelize")
    with pytest.raises(ValueError):
        voxelize(pts[:, :2], feats, 16)


# -- StreamMetaState --------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("churn", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("step", [4, 8])
def test_stream_meta_matches_jax_and_scratch(seed, churn, step):
    """Every frame's tables (patched or rebuilt) equal the JAX package's
    and the port's own from-scratch pyramid on the re-packed frame."""
    frames, shifts = make_lidar_sweep(seed, 4, resolution=RES, capacity=CAP,
                                      step=step, churn=churn)
    ours = StreamMetaState(RES, CAP, LEVELS)
    theirs = jhost_meta.StreamMetaState(RES, CAP, LEVELS)
    modes = []
    for t, ((c, _, _, m), shift) in enumerate(zip(frames, shifts)):
        ctx = f"t={t} seed={seed} churn={churn} step={step}"
        got = ours.step(c, m, ego_shift=shift)
        _assert_meta_equal(got, theirs.step(c, m, ego_shift=shift), ctx)
        pc, pm = _pack_frame(c, m, got.frame_rows, CAP)
        _eq(ours.coords[0], pc, ctx)
        _eq(ours.mask[0], pm, ctx)
        _assert_meta_matches_scratch(got, ours, ctx)
        modes.append(got.mode)
    assert modes[0] == "rebuilt"
    if step == 4 and churn < 0.3:  # overlap ~0.75 (step 8 halves the window)
        assert set(modes[1:]) == {"patched"}


def _frames_for(fallback):
    """(frames, shifts) of two steps whose second takes ``fallback``."""
    frames, shifts = make_lidar_sweep(3, 2, resolution=RES, capacity=CAP,
                                      step=4, churn=0.05)
    (c0, _, _, m0), (c1, _, _, m1) = frames
    if fallback == "ego_shift_alignment":
        return [(c0, m0), (c1, m1)], [(0, 0, 0), (3, 0, 0)]
    if fallback == "empty_frame":
        return ([(c0, m0), (np.full((CAP, 3), PAD_COORD, np.int32),
                            np.zeros(CAP, bool)), (c1, m1)],
                [(0, 0, 0), (0, 0, 0), (4, 0, 0)])
    if fallback == "churn":
        far_c = np.full((CAP, 3), PAD_COORD, np.int32)
        far_m = np.zeros(CAP, bool)
        far_c[:4] = [[15, 15, 15], [15, 15, 14], [15, 14, 15], [14, 15, 15]]
        far_m[:4] = True
        k0 = set(linear_key_np(c0[m0], RES).tolist())
        assert not set(linear_key_np(far_c[:4], RES).tolist()) & k0
        return [(c0, m0), (far_c, far_m)], [(0, 0, 0), (0, 0, 0)]
    if fallback == "reused":
        return [(c0, m0), (c0, m0)], [(0, 0, 0), (0, 0, 0)]
    return [(c0, m0)], [(0, 0, 0)]  # first_frame


@pytest.mark.parametrize("fallback", ["first_frame", "ego_shift_alignment",
                                      "empty_frame", "churn", "reused"])
def test_stream_meta_fallbacks_match_jax(fallback):
    frames, shifts = _frames_for(fallback)
    ours = StreamMetaState(RES, CAP, LEVELS)
    theirs = jhost_meta.StreamMetaState(RES, CAP, LEVELS)
    metas = []
    for t, ((c, m), shift) in enumerate(zip(frames, shifts)):
        got = ours.step(c, m, ego_shift=shift)
        _assert_meta_equal(got, theirs.step(c, m, ego_shift=shift),
                           f"{fallback} t={t}")
        if got.mode != "reused":
            _assert_meta_matches_scratch(got, ours, f"{fallback} t={t}")
        metas.append(got)
    last = metas[1] if len(metas) > 1 else metas[0]
    if fallback == "reused":
        assert last.mode == "reused" and last.overlap == 1.0
        assert last.changed == [False] * LEVELS
    else:
        assert last.mode == "rebuilt"
        assert last.info["fallback"] == fallback
    if fallback == "empty_frame":
        # the empty base makes the next frame rebuild too
        assert metas[2].mode == "rebuilt"
    with pytest.raises(ValueError, match="capacity"):
        ours.step(np.zeros((CAP + 1, 3), np.int32), np.zeros(CAP + 1, bool))


def test_stream_meta_rejects_unaligned_resolution():
    with pytest.raises(ValueError, match="not divisible"):
        StreamMetaState(18, CAP, 3)


# -- StreamPlanState --------------------------------------------------------


def _sweep_scenes(seed, n=4, step=4, churn=0.05):
    frames, shifts = make_lidar_sweep(seed, n, resolution=SRES,
                                      capacity=SCAP, step=step, churn=churn)
    return ([(c, f, m) for c, f, _, m in frames], shifts)


@pytest.fixture(scope="module")
def specs():
    """Both packages' specs pinned from the first frames of two sweeps."""
    firsts = [_sweep_scenes(s, n=1)[0][0] for s in (0, 1)]
    spec = engine.build_plan_spec([SparseVoxelTensor(*a) for a in firsts],
                                  UNetConfig(**SCFG))
    jspec = jengine.build_plan_spec([JSparseVoxelTensor(*a) for a in firsts],
                                    JUNetConfig(**SCFG))
    assert all(d.backend == engine.SSPNNA for d in spec.levels)
    assert [_dispatch_fields(d) for d in spec.levels] == \
        [_dispatch_fields(d) for d in jspec.levels]
    return spec, jspec


@pytest.mark.parametrize("mode", ["untiled", "adaptive", "pinned"])
def test_stream_plan_state_matches_jax(specs, mode):
    """Every frame's host plan leaf, frame_rows, mode and overlap equal the
    JAX package's; each plan also equals the from-scratch plan of the
    re-packed frame, and is registered in the plan cache. ``untiled`` is
    the default without a spec (every conv on reference)."""
    spec, jspec = specs if mode == "pinned" else (None, None)
    kw = {} if mode == "untiled" else {"plan_tiles": True}
    cfg = UNetConfig(**SCFG)
    frames, shifts = _sweep_scenes(11)
    cache = engine.PlanCache()
    ours = engine.StreamPlanState(cfg, cache=cache, spec=spec,
                                  stream_id="a", device="cpu", **kw)
    theirs = jengine.StreamPlanState(JUNetConfig(**SCFG), spec=jspec,
                                     stream_id="a", **kw)
    assert ours.plan_tiles == theirs.plan_tiles == (mode != "untiled")
    for fno, ((c, f, m), shift) in enumerate(zip(frames, shifts)):
        key, plan, rows, info = ours.plan_frame(
            SparseVoxelTensor(c, f, m), fno, shift)
        _, jplan, jrows, jinfo = theirs.plan_frame(
            JSparseVoxelTensor(c, f, m), fno, shift)
        ctx = f"frame {fno} ({info['mode']})"
        _eq(rows, jrows, f"frame_rows {ctx}")
        assert (info["mode"], info["overlap"]) == \
            (jinfo["mode"], jinfo["overlap"])
        _assert_plan_equal(plan, jplan, ctx)
        pc, pm = _pack_frame(c, m, rows, SCAP)
        scratch = engine.build_scene_plan_host(
            SparseVoxelTensor(pc, np.zeros_like(f), pm), cfg, spec=spec,
            plan_tiles=ours.plan_tiles)
        _assert_plan_equal(plan, scratch, f"scratch {ctx}")
        assert key.startswith("stream|a|") and key.endswith(f"|f{fno}")
        assert cache.adopt(key, None, device=False) is plan
        assert info["mode"] == ("rebuilt" if fno == 0 else "patched")
    agg = ours.stats()
    assert (agg["frames"], agg["patched"], agg["rebuilt"]) == (4, 3, 1)
    assert agg["mean_overlap"] == theirs.stats()["mean_overlap"]


def test_reused_frame_keeps_the_plan_and_its_upload():
    """A frame equal to its predecessor reuses the plan object, and its
    upload copies nothing; a leaf whose id() now names another array is
    uploaded anew."""
    cfg = UNetConfig(**SCFG)
    (c, f, m), = _sweep_scenes(5, n=1)[0]
    state = engine.StreamPlanState(cfg, device="cpu")
    _, p0, _, _ = state.plan_frame(SparseVoxelTensor(c, f, m), 0)
    _, p1, _, info = state.plan_frame(SparseVoxelTensor(c, f, m), 1)
    assert info["mode"] == "reused" and p1 is p0
    d0 = state.device_plan(p0)
    full = dict(state.last_upload)
    assert full["bytes"] == full["of_bytes"] > 0
    d1 = state.device_plan(p1)
    assert state.last_upload["bytes"] == 0
    assert state.last_upload["of_bytes"] == full["of_bytes"]
    assert d1.levels[0].coords is d0.levels[0].coords
    assert d1.device == torch.device("cpu")
    # a recycled id(): the memo entry holds another object under the key
    x = p1.levels[0].coords
    state._memo[id(x)] = (np.array(x), torch.zeros(1))
    d2 = state.device_plan(p1)
    assert d2.levels[0].coords is not d1.levels[0].coords
    np.testing.assert_array_equal(d2.levels[0].coords.numpy(), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.StreamPlanState(cfg).device_plan(p0)


def test_skip_frame_unblocks_successors():
    cfg = UNetConfig(**SCFG)
    (c, f, m), = _sweep_scenes(5, n=1)[0]
    t = SparseVoxelTensor(c, f, m)
    state = engine.StreamPlanState(cfg, wait_s=30.0, device="cpu")
    state.plan_frame(t, 0)
    state.skip_frame(1)  # what the engine does when admission sheds it
    t0 = time.perf_counter()
    _, _, _, info = state.plan_frame(t, 2)
    assert time.perf_counter() - t0 < 5.0  # no wait_s stall
    # the delta base died with the skipped frame: identical coords must
    # not short-circuit to "reused"
    assert info["mode"] == "rebuilt"


def test_out_of_order_frame_waits_then_rebuilds():
    """A frame whose predecessor never arrives waits ``wait_s`` and then
    rebuilds; two streams plan concurrently with their own bases."""
    cfg = UNetConfig(**SCFG)
    frames, shifts = _sweep_scenes(5, n=2)
    state = engine.StreamPlanState(cfg, wait_s=0.2, device="cpu")
    t0 = time.perf_counter()
    _, _, _, info = state.plan_frame(SparseVoxelTensor(*frames[1]), 1)
    assert time.perf_counter() - t0 >= 0.2 and info["mode"] == "rebuilt"

    out = {}
    sa = engine.StreamPlanState(cfg, stream_id="x", device="cpu")
    sb = engine.StreamPlanState(cfg, stream_id="y", device="cpu")

    def drive(state, seed):
        fr, sh = _sweep_scenes(seed, n=3)
        for fno in (2, 1, 0):  # submitted backwards: the gate orders them
            th = threading.Thread(target=lambda n=fno: out.__setitem__(
                (state.stream_id, n), state.plan_frame(
                    SparseVoxelTensor(*fr[n]), n, sh[n])))
            th.start()
            threads.append(th)

    threads = []
    drive(sa, 21)
    drive(sb, 22)
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for sid in ("x", "y"):
        assert [out[(sid, n)][3]["mode"] for n in range(3)] == \
            ["rebuilt", "patched", "patched"]


# -- fault injector ---------------------------------------------------------


def _fault_trace(mod, plan, n=60):
    """What an injector fires over a fixed sequence of opportunities."""
    inj = mod.FaultInjector(plan)
    out = []
    coords = np.arange(96, dtype=np.int32).reshape(32, 3)
    for i in range(n):
        for seam in ("plan", "plan_build", "dispatch", "worker_death",
                     "backend_resolve"):
            try:
                inj.maybe_fail(seam, rid=i % 7, key=("k", i % 11))
                out.append((seam, i, None))
            except BaseException as e:  # noqa: BLE001 - WorkerDeath too
                out.append((seam, i, type(e).__name__,
                            getattr(e, "backend", None)))
        out.append(("stall", i, inj.stall_ms(key=("wave", i))))
        c = inj.corrupt_coords(coords, rid=i)
        out.append(("corrupt", i, None if c is coords else c.tolist()))
    return out, inj.stats()


PLANS = [dict(seed=s) for s in range(4)] + [dict(explicit=True)]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: str(kw))
def test_fault_injector_fires_on_the_same_keys_as_jax(kw):
    def plan(mod):
        if "seed" in kw:
            return mod.FaultPlan.random(kw["seed"], max_specs=4, max_rate=0.5)
        return mod.FaultPlan(seed=5, specs=(
            mod.FaultSpec("dispatch", rate=0.4, backend="sspnna"),
            mod.FaultSpec("corrupt_frame", rate=0.3, max_fires=3),
            mod.FaultSpec("slow_wave", rate=0.5, delay_ms=2.0, after=5),
            mod.FaultSpec("plan", rate=1.0, rids=(3,)),
            mod.FaultSpec("backend_resolve", rate=0.2)))

    ours, o_stats = _fault_trace(faults, plan(faults))
    theirs, t_stats = _fault_trace(jfaults, plan(jfaults))
    assert ours == theirs
    assert o_stats == t_stats
    assert sum(o_stats["fires"].values()) > 0
    assert faults.SEAMS == jfaults.SEAMS
    with pytest.raises(ValueError, match="unknown seam"):
        faults.FaultSpec("nowhere")
    with pytest.raises(ValueError, match="rate"):
        faults.FaultSpec("plan", rate=1.5)


def test_ambient_injector_reaches_plan_builds_and_resolve():
    cfg = UNetConfig(**SCFG)
    (c, f, m), = _sweep_scenes(5, n=1)[0]
    inj = faults.FaultInjector(faults.FaultPlan(specs=(
        faults.FaultSpec("plan_build", rate=1.0, max_fires=1),
        faults.FaultSpec("backend_resolve", rate=1.0, backend="sspnna"))))
    assert faults.active() is None
    cache = engine.PlanCache()
    plan = engine.build_scene_plan_host(SparseVoxelTensor(c, f, m), cfg,
                                        plan_tiles=False)
    with faults.inject_faults(inj) as active:
        assert faults.active() is active is inj
        with pytest.raises(faults.PlanFaultError):
            cache.get_or_build(SparseVoxelTensor(c, f, m), cfg,
                               device=False, plan_tiles=False)
        with pytest.raises(faults.DeviceFaultError) as err:
            DEFAULT_REGISTRY.resolve(plan.levels[0].sub)
        assert err.value.backend == "sspnna"
        # the failed build released its key: the retry builds
        cache.get_or_build(SparseVoxelTensor(c, f, m), cfg, device=False,
                           plan_tiles=False)
    assert faults.active() is None
    assert DEFAULT_REGISTRY.resolve(plan.levels[0].sub) == engine.REFERENCE
    assert inj.stats()["fires"] == {"plan_build": 1, "backend_resolve": 1}


# -- serving ----------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**SCFG)))
    return tree, params_from_jax(tree, UNetConfig(**SCFG), device="cpu")


def _ctx():
    return engine.ExecutionContext(device="cpu")


def _serve_stream(eng, frames, shifts):
    reqs = eng.serve_stream([SparseVoxelTensor(*a) for a in frames], shifts)
    eng.close()
    return reqs


@pytest.mark.parametrize("pinned", [False, True], ids=["adaptive", "pinned"])
def test_serve_stream_matches_jax_and_one_shot(unet, specs, pinned):
    """Stream logits: within 1e-4 of the JAX serve_stream with the same
    modes; bit for bit the port's one-shot serve of the re-packed frames;
    and bit for bit the pipelined serve."""
    tree, model = unet
    spec, jspec = specs if pinned else (None, None)
    frames, shifts = _sweep_scenes(7)
    jeng = JSceneEngine(JUNetConfig(**SCFG), tree, 2, spec=jspec, sync=True)
    want = jeng.serve_stream([JSparseVoxelTensor(*a) for a in frames],
                             shifts)
    jeng.close()
    eng = SceneEngine(UNetConfig(**SCFG), model, 2, spec=spec, ctx=_ctx(),
                      sync=True)
    got = _serve_stream(eng, frames, shifts)
    assert [r.plan_info["mode"] for r in got] == \
        [r.plan_info["mode"] for r in want] == \
        ["rebuilt", "patched", "patched", "patched"]
    for r, w in zip(got, want):
        assert r.done and r.logits.shape == (SCAP, N_CLASSES)
        assert _rel(r.logits, np.asarray(w.logits)) <= TOL
        np.testing.assert_array_equal(r.pred, r.logits.argmax(-1))
        np.testing.assert_array_equal(r._frame_rows, w._frame_rows)
    assert eng.n_compilations == 1
    noted = [w.notes for w in eng.wave_stats]
    assert sum(n["stream_patched"] for n in noted) == 3
    for n in noted:
        assert {"stream_reused", "stream_patched", "stream_rebuilt",
                "stream_overlap", "stream_plan_ms"} <= set(n)
    handle = next(iter(eng._streams.values()))
    assert handle.stats()["frames"] == 4 and handle.stats()["patched"] == 3

    # the port's one-shot serve of the re-packed frames, same waves
    packed = []
    for (c, f, m), r in zip(frames, got):
        pc, pm = _pack_frame(c, m, r._frame_rows, SCAP)
        packed.append(SparseVoxelTensor(
            pc, pack_stream_frame_np(r._frame_rows, f), pm))
    ref = SceneEngine(UNetConfig(**SCFG), model, 2, spec=spec, ctx=_ctx())
    handles = ref.submit([SceneRequest(i, t) for i, t in enumerate(packed)])
    ref.serve()
    ref.close()
    for h, r in zip(handles, got):
        one = h.result().logits
        fr = r._frame_rows
        exp = np.zeros_like(one)
        exp[fr >= 0] = one[fr[fr >= 0]]
        np.testing.assert_array_equal(r.logits, exp,
                                      err_msg=f"frame {r.frame_no}")

    eng2 = SceneEngine(UNetConfig(**SCFG), model, 2, spec=spec, ctx=_ctx(),
                       sync=False, depth=2, planner_threads=2)
    by_async = _serve_stream(eng2, frames, shifts)
    for a, b in zip(got, by_async):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.plan_info["mode"] == b.plan_info["mode"]


def test_two_interleaved_streams_one_frame_each_per_wave(unet, specs):
    """Two streams submitted frame by frame in turn: each wave holds one
    frame of each stream, both keep their own bases, and the pipelined
    serve equals the blocking one bit for bit."""
    _, model = unet
    spec, _ = specs
    sweeps = [_sweep_scenes(s, n=3) for s in (0, 1)]

    def serve(sync):
        eng = SceneEngine(UNetConfig(**SCFG), model, 2, spec=spec,
                          ctx=_ctx(), sync=sync, planner_threads=2)
        streams = [eng.open_stream(f"s{i}") for i in range(2)]
        handles = [[], []]
        for fno in range(3):
            for i, (frames, shifts) in enumerate(sweeps):
                handles[i].append(streams[i].submit(
                    SparseVoxelTensor(*frames[fno]), shifts[fno]))
        eng.serve()
        eng.close()
        assert [len(w.rids) for w in eng.wave_stats] == [2, 2, 2]
        return eng, [[h.result() for h in hs] for hs in handles]

    eng, by_sync = serve(True)
    assert [(w.notes["stream_rebuilt"], w.notes["stream_patched"])
            for w in eng.wave_stats] == [(2, 0), (0, 2), (0, 2)]
    for rs in by_sync:
        assert [r.plan_info["mode"] for r in rs] == \
            ["rebuilt", "patched", "patched"]
    _, by_async = serve(False)
    for a_s, b_s in zip(by_sync, by_async):
        for a, b in zip(a_s, b_s):
            np.testing.assert_array_equal(a.logits, b.logits)


def _tight_spec(cfg_cls, eng, tensor_cls):
    """A spec pinned from the first frames of sweeps 0-1 at 0.3x their
    tile counts, so sweep 7's frames overflow levels 0-1."""
    firsts = [_sweep_scenes(s, n=1)[0][0] for s in (0, 1)]
    return eng.build_plan_spec([tensor_cls(*a) for a in firsts],
                               cfg_cls(**SCFG), tile_margin=0.3)


def _small_scene(n_active=400):
    """A one-shot scene of the serving config within the tight budget."""
    c, f, _, m = make_scene(5, SRES, SCAP)
    m = m.copy()
    m[np.flatnonzero(m)[n_active:]] = False
    return c, np.where(m[:, None], f, 0).astype(np.float32), m


def test_stream_frame_over_the_tile_budget_raises(unet):
    """A stream frame over the pinned tile budget beside a one-shot scene
    within it: the two plans' signatures disagree, so the wave raises as
    the JAX engine's does, and both requests go back to the queue."""
    tree, model = unet
    frames, shifts = _sweep_scenes(7, n=1)
    for eng, tensor, req in (
            (JSceneEngine(JUNetConfig(**SCFG), tree, 2, spec=_tight_spec(
                JUNetConfig, jengine, JSparseVoxelTensor)),
             JSparseVoxelTensor, JSceneRequest),
            (SceneEngine(UNetConfig(**SCFG), model, 2, ctx=_ctx(),
                         spec=_tight_spec(UNetConfig, engine,
                                          SparseVoxelTensor)),
             SparseVoxelTensor, SceneRequest)):
        eng.open_stream().submit(tensor(*frames[0]), shifts[0])
        eng.submit(req(50, tensor(*_small_scene())))
        with pytest.raises(RuntimeError, match="diverged from the wave"):
            eng.serve()
        assert sorted(r.rid for r in eng.queue) == [0, 50]
        assert eng.n_compilations == 0
        eng.close()


def test_stream_frames_over_the_tile_budget_serve_as_jax(unet):
    """Frames that all overflow the pinned budget at the same levels share
    one signature of their own: the JAX engine serves them on one compile,
    and the port on one graph, with the same modes and logits within
    1e-4."""
    tree, model = unet
    frames, shifts = _sweep_scenes(7, n=2)
    jeng = JSceneEngine(JUNetConfig(**SCFG), tree, 2, spec=_tight_spec(
        JUNetConfig, jengine, JSparseVoxelTensor))
    want = jeng.serve_stream([JSparseVoxelTensor(*a) for a in frames],
                             shifts)
    jeng.close()
    eng = SceneEngine(UNetConfig(**SCFG), model, 2, ctx=_ctx(),
                      spec=_tight_spec(UNetConfig, engine, SparseVoxelTensor))
    got = eng.serve_stream([SparseVoxelTensor(*a) for a in frames], shifts)
    eng.close()
    assert eng.n_compilations == jeng.n_compilations == 1
    for g, w in zip(got, want):
        assert g.plan_info["mode"] == w.plan_info["mode"]
        assert _rel(g.logits, np.asarray(w.logits)) <= TOL


def test_stream_fifo_admission_under_policy():
    """An urgency policy must not reorder frames within a stream."""
    order = []
    sched = WaveScheduler(
        batch=2, plan=lambda r: None,
        dispatch=lambda reqs, p, st: order.extend(r.rid for r in reqs),
        drain=lambda reqs, h, st: None,
        policy=AdmissionPolicy())
    reqs = []
    for fno, prio in [(0, 0), (1, 5), (2, 10)]:  # later frames more urgent
        r = ServeRequest(fno, priority=prio)
        r._stream_key = "s"
        r._stream_frame = fno
        reqs.append(r)
    loner = ServeRequest(99, priority=7)
    sched.submit(reqs + [loner])
    sched.run()
    assert [rid for rid in order if rid != 99] == [0, 1, 2]
    assert sorted(order) == [0, 1, 2, 99]


def test_shed_frame_makes_the_next_one_rebuild(unet):
    """A frame shed at admission (expired deadline) skips its stream's
    frame gate: the next frame does not wait ``wait_s`` and rebuilds."""
    _, model = unet
    frames, shifts = _sweep_scenes(9, n=3)
    eng = SceneEngine(UNetConfig(**SCFG), model, 2, ctx=_ctx(),
                      policy=AdmissionPolicy())
    stream = eng.open_stream(wait_s=30.0)
    first = stream.submit(SparseVoxelTensor(*frames[0]), shifts[0])
    eng.serve()
    assert first.result().plan_info["mode"] == "rebuilt"
    shed = stream.submit(SparseVoxelTensor(*frames[1]), shifts[1],
                         deadline_ms=1e-9)
    time.sleep(0.01)
    nxt = stream.submit(SparseVoxelTensor(*frames[2]), shifts[2])
    t0 = time.perf_counter()
    eng.serve()
    assert time.perf_counter() - t0 < 20.0
    assert shed.status == "shed"
    assert nxt.result().plan_info["mode"] == "rebuilt"
    eng.close()


def test_corrupt_stream_frame_is_contained(unet):
    """A corrupted LiDAR frame (seeded garbage coords) must not wedge the
    stream: the frame is retried clean (or failed terminally) and later
    frames still serve."""
    frames, shifts = make_lidar_sweep(9, 4, resolution=RES, capacity=CAP,
                                      step=4, churn=0.1)
    small = UNetConfig(widths=(8, 16), reps=1, resolution=RES, capacity=CAP,
                       n_classes=N_CLASSES)
    model = SCNUNet(small, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    inj = faults.FaultInjector(faults.FaultPlan(specs=(
        faults.FaultSpec("corrupt_frame", rate=1.0, rids=(1,),
                         max_fires=1),)))
    eng = SceneEngine(small, model, batch=2, sync=True, faults=inj,
                      ctx=_ctx(), policy=AdmissionPolicy(
                          max_retries=2, retry_backoff_ms=1.0))
    reqs = eng.serve_stream([SparseVoxelTensor(c, f, m)
                             for c, f, _, m in frames], shifts)
    assert inj.stats()["fires"]["corrupt_frame"] == 1
    by_status = {r.rid: r.status for r in reqs}
    assert all(s in ("completed", "failed") for s in by_status.values())
    assert by_status[0] == by_status[2] == by_status[3] == "completed"
    for r in reqs:
        if r.status == "completed":
            assert not np.any(np.isnan(r.logits))
    eng.close()


def test_open_stream_refuses_family_engines_and_duplicate_ids(unet):
    _, model = unet
    cfg = UNetConfig(**SCFG)
    fam = SceneEngine(cfg, model, 2, ctx=_ctx(),
                      family=engine.SignatureFamily((1024, SCAP)))
    with pytest.raises(ValueError, match="family="):
        fam.open_stream()
    eng = SceneEngine(cfg, model, 2, ctx=_ctx())
    handle = eng.open_stream("lidar0")
    assert isinstance(handle, StreamHandle) and handle.stream_id == "lidar0"
    with pytest.raises(ValueError, match="already open"):
        eng.open_stream("lidar0")
    frames, _ = _sweep_scenes(3, n=1)
    with pytest.raises(ValueError, match="ego_shifts"):
        eng.serve_stream([SparseVoxelTensor(*frames[0])], [(0, 0, 0)] * 2)


def test_stream_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "stream_scene_torch.py"),
         "--device", "cpu", "--frames", "3", "--resolution", "16",
         "--capacity", "512", "--spec"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "patched=2 rebuilt=1" in out.stdout
