"""Port parity for what SCN serving plans with: pinned specs, budgeted tile
tables, capacity buckets and meta-attributes against the JAX package, and
the port's ``PlanCache`` and ``ExecutionContext`` on their own.

Specs, dispatches and tile tables are compared exactly (the port's
``Dispatch`` has no ``block_n``; the JAX package's is 0 here). Cache keys
are compared within the port only: ``repr(Dispatch)`` and
``repr(UNetConfig.dtype)`` differ between the packages by design.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro import engine as jengine
from repro.core import spade as jspade
from repro.data.scenes import scene_batch_iterator as jscene_batch_iterator
from repro.models.scn import UNetConfig as JUNetConfig
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.core import spade
from repro_torch.core.host_meta import build_cirf_np
from repro_torch.core.hashgrid import kernel_offsets
from repro_torch.data.scenes import N_CLASSES, make_scene, scene_batch_iterator
from repro_torch.engine import context
from repro_torch.models.scn import UNetConfig
from repro_torch.sparse.tensor import SparseVoxelTensor

RES, CAP = 32, 4096
CFG = dict(widths=(16, 32, 48), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)


def _scenes(seeds, n_active=None):
    """Both packages' tensors of the seeds' scenes (numpy leaves), each cut
    to ``n_active`` active voxels where given."""
    out = []
    for i, seed in enumerate(seeds):
        coords, feats, _, mask = make_scene(seed, RES, CAP)
        if n_active is not None:
            mask = mask.copy()
            mask[np.flatnonzero(mask)[n_active[i]:]] = False
        out.append((SparseVoxelTensor(coords, feats, mask),
                    JSparseVoxelTensor(coords, feats, mask)))
    return out


def _dispatch_fields(d) -> dict:
    fields = dataclasses.asdict(d)
    fields.pop("block_n", None)
    return fields


@pytest.fixture(scope="module")
def reps():
    return _scenes([100, 101])


@pytest.mark.parametrize("kw", [dict(), dict(mem_budget=16 * 1024),
                                dict(order="raster", tile_margin=1.5)],
                         ids=["default", "small_budget", "raster"])
def test_plan_spec_matches_jax(reps, kw):
    ours = engine.build_plan_spec([s for s, _ in reps], UNetConfig(**CFG),
                                  **kw)
    theirs = jengine.build_plan_spec([s for _, s in reps],
                                     JUNetConfig(**CFG), **kw)
    assert any(d.backend == engine.SSPNNA for d in ours.levels)
    assert [d.block_n for d in theirs.levels] == [0] * len(theirs.levels)
    assert [_dispatch_fields(d) for d in ours.levels] == \
        [_dispatch_fields(d) for d in theirs.levels]


@pytest.mark.parametrize("margin", [2.0, 0.5], ids=["budget", "overflow"])
def test_pinned_plan_tables_match_jax(reps, margin):
    """Budgeted tile tables (padded to the spec's n_tiles) equal the JAX
    package's exactly; with a budget below what a scene needs, both send
    that level to reference and say so in the stats."""
    kw = dict(tile_margin=margin)
    spec = engine.build_plan_spec([s for s, _ in reps], UNetConfig(**CFG),
                                  **kw)
    jspec = jengine.build_plan_spec([s for _, s in reps],
                                    JUNetConfig(**CFG), **kw)
    ours_t, theirs_t = _scenes([7])[0]
    ours = engine.build_scene_plan_host(ours_t, UNetConfig(**CFG), spec=spec)
    theirs = jengine.build_scene_plan_host(theirs_t, JUNetConfig(**CFG),
                                           spec=jspec)
    for li, (a, b) in enumerate(zip(ours.levels, theirs.levels, strict=True)):
        assert _dispatch_fields(a.sub.dispatch) == \
            _dispatch_fields(b.sub.dispatch)
        assert ours.stats[li].get("tile_overflow") == \
            theirs.stats[li].get("tile_overflow")
        assert (a.sub.tiles is None) == (b.sub.tiles is None)
        if a.sub.tiles is not None:
            assert a.sub.tiles.out_rows.shape[0] == spec.levels[li].n_tiles
            for x, y in zip(a.sub.tiles, b.sub.tiles, strict=True):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    overflowed = [s.get("tile_overflow", False) for s in ours.stats]
    assert any(overflowed) == (margin < 1)


@pytest.mark.parametrize("sizes,max_buckets,quantum", [
    ([100, 120, 500, 510, 900], 4, 64), ([300], 4, 64),
    ([10, 2000, 2100, 4000, 50, 60, 70], 3, 128), ([64, 65], 1, 64)])
def test_choose_buckets_matches_jax(sizes, max_buckets, quantum):
    assert engine.choose_buckets(sizes, max_buckets, quantum=quantum) == \
        jengine.choose_buckets(sizes, max_buckets, quantum=quantum)


def test_signature_family_matches_jax():
    scenes = _scenes([10, 11, 12, 13], n_active=[300, 320, 1500, 1600])
    kw = dict(max_buckets=2, quantum=64)
    ours = engine.build_signature_family([s for s, _ in scenes],
                                         UNetConfig(**CFG), **kw)
    theirs = jengine.build_signature_family([s for _, s in scenes],
                                            JUNetConfig(**CFG), **kw)
    assert ours.capacities == theirs.capacities
    assert ours.n_buckets == 2
    for a, b in zip(ours.specs, theirs.specs, strict=True):
        assert [_dispatch_fields(d) for d in a.levels] == \
            [_dispatch_fields(d) for d in b.levels]
    assert ours.bucket_for(ours.max_capacity + 1) is None
    assert ours.bucket_for(1) == ours.capacities[0]


def test_meta_attributes_match_jax():
    per_cloud = []
    for seed in (3, 4, 5):
        coords, _, _, mask = make_scene(seed, RES, CAP)
        coir = build_cirf_np(coords, mask, coords, mask, kernel_offsets(3),
                             RES)
        per_cloud.append(spade.extract_attributes(
            np.asarray(coir.indices), mask, np.flatnonzero(mask)))
    ours = spade.meta_attributes(per_cloud)
    theirs = jspade.meta_attributes([
        jspade.SparsityAttributes(**dataclasses.asdict(a))
        for a in per_cloud])
    for f in dataclasses.fields(ours):
        np.testing.assert_allclose(getattr(ours, f.name),
                                   getattr(theirs, f.name), rtol=0,
                                   atol=1e-12)


def test_later_slices_raise_by_name(reps):
    """What still raises: ``tune_block_n=`` (the CUDA kernels have no
    N-block), and a ``mesh=`` that names no axis (sharded scenes, which
    came with slice 9, read the shard axis by name). ``autotune=`` came
    with slice 7 and no longer raises."""
    scenes = [s for s, _ in reps]
    with pytest.raises(NotImplementedError, match="no N-block"):
        engine.build_plan_spec(scenes, UNetConfig(**CFG),
                               tune_block_n=lambda *a: 16)
    with pytest.raises(ValueError, match="names no dims"):
        engine.ExecutionContext(mesh=object())
    table = engine.CostTable(fingerprint="f")
    assert engine.ExecutionContext(autotune=table,
                                   device="cpu").autotune is table


def test_scene_batch_iterator_matches_jax():
    ours, theirs = (scene_batch_iterator(5, 2, 16, 512),
                    jscene_batch_iterator(5, 2, 16, 512))
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert a["state"] == b["state"]
        for k in ("coords", "feats", "labels", "mask"):
            assert a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# PlanCache (the JAX package's tests/test_engine.py and
# tests/test_serving_async.py cases, on the port)
# ---------------------------------------------------------------------------

CACHE_CFG = UNetConfig(**CFG)


def _one(seed) -> SparseVoxelTensor:
    return _scenes([seed])[0][0]


def test_plan_cache_hits_by_scene_content():
    cache = engine.PlanCache(capacity=4)
    p1 = cache.get_or_build(_one(0), CACHE_CFG, device="cpu",
                            plan_tiles=False)
    p2 = cache.get_or_build(_one(0), CACHE_CFG, device="cpu",
                            plan_tiles=False)  # same content, new arrays
    assert p1 is p2 and cache.hits == 1 and cache.misses == 1
    cache.get_or_build(_one(1), CACHE_CFG, device="cpu", plan_tiles=False)
    assert cache.misses == 2


def test_plan_cache_keys_by_config_build_mode_and_topology(reps):
    cache = engine.PlanCache()
    t = _one(0)
    spec = engine.build_plan_spec([s for s, _ in reps], CACHE_CFG)
    keys = {cache.key_for(t, CACHE_CFG, plan_tiles=False),
            cache.key_for(t, CACHE_CFG, spec=spec, plan_tiles=True),
            cache.key_for(t, dataclasses.replace(CACHE_CFG, capacity=2048),
                          plan_tiles=False),
            cache.key_for(t, CACHE_CFG, topology="host", plan_tiles=False)}
    assert len(keys) == 4
    assert cache.key_for(t, CACHE_CFG, plan_tiles=False) == \
        cache.key_for(_one(0), CACHE_CFG, plan_tiles=False)
    # features do not change the plan, so they do not change the key
    other = SparseVoxelTensor(t.coords, t.feats + 1.0, t.mask)
    assert engine.scene_key(other) == engine.scene_key(t)


def test_plan_cache_concurrent_same_scene_builds_once():
    cache = engine.PlanCache(capacity=8)
    t = _one(600)
    n = 8
    results: list = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = cache.get_or_build(t, CACHE_CFG, device=False,
                                        plan_tiles=False)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert cache.misses == 1 and cache.hits == n - 1
    assert len(cache) == 1
    assert all(r is results[0] for r in results)


def test_plan_cache_concurrent_distinct_scenes_and_host_device_split():
    cache = engine.PlanCache(capacity=8)
    scenes = [_one(700 + i) for i in range(4)]
    out: dict = {}
    barrier = threading.Barrier(len(scenes))

    def worker(i):
        barrier.wait()
        out[i] = cache.get_or_build(scenes[i], CACHE_CFG, device=False,
                                    plan_tiles=False)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(scenes))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert cache.misses == len(scenes) and len(cache) == len(scenes)
    host = cache.get_or_build(scenes[0], CACHE_CFG, device=False,
                              plan_tiles=False)
    assert isinstance(host.levels[0].sub.coir.indices, np.ndarray)
    assert host.device is None
    dev = cache.get_or_build(scenes[0], CACHE_CFG, device="cpu",
                             plan_tiles=False)
    assert dev.device.type == "cpu"
    assert dev is cache.get_or_build(scenes[0], CACHE_CFG, device="cpu",
                                     plan_tiles=False)
    np.testing.assert_array_equal(dev.levels[0].sub.coir.indices.numpy(),
                                  host.levels[0].sub.coir.indices)


def test_plan_cache_failed_build_releases_key(reps):
    cache = engine.PlanCache(capacity=4)
    bad = _one(800)
    bad_cfg = dataclasses.replace(CACHE_CFG, widths=(16, 32))
    spec = engine.build_plan_spec([s for s, _ in reps], CACHE_CFG)
    with pytest.raises(ValueError, match="levels"):  # spec levels != cfg's
        cache.get_or_build(bad, bad_cfg, device=False, spec=spec)
    # the key is released: a second attempt raises again (no deadlock), and
    # the cache still serves good builds
    with pytest.raises(ValueError, match="levels"):
        cache.get_or_build(bad, bad_cfg, device=False, spec=spec)
    assert cache.get_or_build(bad, CACHE_CFG, device=False,
                              plan_tiles=False) is not None
    assert cache.misses == 1 and len(cache) == 1


def test_plan_cache_waiters_get_the_builders_error():
    cache = engine.PlanCache()
    started, release = threading.Event(), threading.Event()
    errors = []

    def builder(t, cfg, **kw):
        started.set()
        release.wait(timeout=60)
        raise RuntimeError("build failed")

    def call():
        try:
            cache.get_or_build(_one(0), CACHE_CFG, device=False,
                               builder=builder)
        except RuntimeError as e:
            errors.append(str(e))

    first = threading.Thread(target=call)
    first.start()
    assert started.wait(timeout=60)
    second = threading.Thread(target=call)
    second.start()
    release.set()
    for th in (first, second):
        th.join(timeout=60)
        assert not th.is_alive()
    assert errors == ["build failed", "build failed"]
    assert len(cache) == 0 and cache.misses == 0


def test_plan_cache_lru_adopt_and_invalidate():
    cache = engine.PlanCache(capacity=8, max_entries=2)
    scenes = [_one(900 + i) for i in range(3)]
    keys, hosts = [], []
    for t in scenes:
        keys.append(cache.key_for(t, CACHE_CFG, plan_tiles=False))
        hosts.append(cache.get_or_build(t, CACHE_CFG, device=False,
                                        key=keys[-1], plan_tiles=False))
    assert len(cache) == 2 and cache.misses == 3  # scene 0 evicted
    # adopt re-inserts an evicted entry without building or counting
    dev = cache.adopt(keys[0], hosts[0], device="cpu")
    assert cache.misses == 3 and cache.hits == 0 and len(cache) == 2
    np.testing.assert_array_equal(dev.levels[0].mask.numpy(),
                                  hosts[0].levels[0].mask)
    assert cache.adopt(keys[0], hosts[0], device="cpu") is dev
    assert cache.invalidate() == 2 and len(cache) == 0
    assert cache.invalidations == 1
    with pytest.raises(ValueError, match="max_entries"):
        engine.PlanCache(max_entries=0)


def test_execution_context_defaults_and_scoping():
    ctx = engine.ExecutionContext(device="cpu")
    assert ctx.topology_key() == "host"
    assert ctx.mesh is None and ctx.sync and ctx.depth == 2
    assert set(ctx.registry.names()) == {engine.REFERENCE, engine.SHARDED,
                                         engine.SSPNNA}
    assert ctx.registry is not engine.ExecutionContext().registry
    assert isinstance(ctx.plan_cache, engine.PlanCache)
    assert engine.ExecutionContext().device == "cuda"
    default = engine.default_context()
    assert engine.current_context() is default
    with engine.use_context(ctx) as inner:
        assert inner is ctx and engine.current_context() is ctx
    assert engine.current_context() is default
    other = engine.ExecutionContext(device="cpu")
    prev = engine.set_default_context(other)
    try:
        assert engine.current_context() is other
    finally:
        context.set_default_context(prev)
    assert engine.default_context() is default
