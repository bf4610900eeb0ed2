"""Port parity for sharded scenes (``engine.shard``): the halo tables, the
halo exchange, the sharded U-Net forward as a loop over shards and as a
2-process gloo run, and sharded serving, against the JAX package on the
CPU (the cases of ``tests/test_sharded.py``, one for one where they
apply).

Sizes are the JAX tests': ``RES, CAP = 24, 2048``, widths (8, 16). The
tables and the exchange are held equal (integer tables, rows moved);
logits within rtol = atol = 1e-4 of the JAX package's ``vmap`` path and
of the port's unsharded ``reference`` backend (the JAX test's bound);
the loop against the gloo run bit for bit, at one
``torch.set_num_threads`` on both sides.
"""
import dataclasses
import multiprocessing as mp
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_worker
from repro import engine as jengine
from repro.core.host_meta import shard_halo_tables_np as jshard_halo_tables_np
from repro.dist.collectives import halo_exchange as jhalo_exchange
from repro.dist.compat import make_mesh
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.serving.scene_engine import SceneEngine as JSceneEngine
from repro.serving.scene_engine import SceneRequest as JSceneRequest
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.core.host_meta import shard_halo_tables_np
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.dist import halo_exchange_local
from repro_torch.models.scn import SCNUNet, UNetConfig, params_from_jax
from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
from repro_torch.sparse.tensor import SparseVoxelTensor

RES, CAP = 24, 2048
UNET = dict(widths=(8, 16), reps=1, resolution=RES, capacity=CAP,
            n_classes=N_CLASSES)
TOL = dict(rtol=1e-4, atol=1e-4)
# the CPU thread count of both sides of the bitwise loop-vs-gloo test
THREADS = 1
# a bound on the gloo workers' join: a hung collective fails the test
JOIN_S = 120


class FakeMesh:
    """What the port reads of a ``DeviceMesh`` (its dim names and shape),
    for the guards that need no process group."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def _arrays(seed, res=RES, cap=CAP):
    coords, feats, _, mask = make_scene(seed, resolution=res, capacity=cap)
    return coords, feats, mask


def _scene(seed, res=RES, cap=CAP) -> SparseVoxelTensor:
    return SparseVoxelTensor(*_arrays(seed, res, cap))


def _jscene(seed) -> JSparseVoxelTensor:
    return JSparseVoxelTensor(*map(jnp.asarray, _arrays(seed)))


def _random_arrays(seed, cap, res, n_active, channels=4):
    """Uniform random active voxels (the JAX test's): receptive fields cross
    shard boundaries freely."""
    rng = np.random.default_rng(seed)
    coords = np.full((cap, 3), -1, np.int32)
    feats = np.zeros((cap, channels), np.float32)
    mask = np.zeros((cap,), bool)
    if n_active:
        pts = np.unique(rng.integers(0, res, size=(n_active, 3))
                        .astype(np.int32), axis=0)
        coords[:len(pts)] = pts
        feats[:len(pts)] = rng.normal(size=(len(pts), channels))
        mask[:len(pts)] = True
    return coords, feats, mask


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = UNetConfig(**UNET), JUNetConfig(**UNET)
    jparams = init_unet(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    t = _scene(0)
    with torch.no_grad():
        ref = engine.apply_unet(
            model, t.feats,
            engine.build_scene_plan(t, cfg, plan_tiles=False, device="cpu"),
            backend="reference", device="cpu").numpy()
    return cfg, jcfg, jparams, model, t, ref


def _loop(model, t, cfg, layout):
    plan = engine.build_sharded_scene_plan(t, cfg, layout=layout,
                                           device="cpu")
    with torch.no_grad():
        return plan, engine.apply_unet(model, t.feats, plan,
                                       device="cpu").numpy()


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("halo", [0, 600])
def test_halo_tables_equal_jax(n_shards, halo):
    """Every conv's local blocks, send tables and halo row count equal the
    JAX package's, per scene (``halo=0``) and at a pinned budget."""
    cfg, jcfg = UNetConfig(**UNET), JUNetConfig(**UNET)
    layout = engine.ShardLayout(n_shards=n_shards, halo=halo)
    ours = engine.build_sharded_scene_plan_host(_scene(0), cfg, layout=layout)
    theirs = jengine.build_sharded_scene_plan_host(
        _jscene(0), jcfg, layout=jengine.ShardLayout(n_shards=n_shards,
                                                     halo=halo))
    assert ours.layout.bn_chunk == theirs.layout.bn_chunk
    assert ours.stats == theirs.stats
    assert ours.halo_rows() == theirs.halo_rows() > 0
    for a, b in zip(ours.levels, theirs.levels, strict=True):
        np.testing.assert_array_equal(a.mask, np.asarray(b.mask))
        for ca, cb in ((a.sub, b.sub), (a.down, b.down), (a.up, b.up)):
            assert (ca is None) == (cb is None)
            if ca is not None:
                for x, y in zip(ca, cb, strict=True):
                    assert x.dtype == np.asarray(y).dtype
                    np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_shard_halo_tables_np_equal_jax_on_random_blocks(n_shards):
    rng = np.random.default_rng(n_shards)
    idx = rng.integers(-1, 96, size=(96, 5)).astype(np.int32)
    for got, want in zip(shard_halo_tables_np(idx, n_shards),
                         jshard_halo_tables_np(idx, n_shards), strict=True):
        np.testing.assert_array_equal(got, want)


def test_halo_budget_overflow_raises(setup):
    cfg, *_, t, _ = setup
    with pytest.raises(ValueError, match="halo budget"):
        engine.build_sharded_scene_plan_host(
            t, cfg, layout=engine.ShardLayout(n_shards=4, halo=2))
    with pytest.raises(ValueError, match="not divisible"):
        shard_halo_tables_np(np.zeros((10, 3), np.int32), 4)


def test_halo_exchange_matches_numpy_oracle(rng):
    """The loop form against the JAX test's oracle and the JAX package's
    exchange over a 4-device mesh: the same rows, pads as zero rows."""
    S, Vs, H, C = 4, 32, 6, 3
    feats = rng.normal(size=(S, Vs, C)).astype(np.float32)
    send = rng.integers(-1, Vs, size=(S, S, H)).astype(np.int32)
    got = halo_exchange_local(torch.from_numpy(feats),
                              torch.from_numpy(send)).numpy()
    want = np.zeros((S, S, H, C), np.float32)
    for d in range(S):
        for s in range(S):
            for j in range(H):
                if send[d, s, j] >= 0:
                    want[s, d, j] = feats[d, send[d, s, j]]
    np.testing.assert_array_equal(got, want)
    mesh = make_mesh((S,), ("shard",), devices=jax.devices()[:S])
    np.testing.assert_array_equal(
        got, np.asarray(jhalo_exchange(mesh, jnp.asarray(feats),
                                       jnp.asarray(send))))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_unet_matches_jax_and_reference(setup, n_shards):
    """The loop form within 1e-4 of the JAX package's sharded forward (its
    single-device ``vmap`` path) and of the port's unsharded
    ``reference``; two runs are equal bit for bit."""
    cfg, jcfg, jparams, model, t, ref = setup
    layout = engine.ShardLayout(n_shards=n_shards)
    plan, got = _loop(model, t, cfg, layout)
    assert plan.halo_rows() > 0  # receptive fields really cross shards
    jplan = jengine.build_sharded_scene_plan(
        _jscene(0), jcfg, layout=jengine.ShardLayout(n_shards=n_shards))
    want = np.asarray(jax.jit(lambda p, f, pl: jengine.apply_unet(p, f, pl))(
        jparams, jnp.asarray(t.feats), jplan))
    m = np.asarray(t.mask)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[m], ref[m], **TOL)
    np.testing.assert_array_equal(got, _loop(model, t, cfg, layout)[1])


@pytest.mark.parametrize("seed,n_active", [
    (0, 0), (1, 1), (2, 40), (3, 160), (4, 320), (5, 320)])
def test_sharded_random_scenes(seed, n_active):
    """Random scenes, empty shards and (n_active=0) an empty scene too, at
    2 and 4 shards over a fixed halo budget: the loop form within 1e-4 of
    the JAX package's sharded forward and of the unsharded reference (the
    JAX test's property, at fixed examples)."""
    cap, res = 512, 16
    kw = dict(widths=(4, 8), reps=1, resolution=res, capacity=cap,
              n_classes=N_CLASSES)
    cfg, jcfg = UNetConfig(**kw), JUNetConfig(**kw)
    jparams = init_unet(jax.random.PRNGKey(7), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    arrays = _random_arrays(seed, cap, res, n_active)
    t = SparseVoxelTensor(*arrays)
    with torch.no_grad():
        ref = engine.apply_unet(
            model, t.feats,
            engine.build_scene_plan(t, cfg, plan_tiles=False, device="cpu"),
            backend="reference", device="cpu").numpy()
    m = arrays[2]
    for n_shards in (2, 4):
        layout = engine.ShardLayout(n_shards=n_shards, halo=cap // n_shards)
        _, got = _loop(model, t, cfg, layout)
        jplan = jengine.build_sharded_scene_plan(
            JSparseVoxelTensor(*map(jnp.asarray, arrays)), jcfg,
            layout=jengine.ShardLayout(n_shards=n_shards,
                                       halo=cap // n_shards))
        want = np.asarray(jengine.apply_unet(jparams, jnp.asarray(arrays[1]),
                                             jplan))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got[m], ref[m], **TOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_loop_equals_a_gloo_run_bit_for_bit(setup, rng):
    """Two CPU processes, one shard each, run the process form (one
    ``all_to_all_single`` a conv, one ``all_gather`` of the BatchNorm
    partials) through ``engine.apply_unet`` under a ``DeviceMesh``
    context: their logits equal the loop form's bit for bit, and each
    process's exchange equals the loop form's rows."""
    cfg = UNetConfig(**UNET)
    model = SCNUNet(cfg, device="cpu")   # seed 0, as each worker draws it
    scene_kw = dict(seed=0, resolution=RES, capacity=CAP)
    exchange = {"feats": rng.normal(size=(2, 16, 3)).astype(np.float32),
                "send": rng.integers(-1, 16, size=(2, 2, 5)).astype(np.int32)}
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        _, loop = _loop(model, _scene(0), cfg, engine.ShardLayout(n_shards=2))
    finally:
        torch.set_num_threads(prev)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_sharded_worker.run,
                         args=(r, 2, port, THREADS, UNET, scene_kw, exchange,
                               out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = {}
        for _ in procs:
            rank, recv, logits, key = out.get(timeout=JOIN_S)
            results[rank] = (recv, logits, key)
        for p in procs:
            p.join(timeout=JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert all(p.exitcode == 0 for p in procs), results
    want = halo_exchange_local(torch.from_numpy(exchange["feats"]),
                               torch.from_numpy(exchange["send"])).numpy()
    for rank, (recv, logits, key) in results.items():
        assert key == "mesh(shard=2)|shard_axis=shard"
        np.testing.assert_array_equal(recv, want[rank])
        assert logits.tobytes() == loop.tobytes(), rank


def test_sharded_backend_is_scene_level(setup):
    cfg, *_, model, t, _ = setup
    plan = engine.build_sharded_scene_plan(
        t, cfg, layout=engine.ShardLayout(n_shards=2), device="cpu")
    # a sharded plan cannot be forced onto a per-conv backend
    with pytest.raises(ValueError, match="scene-level backend"):
        engine.apply_unet(model, t.feats, plan, backend="reference",
                          device="cpu")
    impl = engine.default_registry().get(engine.SHARDED)
    assert impl.scene_level and impl.supports(plan)
    with pytest.raises(ValueError, match="whole scenes"):
        impl.run(t.feats, model.stem.params, plan)
    with pytest.raises(NotImplementedError, match="run_unet"):
        engine.default_registry().get("reference").run_unet(
            model, t.feats, plan, ctx=None)
    with pytest.raises(ValueError, match="upload the plan"):
        engine.apply_unet(model, t.feats, engine.build_sharded_scene_plan_host(
            t, cfg, layout=engine.ShardLayout(n_shards=2)), device="cpu")


def test_pin_halo_freezes_signature(setup):
    """The pinned budget equals the JAX package's, and two scenes' plans
    share one signature (every table's shape)."""
    cfg, jcfg, *_ = setup
    layout = engine.pin_halo([_scene(0), _scene(1)], cfg,
                             engine.ShardLayout(n_shards=2))
    jlayout = jengine.pin_halo([_jscene(0), _jscene(1)], jcfg,
                               jengine.ShardLayout(n_shards=2))
    assert layout.halo == jlayout.halo > 0
    p0 = engine.build_sharded_scene_plan_host(_scene(0), cfg, layout=layout)
    p1 = engine.build_sharded_scene_plan_host(_scene(1), cfg, layout=layout)
    assert p0.signature() == p1.signature()
    assert p0.signature() != engine.build_sharded_scene_plan_host(
        _scene(0), cfg, layout=engine.ShardLayout(n_shards=2)).signature()


def test_plan_cache_keys_mix_in_topology(setup):
    """A plan built for one mesh topology or shard layout is never served
    to another; the topology strings are the JAX package's."""
    cfg, *_, t, _ = setup
    cache = engine.PlanCache(capacity=8)
    ctx2 = engine.ExecutionContext(mesh=FakeMesh(shard=2), device="cpu")
    ctx4 = engine.ExecutionContext(mesh=FakeMesh(shard=4), device="cpu")
    host = engine.ExecutionContext(device="cpu")
    assert (host.n_shards, ctx2.n_shards, ctx4.n_shards) == (1, 2, 4)
    k_host = cache.key_for(t, cfg, topology=host.topology_key())
    k2 = cache.key_for(t, cfg, topology=ctx2.topology_key())
    k4 = cache.key_for(t, cfg, topology=ctx4.topology_key())
    assert len({k_host, k2, k4}) == 3
    ka = cache.key_for(t, cfg, topology=ctx4.topology_key(),
                       layout=engine.ShardLayout(4, halo=64))
    kb = cache.key_for(t, cfg, topology=ctx4.topology_key(),
                       layout=engine.ShardLayout(4, halo=128))
    assert ka != kb
    ctx4b = engine.ExecutionContext(mesh=FakeMesh(shard=4),
                                    shard_axis="other", device="cpu")
    assert ctx4.topology_key() != ctx4b.topology_key()
    assert ctx4b.n_shards == 1
    for n in (2, 4):
        jmesh = make_mesh((n,), ("shard",), devices=jax.devices()[:n])
        assert (engine.ExecutionContext(mesh=FakeMesh(shard=n)).topology_key()
                == jengine.ExecutionContext(mesh=jmesh).topology_key())
    assert host.topology_key() == jengine.ExecutionContext().topology_key()


def test_scene_engine_rejects_mismatched_mesh(setup):
    """A mesh lacking the layout's shard axis, or with another size,
    fails at construction; so do ``spec=``, ``family=`` and an unpinned
    halo."""
    cfg, *_, model, _, _ = setup
    layout = engine.ShardLayout(n_shards=4, halo=64)
    for mesh in (FakeMesh(pod=4), FakeMesh(shard=2)):
        ctx = engine.ExecutionContext(mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="mesh axis"):
            SceneEngine(cfg, model, batch=2, ctx=ctx, layout=layout)
    ctx = engine.ExecutionContext(device="cpu")
    with pytest.raises(ValueError, match="spec= and layout="):
        SceneEngine(cfg, model, 2, engine.PlanSpec(()), ctx=ctx,
                    layout=layout)
    with pytest.raises(ValueError, match="family= and layout="):
        SceneEngine(cfg, model, 2, ctx=ctx, layout=layout,
                    family=engine.SignatureFamily((CAP,)))
    with pytest.raises(ValueError, match="pinned halo"):
        SceneEngine(cfg, model, 2, ctx=ctx,
                    layout=engine.ShardLayout(n_shards=4))
    eng = SceneEngine(cfg, model, 2, ctx=engine.ExecutionContext(
        mesh=FakeMesh(shard=4), device="cpu"), layout=layout)
    with pytest.raises(ValueError, match="layout= engines cannot serve"):
        eng.open_stream()
    eng.close()


def test_scene_engine_sharded_guards_signature_and_cache_args(setup):
    """A diverged plan signature (a scene of another capacity) raises and
    requeues instead of serving on a second signature; ``plan_cache_size``
    with an explicit ctx is refused."""
    cfg, *_, model, t, _ = setup
    layout = engine.ShardLayout(n_shards=4, halo=CAP // 4)
    ctx = engine.ExecutionContext(device="cpu")
    eng = SceneEngine(cfg, model, batch=2, ctx=ctx, layout=layout)
    eng.submit([SceneRequest(0, t)])
    eng.serve()
    small = _scene(5, cap=CAP // 2)  # divides 4 shards, another V
    eng.submit([SceneRequest(1, small)])
    with pytest.raises(RuntimeError, match="signature diverged"):
        eng.serve()
    assert eng.n_compilations == 1  # no second signature
    assert [r.rid for r in eng.queue] == [1]  # requeued, not dropped
    eng.close()
    with pytest.raises(ValueError, match="plan_cache_size"):
        SceneEngine(cfg, model, batch=2, ctx=ctx, plan_cache_size=4)


def test_scene_engine_serves_sharded_waves(setup):
    """Waves of a pinned 4-shard layout: per-shard plan builds in the wave
    stats, each scene's logits equal to its own sharded forward off the
    cached plan bit for bit, within 1e-4 of the JAX engine's, and a
    resubmitted scene hits the plan cache."""
    cfg, jcfg, jparams, model, _, _ = setup
    n_shards = 4
    layout = engine.pin_halo([_scene(0), _scene(1)], cfg,
                             engine.ShardLayout(n_shards=n_shards))
    ctx = engine.ExecutionContext(device="cpu")
    eng = SceneEngine(cfg, model, batch=2, ctx=ctx, layout=layout)
    scenes = [_scene(200 + i) for i in range(5)]
    handles = eng.submit([SceneRequest(i, s) for i, s in enumerate(scenes)])
    eng.serve()
    assert all(h.done() for h in handles) and eng.n_compilations == 1
    for st in eng.wave_stats:
        assert st.notes["plan_shards"] == n_shards
        assert st.notes["plan_builds"] == len(st.rids)
        assert st.notes["halo_rows"] > 0
    for h in handles:
        r = h.result()
        plan = eng.cache.get_or_build(
            r.scene, cfg, topology=ctx.topology_key(),
            builder=engine.build_sharded_scene_plan_host, device="cpu",
            layout=layout)
        with torch.no_grad():
            direct = engine.apply_unet(model, r.scene.feats, plan,
                                       device="cpu").numpy()
        assert r.logits.tobytes() == direct.tobytes()
    jlayout = dataclasses.replace(jengine.ShardLayout(n_shards=n_shards),
                                  halo=layout.halo)
    jmesh = make_mesh((n_shards,), ("shard",),
                      devices=jax.devices()[:n_shards])
    jeng = JSceneEngine(jcfg, jparams, batch=2, layout=jlayout,
                        ctx=jengine.ExecutionContext(mesh=jmesh))
    jhandles = jeng.submit([JSceneRequest(i, JSparseVoxelTensor(
        *map(jnp.asarray, _arrays(200 + i)))) for i in range(5)])
    jeng.serve()
    for h, jh in zip(handles, jhandles):
        np.testing.assert_allclose(h.result().logits, jh.result().logits,
                                   **TOL)
    jeng.close()
    eng.submit(SceneRequest(99, scenes[0])).result()
    assert eng.cache.hits >= 1 and eng.n_compilations == 1
    eng.close()
