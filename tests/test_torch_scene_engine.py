"""Port parity for SCN batched serving: the port's ``SceneEngine`` against
the JAX package's, batched with a pinned spec and bucketed, and the wave
forward (B scenes' plans stacked into one pass) against each scene's own
``apply_unet``.

Logits are compared as max |got - want| / max(|want|, 1): f32 sums in
another order, followed by a batch norm after every conv. The wave test
against per-scene forwards uses scenes of different sizes, so a batch norm
over the whole wave or a tile pad landing in the next scene would show.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.models.scn import UNetConfig as JUNetConfig
from repro.models.scn import init_unet
from repro.serving.scene_engine import SceneEngine as JSceneEngine
from repro.serving.scene_engine import SceneRequest as JSceneRequest
from repro.serving.scheduler import AdmissionPolicy as JAdmissionPolicy
from repro.sparse.tensor import SparseVoxelTensor as JSparseVoxelTensor
from repro_torch import engine
from repro_torch.configs import get_config
from repro_torch.data.scenes import N_CLASSES, make_lidar_sweep, make_scene
from repro_torch.kernels.sspnna.sspnna import sspnna_fused
from repro_torch.models import transformer
from repro_torch.models.scn import UNetConfig, params_from_jax
from repro_torch.serving.api import SHED, AdmissionPolicy, RequestShedError
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scene_engine import (
    SceneEngine,
    SceneRequest,
    class_dtype,
)
from repro_torch.sparse.tensor import SparseVoxelTensor

ROOT = Path(__file__).resolve().parents[1]
RES, CAP = 32, 4096
CFG = dict(widths=(16, 32, 48), reps=1, resolution=RES, capacity=CAP,
           n_classes=N_CLASSES)
TOL = 1e-4


def _arrays(seed, n_active=None):
    coords, feats, _, mask = make_scene(seed, RES, CAP)
    if n_active is not None:
        mask = mask.copy()
        mask[np.flatnonzero(mask)[n_active:]] = False
        feats = np.where(mask[:, None], feats, 0).astype(np.float32)
    return coords, feats, mask


def _scene(seed, n_active=None) -> SparseVoxelTensor:
    return SparseVoxelTensor(*_arrays(seed, n_active))


def _jscene(seed, n_active=None) -> JSparseVoxelTensor:
    return JSparseVoxelTensor(*_arrays(seed, n_active))


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


@pytest.fixture(scope="module")
def unet():
    tree = jax.tree.map(np.asarray,
                        init_unet(jax.random.PRNGKey(0), JUNetConfig(**CFG)))
    return tree, params_from_jax(tree, UNetConfig(**CFG), device="cpu")


@pytest.fixture(scope="module")
def specs():
    reps = (100, 101)
    return (engine.build_plan_spec([_scene(s) for s in reps],
                                   UNetConfig(**CFG)),
            jengine.build_plan_spec([_jscene(s) for s in reps],
                                    JUNetConfig(**CFG)))


def _ctx(**kw):
    return engine.ExecutionContext(device="cpu", **kw)


def _serve(eng, scenes, req_cls):
    handles = eng.submit([req_cls(i, s) for i, s in enumerate(scenes)])
    eng.serve()
    out = {h.request.rid: h.result() for h in handles}
    eng.close()
    return out


# seeds and active-voxel cuts: three sizes, so waves of 2 pad the last one
WAVE = [(200, None), (201, 900), (202, 1400)]


def test_batched_pinned_wave_matches_jax(unet, specs):
    tree, model = unet
    spec, jspec = specs
    assert all(d.backend == engine.SSPNNA for d in spec.levels)
    want = _serve(JSceneEngine(JUNetConfig(**CFG), tree, 2, spec=jspec),
                  [_jscene(*w) for w in WAVE], JSceneRequest)
    launches = sspnna_fused.launches
    eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec, ctx=_ctx())
    got = _serve(eng, [_scene(*w) for w in WAVE], SceneRequest)
    assert sspnna_fused.launches == launches  # CPU: the plain version
    assert eng.n_compilations == 1 and len(eng.wave_stats) == 2
    assert eng.graphs is None  # nothing is captured on the CPU
    for rid, r in got.items():
        assert r.logits.shape == (CAP, N_CLASSES) and r.done
        assert _rel(r.logits, np.asarray(want[rid].logits)) <= TOL
        np.testing.assert_array_equal(r.pred, r.logits.argmax(-1))


def test_bucketed_wave_matches_jax(unet):
    tree, model = unet
    sizes = [300, 320, 1500, 1600]
    fam = engine.build_signature_family(
        [_scene(10 + i, n) for i, n in enumerate(sizes)], UNetConfig(**CFG),
        max_buckets=2)
    jfam = jengine.build_signature_family(
        [_jscene(10 + i, n) for i, n in enumerate(sizes)],
        JUNetConfig(**CFG), max_buckets=2)
    assert fam.capacities == jfam.capacities and fam.n_buckets == 2
    wave = [(30, 250), (31, 1450), (32, 310), (33, 1200), (34, 200)]
    want = _serve(JSceneEngine(JUNetConfig(**CFG), tree, 2, family=jfam,
                               policy=JAdmissionPolicy()),
                  [_jscene(*w) for w in wave], JSceneRequest)
    eng = SceneEngine(UNetConfig(**CFG), model, 2, family=fam,
                      policy=AdmissionPolicy(), ctx=_ctx())
    got = _serve(eng, [_scene(*w) for w in wave], SceneRequest)
    assert eng.n_compilations == 2
    assert {s.bucket for s in eng.wave_stats} == set(fam.capacities)
    for rid, r in got.items():
        # logits come back at the request's own capacity and rows
        assert r.logits.shape == (CAP, N_CLASSES)
        assert _rel(r.logits, np.asarray(want[rid].logits)) <= TOL


@pytest.mark.parametrize("mode", ["batched", "bucketed"])
def test_async_matches_sync_bit_for_bit(unet, specs, mode):
    _, model = unet
    spec, _ = specs
    scenes = [_scene(*w) for w in WAVE] + [_scene(203, 600)]
    kw = (dict(spec=spec) if mode == "batched" else
          dict(family=engine.SignatureFamily((1024, CAP)),
               policy=AdmissionPolicy()))

    def serve(sync):
        eng = SceneEngine(UNetConfig(**CFG), model, 2, ctx=_ctx(), sync=sync,
                          depth=2, planner_threads=2, **kw)
        return {rid: r.logits for rid, r in
                _serve(eng, scenes, SceneRequest).items()}

    by_sync, by_async = serve(True), serve(False)
    assert by_sync.keys() == by_async.keys()
    for rid in by_sync:
        np.testing.assert_array_equal(by_sync[rid], by_async[rid])


def test_async_survives_plan_cache_eviction(unet, specs):
    """LRU pressure between the plan and dispatch stages neither rebuilds
    nor corrupts: dispatch adopts the plan stage's host plan."""
    _, model = unet
    spec, _ = specs
    scenes = [_scene(1000 + i, 600 + 100 * i) for i in range(4)]

    def serve(sync, size):
        ctx = _ctx(plan_cache=engine.PlanCache(size))
        eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=spec, ctx=ctx,
                          sync=sync, depth=2, planner_threads=2)
        return eng, _serve(eng, scenes, SceneRequest)

    _, by_sync = serve(True, 128)
    eng, by_async = serve(False, 1)
    for rid in by_sync:
        np.testing.assert_array_equal(by_sync[rid].logits,
                                      by_async[rid].logits)
    # one counted miss per scene at the plan stage; adoption never counts
    assert eng.cache.misses == len(scenes) and eng.cache.hits == 0


@pytest.mark.parametrize("mode", ["batched", "bucketed", "stream"])
def test_classes_come_from_the_wave_forward(unet, specs, mode):
    """Every served request's classes are the argmax taken beside the wave's
    forward, not on the host: int64 of shape (capacity,), equal bit for bit
    to numpy's argmax of the served logits, class 0 on the padding and
    inactive rows the drain zero-fills, and each wave notes its batch x
    capacity rows classified on the device."""
    _, model = unet
    spec, _ = specs
    cfg = UNetConfig(**CFG)
    if mode == "stream":
        eng = SceneEngine(cfg, model, 2, ctx=_ctx())
        frames, shifts = make_lidar_sweep(3, 3, resolution=RES, capacity=CAP,
                                          step=4)
        reqs = eng.serve_stream(
            [SparseVoxelTensor(c, f, m) for c, f, _, m in frames], shifts)
        eng.close()
        held = [r._frame_rows >= 0 for r in reqs]
    else:
        kw = (dict(spec=spec) if mode == "batched" else
              dict(family=engine.SignatureFamily((1024, CAP)),
                   policy=AdmissionPolicy()))
        eng = SceneEngine(cfg, model, 2, ctx=_ctx(), **kw)
        reqs = list(_serve(eng, [_scene(*w) for w in WAVE],
                           SceneRequest).values())
        held = [np.ones(CAP, bool) for _ in reqs]
        if mode == "bucketed":
            for r, h in zip(reqs, held):
                h[:] = False
                h[r._active_idx] = True
    assert len(reqs) == 3 and all(r.done for r in reqs)
    for r, h in zip(reqs, held):
        assert r.pred.dtype == np.int64 and r.pred.shape == (CAP,)
        np.testing.assert_array_equal(r.pred, r.logits.argmax(-1))
        assert not r.logits[~h].any() and not r.pred[~h].any()
    assert mode == "batched" or not all(h.all() for h in held)
    assert len(eng.wave_stats) == 2
    for st in eng.wave_stats:
        assert st.notes["pred_device_rows"] == 2 * (st.bucket or CAP)


def test_drained_classes_take_the_first_of_tied_maxima(unet):
    """Hand-made logits with tied rows, classified as the wave's forward
    classifies them and drained: each row's class is the first of its
    maxima, as numpy's argmax gives, in the narrowest dtype that holds the
    classes on the way."""
    _, model = unet
    eng = SceneEngine(UNetConfig(**CFG), model, 2, ctx=_ctx())
    rng = np.random.default_rng(0)
    # five levels over the classes: many rows tie at their maximum
    logits = rng.integers(-2, 3, (2 * CAP, N_CLASSES)).astype(np.float32)
    logits[0] = 0.0
    logits[1, [1, 3]] = 5.0
    out = eng._classify(torch.from_numpy(logits))
    assert out[1].dtype == torch.uint8
    reqs = [SceneRequest(i, _scene(40 + i)) for i in range(2)]
    for r in reqs:
        r._backends = ()
    eng._drain_stage(reqs, tuple(t.numpy() for t in out))
    pred = np.concatenate([r.pred for r in reqs])
    assert pred.dtype == np.int64
    np.testing.assert_array_equal(pred, logits.argmax(-1))
    assert pred[0] == 0 and pred[1] == 1
    tied = (logits == logits.max(-1, keepdims=True)).sum(-1) > 1
    assert tied.mean() > 0.1
    eng.close()
    assert [class_dtype(n) for n in (2, 256, 257, 2**15 + 1, 2**31 + 1)] == [
        torch.uint8, torch.uint8, torch.int16, torch.int32, torch.int64]


def test_wave_forward_matches_each_scenes_forward(unet, specs):
    """Three scenes of different sizes in one pass equal each scene's own
    ``apply_unet`` on the same pinned plans."""
    _, model = unet
    spec, _ = specs
    cfg = UNetConfig(**CFG)
    scenes = [_scene(*w) for w in WAVE]
    plans = [engine.build_scene_plan(t, cfg, spec=spec, device="cpu")
             for t in scenes]
    assert len({engine.plan_signature(p) for p in plans}) == 1
    wave = engine.stack_plans(plans)
    assert wave.n_scenes == 3
    with torch.no_grad():
        got = engine.apply_unet(
            model, np.concatenate([np.asarray(t.feats) for t in scenes]),
            wave, device="cpu").reshape(3, CAP, -1)
        for i, (t, p) in enumerate(zip(scenes, plans)):
            want = engine.apply_unet(model, t.feats, p, device="cpu")
            assert _rel(got[i].numpy(), want.numpy()) <= 1e-5
    # the stacked tables into a wave of the same signature, in place
    again = engine.stack_plans(plans[::-1], out=wave)
    assert again is wave
    np.testing.assert_array_equal(
        wave.levels[0].mask.numpy(),
        np.concatenate([np.asarray(t.mask) for t in scenes[::-1]]))
    with pytest.raises(ValueError, match="signature"):
        engine.stack_plans(plans[:2], out=wave)
    eng = SceneEngine(cfg, model, 3, spec=spec, ctx=_ctx())
    feats = [torch.from_numpy(np.asarray(t.feats)) for t in scenes]
    with torch.no_grad():
        np.testing.assert_array_equal(
            eng.run_wave(feats, plans, CAP)[0].numpy(),
            got.reshape(-1, N_CLASSES)
            .numpy())
    with pytest.raises(ValueError, match="features"):
        eng.run_wave([f[:, :2] for f in feats], plans, CAP)


def test_oversize_scene_shed_with_capacity_reason(unet):
    _, model = unet
    eng = SceneEngine(UNetConfig(**CFG), model, 2,
                      family=engine.SignatureFamily((256,)), ctx=_ctx())
    ok = eng.submit(SceneRequest(0, _scene(50, 100)))
    big = eng.submit(SceneRequest(1, _scene(51, 500)))
    assert big.status == SHED and big.request.shed_reason == "capacity"
    eng.serve()
    assert ok.result().logits.shape == (CAP, N_CLASSES)
    with pytest.raises(RequestShedError, match="capacity"):
        big.result()
    assert eng.slo_stats()["shed_by_reason"] == {"capacity": 1}
    eng.close()


def _tight(spec):
    """``spec`` with level 0's tile budget cut to 2 tiles."""
    return type(spec)(tuple(
        dataclasses.replace(d, n_tiles=2) if li == 0 else d
        for li, d in enumerate(spec.levels)))


@pytest.mark.parametrize("wave,served", [
    ([(60, None), (61, None)], True),   # both over level 0's budget
    ([(62, 400), (61, None)], False),   # one over it, one within it
])
def test_overflowing_plans_match_jax_engine(unet, specs, wave, served):
    """A scene over a pinned tile budget gets a reference level, so its
    plan leaves the spec's signature. The JAX engine serves a wave whose
    plans all overflowed alike on a signature of their own and raises for
    a wave whose plans disagree; the port does the same, with the same
    number of compiles (graphs), logits within 1e-4 and the raised wave's
    requests back in the queue."""
    tree, model = unet
    spec, jspec = specs
    jeng = JSceneEngine(JUNetConfig(**CFG), tree, 2, spec=_tight(jspec))
    eng = SceneEngine(UNetConfig(**CFG), model, 2, spec=_tight(spec),
                      ctx=_ctx())
    out = []
    for e, req, mk in ((jeng, JSceneRequest, _jscene),
                       (eng, SceneRequest, _scene)):
        handles = e.submit([req(i, mk(*w)) for i, w in enumerate(wave)])
        if served:
            e.serve()
            out.append({h.request.rid: np.asarray(h.result().logits)
                        for h in handles})
        else:
            with pytest.raises(RuntimeError, match="diverged from the wave"):
                e.serve()
            assert sorted(r.rid for r in e.queue) == [0, 1]
        e.close()
    assert eng.n_compilations == jeng.n_compilations == int(served)
    if served:
        (key,) = eng._buckets
        assert key[1][1][0][0].backend == engine.REFERENCE  # level 0's sub
        for rid, want in out[0].items():
            assert _rel(out[1][rid], want) <= TOL


def test_mixed_bucket_wave_raises(unet):
    _, model = unet
    eng = SceneEngine(UNetConfig(**CFG), model, 2,
                      family=engine.SignatureFamily((1024, CAP)), ctx=_ctx())
    reqs = [SceneRequest(0, _scene(70, 500)), SceneRequest(1, _scene(71))]
    for r in reqs:
        assert eng._prepare(r) is None
    payloads = [eng._plan_stage(r) for r in reqs]
    with pytest.raises(RuntimeError, match="mixes capacity buckets"):
        eng._dispatch_stage(reqs, payloads,
                            eng.scheduler._new_stats(reqs, sync=True))


def test_later_slices_and_devices_raise(unet):
    _, model = unet
    cfg = UNetConfig(**CFG)
    # sharded scenes came with slice 9: a layout without a pinned halo
    # budget is refused (tests/test_torch_sharded.py serves pinned ones)
    with pytest.raises(ValueError, match="pinned halo budget"):
        SceneEngine(cfg, model, 2, layout=engine.ShardLayout(2), ctx=_ctx())
    eng = SceneEngine(cfg, model, 2, ctx=_ctx())
    # streams came with slice 6: they open, and an empty sweep serves
    # nothing (tests/test_torch_streaming.py serves real ones)
    stream = eng.open_stream("s")
    assert stream.stream_id == "s" and stream.stats()["frames"] == 0
    assert eng.serve_stream([], stream=stream) == []
    assert eng.health()["breakers"] == {}
    with pytest.raises(ValueError, match="model is on cpu"):
        SceneEngine(cfg, model, 2,
                    ctx=engine.ExecutionContext(device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SceneEngine(cfg, model, 2)


def test_lm_engine_captures_nothing_on_the_cpu():
    """The decode-step graphs are the card's: on the CPU the engine keeps
    its eager steps, and the tokens equal the plain greedy loop's."""
    cfg = get_config("gemma2-2b").reduced()
    params = transformer.init_lm(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, 24)
    eng = Engine(cfg, params, 1, 24, 4, device="cpu")
    out = eng.submit(Request(0, prompt.astype(np.int32), max_new=4))
    eng.serve()
    assert eng.graphs is None
    assert eng.wave_stats[0].notes == {}
    with torch.no_grad():
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(prompt[None]), mode="prefill",
            cache_pad=4, last_only=True)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
        want = [int(tok[0])]
        for _ in range(3):
            logits, cache = transformer.decode_step(params, cfg, tok[:, None],
                                                    cache)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
            want.append(int(tok[0]))
    assert out.result().out == want
    eng.close()


def test_segment_scene_example_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "segment_scene_torch.py"),
         "--device", "cpu", "--requests", "3", "--batch", "2", "--res", "16",
         "--cap", "1024"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "req 2:" in res.stdout and "graphs=0" in res.stdout
