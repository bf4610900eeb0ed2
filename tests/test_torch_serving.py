"""Port parity for LM serving: the port's ``Engine`` against the JAX
package's on the reduced configs, and the pure-Python serving core
(scheduler admission, shedding, the resident loop, lock order, the token
stream) against its JAX counterpart.

Tokens are compared exactly: both engines take the greedy argmax of logits
that agree within 1e-4 (``tests/test_torch_lm.py``) at these seeds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenStream as JTokenStream
from repro.models.transformer import init_lm as jax_init_lm
from repro.serving import engine as jengine
from repro.serving import scheduler as jscheduler
from repro_torch.analysis import runtime
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models.transformer import init_lm, params_from_jax
from repro_torch.serving import scheduler
from repro_torch.serving.api import RequestShedError, ServeRequest
from repro_torch.serving.engine import Engine, Request

ARCHS = ["gemma2-2b", "stablelm-1.6b"]
# prompts up to the slot length (40 > Gemma's reduced window of 32), left
# padded with token 0
BATCH, PROMPT_LEN, MAX_NEW, N_REQ = 2, 40, 4, 5


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, n).astype(np.int32)
            for n in (40, 12, 33, 7, 25)]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _serve(engine, prompts, req_cls):
    handles = engine.submit([req_cls(i, p, max_new=MAX_NEW)
                             for i, p in enumerate(prompts)])
    engine.serve()
    out = {h.request.rid: h.result().out for h in handles}
    engine.close()
    return out


def _port_engine(cfg, params, **kw):
    return Engine(cfg, params, BATCH, PROMPT_LEN, MAX_NEW, device="cpu", **kw)


def test_engine_tokens_match_jax(lm):
    jcfg, cfg, tree, params = lm
    prompts = _prompts(cfg.vocab_size)
    want = _serve(jengine.Engine(jcfg, tree, BATCH, PROMPT_LEN, MAX_NEW),
                  prompts, jengine.Request)
    got = _serve(_port_engine(cfg, params), prompts, Request)
    assert got == want
    assert all(len(o) == MAX_NEW for o in got.values())
    assert all(0 <= t < cfg.vocab_size for o in got.values() for t in o)


def test_sync_matches_async_and_eos_truncates(lm):
    _, cfg, _, params = lm
    prompts = _prompts(cfg.vocab_size)
    by_sync = _serve(_port_engine(cfg, params, sync=True), prompts, Request)
    by_async = _serve(_port_engine(cfg, params, sync=False, depth=2),
                      prompts, Request)
    assert by_sync == by_async
    eos = by_sync[0][1]
    cut = {rid: o[:o.index(eos) + 1] if eos in o else o
           for rid, o in by_sync.items()}
    assert cut[0][-1] == eos and len(cut[0]) < MAX_NEW
    for sync in (True, False):
        assert _serve(_port_engine(cfg, params, sync=sync, eos=eos), prompts,
                      Request) == cut


def test_serve_forever_drains_on_close(lm):
    _, cfg, _, params = lm
    eng = _port_engine(cfg, params, sync=False)
    eng.serve_forever()
    handles = eng.submit([Request(i, p) for i, p in
                          enumerate(_prompts(cfg.vocab_size))])
    eng.close()
    assert all(h.done() and len(h.result().out) == MAX_NEW for h in handles)
    assert not eng.health()["alive"] and eng.slo_stats()["n_completed"] == N_REQ


def _waves(mod, policy, reqs, batch=2):
    """Wave compositions (rids) a scheduler of module ``mod`` admits."""
    waves = []
    sched = mod.WaveScheduler(
        batch=batch, plan=lambda r: r.rid,
        dispatch=lambda rs, payloads, st: payloads,
        drain=lambda rs, h, *_: waves.append(tuple(h)), policy=policy)
    sched.submit(reqs)
    sched.run()
    return waves, [(r.rid, r.shed_reason) for r in sched.shed]


def _requests(cls):
    spec = [(0, "a", 0), (1, "a", 0), (2, "a", 0), (3, "b", 0), (4, "b", 2),
            (5, "c", 1), (6, "a", 1), (7, "b", 0)]
    return [cls(rid, tenant=t, priority=p) for rid, t, p in spec]


@pytest.mark.parametrize("kw", [
    dict(), dict(tenant_weights={"a": 3.0, "b": 1.0}), dict(max_queue=5)],
    ids=["priority", "weighted", "backpressure"])
def test_admission_order_matches_jax(kw):
    from repro.serving.api import ServeRequest as JServeRequest

    got = _waves(scheduler, scheduler.AdmissionPolicy(**kw),
                 _requests(ServeRequest))
    want = _waves(jscheduler, jscheduler.AdmissionPolicy(**kw),
                  _requests(JServeRequest))
    assert got == want
    if not kw:  # strict priority first, then arrival order within a tenant
        assert got[0][0] == (4, 5)


def test_shed_request_raises_on_result(lm):
    _, cfg, _, params = lm
    eng = _port_engine(cfg, params,
                       policy=scheduler.AdmissionPolicy(max_queue=1))
    first, second = eng.submit([Request(0, np.ones(3, np.int32)),
                                Request(1, np.ones(3, np.int32))])
    assert second.status == scheduler.SHED
    with pytest.raises(RequestShedError, match="overload"):
        second.result()
    assert len(first.result().out) == MAX_NEW
    eng.close()


def test_lock_order_is_checked(monkeypatch):
    from repro.analysis.runtime import LOCK_ORDER as JAX_LOCK_ORDER

    assert runtime.LOCK_ORDER == JAX_LOCK_ORDER
    monkeypatch.setenv("REPRO_LOCK_CHECK", "1")
    outer = runtime.ordered_lock("serving.serve")
    inner = runtime.ordered_lock("scheduler.pool")
    with outer, inner:
        pass
    with inner, pytest.raises(runtime.LockOrderViolation):
        outer.acquire()
    cond = runtime.ordered_condition("stream.plan")
    with cond:
        assert not cond.wait(timeout=0.001)
    rlock = runtime.ordered_rlock("plan_cache")
    with rlock, rlock:  # reentrant
        pass
    with pytest.raises(ValueError, match="unknown lock"):
        runtime.ordered_lock("nope")


@pytest.mark.parametrize("seed,vocab,seq", [(0, 512, 40), (3, 256000, 64)])
def test_token_stream_matches_jax(seed, vocab, seq):
    ours, theirs = TokenStream(vocab, 4, seq, seed=seed), \
        JTokenStream(vocab, 4, seq, seed=seed)
    for _ in range(2):
        a, b = next(ours)["tokens"], next(theirs)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ours.state() == theirs.state()


def test_engine_raises_without_a_card(lm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, cfg, _, params = lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, BATCH, PROMPT_LEN, MAX_NEW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
