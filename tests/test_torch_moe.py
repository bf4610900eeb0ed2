"""Port parity for the MoE LM slice: the dispatch, the MoE layer and the
Moonshot 16B-A3B decoder of ``repro_torch`` against ``repro`` on the CPU.

Inputs come from seeded numpy generators and go to both packages; model
parameters are the JAX package's ``init_lm``/``init_moe`` trees carried
over. Dispatch tables and capacities must be exactly equal. Layer outputs,
aux losses, logits and caches run in f32 and agree within rtol = atol =
1e-4: the two packages sum the matmuls, the expert products and the
combine in other orders. Router probabilities of random f32 inputs do not
tie, so both packages' top-k pick the same experts in the same order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import moe_spade as jspade
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.configs.base import GLOBAL
from repro_torch.core import moe_spade
from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
from repro_torch.models import moe, transformer
from repro_torch.serving.engine import Engine, Request

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "moonshot-v1-16b-a3b"
PROMPT, PAD, STEPS = 24, 4, 3


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _routing(rng, g, t, k, e):
    """(G, T, k) distinct experts per token, as top-k gives them."""
    return np.stack([np.stack([rng.choice(e, k, replace=False)
                               for _ in range(t)]) for _ in range(g)]
                    ).astype(np.int32)


def test_config_and_param_count_match_jax():
    for reduced in (False, True):
        ours, theirs = get_config(ARCH), jax_get_config(ARCH)
        if reduced:
            ours, theirs = ours.reduced(), theirs.reduced()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    cfg = get_config(ARCH)
    assert cfg.param_count() == 27_722_252_288   # 55.4 GB in bf16
    for name in ("gemma2-2b", "stablelm-1.6b"):
        assert get_config(name).param_count() == \
            jax_get_config(name).param_count()


@pytest.mark.parametrize("g,t,k,e,cap", [
    (1, 16, 2, 8, 8),     # nothing dropped
    (2, 40, 2, 8, 4),     # many dropped
    (3, 25, 6, 16, 8),    # top-6, some dropped
    (2, 1, 6, 64, 4),     # a decode step
])
def test_build_dispatch_equals_jax(g, t, k, e, cap):
    idx = _routing(np.random.default_rng(g * t + k), g, t, k, e)
    slot, table = moe_spade.build_dispatch(torch.from_numpy(idx), e, cap)
    assert slot.dtype == table.dtype == torch.int32
    assert slot.shape == (g, t, k) and table.shape == (g, e, cap)
    for gi in range(g):
        js, jt = jspade.build_dispatch(jnp.asarray(idx[gi]), e, cap)
        np.testing.assert_array_equal(slot[gi].numpy(), np.asarray(js))
        np.testing.assert_array_equal(table[gi].numpy(), np.asarray(jt))
    # ungrouped (T, k) routings take the same path
    s0, t0 = moe_spade.build_dispatch(torch.from_numpy(idx[0]), e, cap)
    assert torch.equal(s0, slot[0]) and torch.equal(t0, table[0])


def test_capacity_planning_equals_jax():
    for args in [(4096, 6, 64, 1.25), (1, 6, 64, 1.25), (24, 2, 8, 4.0),
                 (7, 1, 3, 1.0)]:
        assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert moe.moe_capacity(4096, 6, 64, 1.25) == 484   # the chip run's
    loads = np.random.default_rng(0).integers(0, 200, (30, 16))
    for mode in ("RST", "SST"):
        for q in (0.5, 0.9):
            assert moe_spade.plan_capacity(loads, 16, 512, 2, mode, q) == \
                jspade.plan_capacity(loads, 16, 512, 2, mode, q)
    assert moe_spade.capacity_factor(96, 512, 2, 16) == \
        jspade.capacity_factor(96, 512, 2, 16)
    idx = _routing(np.random.default_rng(1), 1, 50, 2, 16)
    np.testing.assert_array_equal(moe_spade.expert_load_stats(idx, 16),
                                  jspade.expert_load_stats(idx, 16))


@pytest.mark.parametrize("cap", [24, 4], ids=["no_drop", "drop"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_moe_matches_jax(act, cap):
    e, k, d, f = 8, 2, 32, 64
    params = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(1), d, f, e, act, jnp.float32))
    assert ("w_gate" in params) == (act != "gelu")
    x = np.random.default_rng(2).normal(size=(2, 24, d)).astype(np.float32)
    want, jaux = jmoe.apply_moe(params, jnp.asarray(x), top_k=k, capacity=cap,
                                act=act)
    launches = grouped_gemm.launches
    got, aux = moe.apply_moe({n: torch.from_numpy(np.array(v))
                              for n, v in params.items()},
                             torch.from_numpy(x), top_k=k, capacity=cap,
                             act=act)
    assert grouped_gemm.launches == launches   # CPU: the plain version
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert set(aux) == set(jaux)
    for name in aux:
        np.testing.assert_allclose(_np(aux[name]), np.asarray(jaux[name]),
                                   **TOL)
    assert (float(aux["moe_dropped"]) > 0) == (cap == 4)


def test_init_moe_is_shaped_like_jax():
    g = torch.Generator().manual_seed(0)
    for act in ("swiglu", "gelu"):
        got = moe.init_moe(g, 32, 48, 4, act, torch.bfloat16,
                           torch.device("cpu"))
        want = jmoe.init_moe(jax.random.PRNGKey(0), 32, 48, 4, act,
                             jnp.bfloat16)
        assert set(got) == set(want)
        for n, v in got.items():
            assert tuple(v.shape) == want[n].shape
            assert str(v.dtype).removeprefix("torch.") == str(want[n].dtype)


def test_a2a_dispatch_raises():
    params = moe.init_moe(torch.Generator().manual_seed(0), 16, 32, 4,
                          "swiglu", torch.float32, torch.device("cpu"))
    x = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.apply_moe(params, x, top_k=2, capacity=4, act="swiglu",
                      dispatch="a2a")

    class ShardMesh:  # what the port reads of a DeviceMesh
        mesh_dim_names, shape = ("shard",), (2,)

    with pytest.raises(ValueError, match="not in mesh axes"):
        moe.apply_moe(params, x, top_k=2, capacity=4, act="swiglu",
                      mesh=ShardMesh(), dispatch="a2a")
    with pytest.raises(ValueError, match="not one of"):
        moe.apply_moe(params, x, top_k=2, capacity=4, act="swiglu",
                      dispatch="scatter")


def _jax_layer_caches(jcache, cfg):
    """The JAX cache's per-layer (k, v), in layer order."""
    cycle = len(cfg.attn_pattern)
    n_cycles = cfg.n_layers // cycle
    out = [(np.asarray(jcache["cycles"][j]["attn"]["k"][i]),
            np.asarray(jcache["cycles"][j]["attn"]["v"][i]))
           for i in range(n_cycles) for j in range(cycle)]
    out += [(np.asarray(c["attn"]["k"]), np.asarray(c["attn"]["v"]))
            for c in jcache["rem"]]
    return out


def _variant(cfg, name):
    """The reduced config; "period2" makes every other layer dense (the
    pattern has two positions so the JAX package's per-cycle stacks hold
    one kind of layer each); "drop" cuts the capacity so tokens drop."""
    if name == "period2":
        return dataclasses.replace(cfg, attn_pattern=(GLOBAL, GLOBAL),
                                   moe=dataclasses.replace(
                                       cfg.moe, moe_layer_period=2))
    if name == "drop":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return cfg


@pytest.fixture(scope="module", params=["reduced", "period2", "drop"])
def lm(request):
    jcfg = _variant(jax_get_config(ARCH).reduced(), request.param)
    cfg = _variant(get_config(ARCH).reduced(), request.param)
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    params = transformer.params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return jcfg, cfg, tree, params, toks


def test_params_from_jax_carries_the_moe_layers(lm):
    _, cfg, _, params, _ = lm
    kinds = ["moe" if "moe" in lp else "mlp" for lp in params["layers"]]
    period = cfg.moe.moe_layer_period
    assert kinds == ["moe" if i % period == 0 else "mlp"
                     for i in range(cfg.n_layers)]
    p = params["layers"][0]["moe"]
    assert p["router"].dtype == torch.float32
    assert tuple(p["w_gate"].shape) == (cfg.moe.n_experts, cfg.d_model,
                                        cfg.d_ff)
    n = sum(x.numel() for lp in params["layers"] for x in jax.tree.leaves(
        lp, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    n += params["embed"].numel()
    norms = cfg.n_layers * 2 * cfg.d_model
    assert n - norms == cfg.param_count()


def test_prefill_aux_and_decode_match_jax(lm):
    jcfg, cfg, tree, params, toks = lm
    jlogits, jcache, jaux = jtransformer.forward(
        tree, jcfg, jnp.asarray(toks), mode="prefill", cache_pad=PAD)
    with torch.no_grad():
        logits, cache, aux = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    assert set(aux) == set(jaux) == {"moe_lb_loss", "moe_z_loss",
                                     "moe_dropped", "expert_load"}
    for name in aux:
        np.testing.assert_allclose(_np(aux[name]), np.asarray(jaux[name]),
                                   **TOL)
    if jcfg.moe.capacity_factor < 1:
        assert float(aux["moe_dropped"]) > 0
    for c, (wk, wv) in zip(cache["layers"], _jax_layer_caches(jcache, cfg),
                           strict=True):
        np.testing.assert_allclose(_np(c["k"]), wk, **TOL)
        np.testing.assert_allclose(_np(c["v"]), wv, **TOL)
    tok = np.argmax(np.asarray(jlogits)[:, -1, :cfg.vocab_size], -1)
    for _ in range(STEPS):
        tok = tok.astype(np.int32)[:, None]
        jl, jcache = jtransformer.decode_step(tree, jcfg, jnp.asarray(tok),
                                              jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1, :cfg.vocab_size], -1)
    for c, (wk, wv) in zip(cache["layers"], _jax_layer_caches(jcache, cfg)):
        np.testing.assert_allclose(_np(c["k"]), wk, **TOL)
        np.testing.assert_allclose(_np(c["v"]), wv, **TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_groups_match_jax(lm, groups):
    """Routing in other groups than the batch rows (one group for the whole
    batch, or four groups of half a row), in prefill and decode."""
    jcfg, cfg, tree, params, toks = lm
    jlogits, jcache, jaux = jtransformer.forward(
        tree, jcfg, jnp.asarray(toks), mode="prefill", cache_pad=PAD,
        moe_groups=groups)
    with torch.no_grad():
        logits, cache, aux = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD, moe_groups=groups)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(_np(aux["moe_dropped"]),
                               np.asarray(jaux["moe_dropped"]), **TOL)
    if groups <= toks.shape[0]:   # a decode step has one token per row
        tok = np.argmax(np.asarray(jlogits)[:, -1, :cfg.vocab_size],
                        -1).astype(np.int32)[:, None]
        jl, _ = jtransformer.decode_step(tree, jcfg, jnp.asarray(tok), jcache,
                                         moe_groups=groups)
        with torch.no_grad():
            lg, _ = transformer.decode_step(params, cfg, torch.from_numpy(tok),
                                            cache, moe_groups=groups)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)


def test_init_lm_is_seeded_and_shaped_like_jax():
    cfg = _variant(get_config(ARCH).reduced(), "period2")
    a = transformer.init_lm(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    b = transformer.init_lm(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    jcfg = _variant(jax_get_config(ARCH).reduced(), "period2")
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    want = transformer.params_from_jax(tree, cfg, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, x), (_, y), (pw, w) in zip(flat(a), flat(b), flat(want),
                                        strict=True):
        assert pa == pw and x.shape == w.shape and x.dtype == w.dtype
        assert torch.equal(x, y)


def test_engine_tokens_match_jax(lm):
    jcfg, cfg, tree, params, _ = lm
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 7, 16)]
    out = {}
    for name, eng, req in (
            ("jax", jengine.Engine(jcfg, tree, 2, 20, 4), jengine.Request),
            ("sync", Engine(cfg, params, 2, 20, 4, device="cpu"), Request),
            ("async", Engine(cfg, params, 2, 20, 4, sync=False, device="cpu"),
             Request)):
        handles = eng.submit([req(i, p, max_new=4)
                              for i, p in enumerate(prompts)])
        eng.serve()
        out[name] = {h.request.rid: h.result().out for h in handles}
        eng.close()
    assert out["sync"] == out["jax"] == out["async"]
    assert all(len(o) == 4 for o in out["sync"].values())
