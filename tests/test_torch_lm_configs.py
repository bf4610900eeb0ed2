"""Port parity for the LM configs of slice 10, parts a and b: Granite-8B,
H2O-Danube-3-4B, Llama-4 Maverick, RecurrentGemma-9B and RWKV-6-7B, at
their ``reduced()`` sizes, against the JAX package on the CPU.

Inputs come from seeded numpy generators; the port's parameters are the
JAX package's ``init_lm`` tree carried over by ``params_from_jax``.
Everything runs in f32. Tolerances: logits and caches rtol = atol = 1e-4
(the flash kernel's plain version, the port's log-depth RG-LRU scan and
its RWKV chunk loop sum in other orders than XLA); served tokens exactly;
a train step's gradients within 1e-5 of each leaf's largest entry (RWKV
4e-5, ``RWKV_GRAD_TOL``); the Adafactor step of reduced Maverick 1e-6
(its update is normalized, and lr = 1e-3 scales what the gradients'
rounding leaves of it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.training import optimizer as joptimizer
from repro.training import train_loop as jtrain_loop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.flash.flash import flash_attention
from repro_torch.models import transformer
from repro_torch.serving.engine import Engine, Request
from repro_torch.training import optimizer, train_loop
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["granite-8b", "h2o-danube-3-4b", "llama4-maverick-400b-a17b",
         "recurrentgemma-9b", "rwkv6-7b"]
# longer than the reduced window of 32 (H2O's and RecurrentGemma's local
# layers take the ring layout) and within one RWKV chunk of 64
PROMPT, PAD, STEPS = 48, 4, 4
# RWKV's gradients carry more f32 rounding than the other layers' (the
# per-head group norm divides the wkv output by its spread): at this batch
# the JAX package's own f32 gradients stand ~2.5e-5 of a leaf's largest
# entry from its f64 evaluation, and the port's ~1.2e-5. At most twice the
# reference's own distance bounds the port against it
# (``test_rwkv_grad_tol_is_twice_the_references_own_rounding``).
RWKV_GRAD_TOL = 4e-5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def port_layout_cache(jcache, cfg) -> list[dict]:
    """The JAX package's cache as the port's per-layer flat dicts: a layer's
    ``{"attn": {"k", "v"}}``, ``{"rwkv": {"s", "x_tm"}, "rwkv_cm":
    {"x_cm"}}`` or ``{"rec": {"h", "conv"}}`` merged into one dict, the
    cycles' stacks un-stacked in layer order."""
    def flat(c):
        return {k: v for sub in c.values() for k, v in sub.items()}

    cycle = len(cfg.attn_pattern)
    n_cycles = cfg.n_layers // cycle
    out = [{k: np.asarray(v)[i] for k, v in flat(jcache["cycles"][j]).items()}
           for i in range(n_cycles) for j in range(cycle)]
    out += [{k: np.asarray(v) for k, v in flat(c).items()}
            for c in jcache["rem"]]
    return out


def _assert_caches_close(got, want, **tol):
    assert len(got) == len(want)
    for i, (c, w) in enumerate(zip(got, want)):
        assert set(c) == set(w), i
        for k in c:
            assert tuple(c[k].shape) == w[k].shape, (i, k)
            np.testing.assert_allclose(_np(c[k]), w[k], err_msg=f"{i} {k}",
                                       **tol)


def _port_config(jcfg) -> ModelConfig:
    """A JAX config field for field as the port's ``ModelConfig``."""
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = MoEConfig(**fields["moe"])
    return ModelConfig(**fields)


def _lm(name, **change):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **change)
    cfg = dataclasses.replace(get_config(name).reduced(), **change)
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, transformer.params_from_jax(tree, cfg,
                                                        device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    jcfg, cfg, tree, params = _lm(request.param)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS)).astype(np.int32)
    return jcfg, cfg, tree, params, toks


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(name, reduced):
    ours, theirs = get_config(name), jax_get_config(name)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.vocab_padded == theirs.vocab_padded
    assert ours.param_count() == theirs.param_count()
    assert [ours.layer_kind(i) for i in range(ours.n_layers)] == \
        [theirs.layer_kind(i) for i in range(theirs.n_layers)]


@pytest.mark.parametrize("name", ["pixtral-12b", "seamless-m4t-medium"])
def test_part_c_configs_still_raise(name):
    """Pixtral's vision frontend and SeamlessM4T's encoder-decoder are
    served and trained (``tests/test_torch_vlm_encdec.py``); what the JAX
    package refuses, the port still refuses: more patch embeddings than
    positions, and an encoder-decoder forward or train batch without its
    source frames."""
    cfg = _port_config(jax_get_config(name).reduced())
    params = transformer.init_lm(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    step = train_loop.make_train_step(cfg)
    if cfg.is_encdec:
        with pytest.raises(ValueError, match="enc_frames"):
            transformer.forward(params, cfg, toks, mode="prefill")
        with pytest.raises(KeyError, match="enc_frames"):
            step(train_loop.init_train_state(cfg, params=params,
                                             device="cpu"),
                 {"tokens": np.zeros((1, 5), np.int32)})
    else:
        fe = torch.zeros((1, cfg.n_frontend_tokens, cfg.d_model))
        with pytest.raises(ValueError, match="do not fit"):
            transformer.forward(params, cfg, toks, mode="prefill",
                                frontend_embeds=fe)


@pytest.mark.parametrize("name", NAMES)
def test_params_keep_each_leafs_dtype(name):
    """In a bf16 model the f32 leaves (an MoE router; the RG-LRU's w_a, w_x
    and lam; the time mix's w0, LoRA, u and ln_x) stay f32, both carried
    over from the JAX tree and drawn by the port's ``init_lm``; shapes
    equal the JAX tree's."""
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    params = transformer.params_from_jax(tree, cfg, device="cpu")
    drawn = transformer.init_lm(cfg, device="cpu")
    dtypes = set()
    for (path, a), (_, b) in zip(tree_leaves_with_path(params),
                                 tree_leaves_with_path(drawn), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        dtypes.add(a.dtype)
    assert dtypes <= {torch.bfloat16, torch.float32}
    jlayers = [l for c in tree["cycles"] for l in jax.tree.leaves(c)]
    want32 = sum(x.dtype == np.float32 for x in jlayers)
    n_cycles = cfg.n_layers // len(cfg.attn_pattern)
    got32 = sum(p.dtype == torch.float32 for lp in params["layers"]
                for p in tree_leaves(lp))
    assert got32 == want32 * n_cycles
    assert (got32 > 0) == (name not in ("granite-8b", "h2o-danube-3-4b"))


def test_recurrentgemma_cycles_and_rem_layers_match_jax():
    """8 layers of (RGLRU, RGLRU, LOCAL): 2 cycles and 2 layers after them
    (the published 38 are 12 cycles and 2): prefill logits and caches and
    two decode steps."""
    jcfg, cfg, tree, params = _lm("recurrentgemma-9b", n_layers=8)
    assert len(tree["rem"]) == 2 and len(params["layers"]) == 8
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (2, PROMPT)).astype(np.int32)
    jl, jcache, _ = jtransformer.forward(tree, jcfg, jnp.asarray(toks),
                                         mode="prefill", cache_pad=PAD)
    with torch.no_grad():
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    _assert_caches_close(cache["layers"], port_layout_cache(jcache, cfg),
                         **TOL)
    tok = toks[:, -1:]
    for _ in range(2):
        jl, jcache = jtransformer.decode_step(tree, jcfg, jnp.asarray(tok),
                                              jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1, :cfg.vocab_size], -1).astype(
            np.int32)[:, None]
    _assert_caches_close(cache["layers"], port_layout_cache(jcache, cfg),
                         **TOL)


def test_train_and_prefill_match_jax(lm):
    jcfg, cfg, tree, params, toks = lm
    toks = toks[:, :PROMPT]
    jtrain, _, _ = jtransformer.forward(tree, jcfg, jnp.asarray(toks))
    jl, jcache, _ = jtransformer.forward(tree, jcfg, jnp.asarray(toks),
                                         mode="prefill", cache_pad=PAD)
    launches = flash_attention.launches
    with torch.no_grad():
        train, none, _ = transformer.forward(params, cfg,
                                             torch.from_numpy(toks))
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD)
    assert flash_attention.launches == launches  # CPU: the plain version
    assert none is None and cache["pos"] == PROMPT == int(jcache["pos"])
    np.testing.assert_allclose(_np(train), np.asarray(jtrain), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    _assert_caches_close(cache["layers"], port_layout_cache(jcache, cfg),
                         **TOL)


def test_decode_matches_jax(lm):
    """Four decode steps from the prefill cache: logits at each step, and
    every layer's cache (KV and recurrent state) after the last."""
    jcfg, cfg, tree, params, toks = lm
    jl, jcache, _ = jtransformer.forward(
        tree, jcfg, jnp.asarray(toks[:, :PROMPT]), mode="prefill",
        cache_pad=PAD)
    with torch.no_grad():
        _, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(toks[:, :PROMPT]), mode="prefill",
            cache_pad=PAD)
    tok = np.argmax(np.asarray(jl)[:, -1, :cfg.vocab_size], -1)
    for _ in range(STEPS):
        tok = tok.astype(np.int32)[:, None]
        jl, jcache = jtransformer.decode_step(tree, jcfg, jnp.asarray(tok),
                                              jcache)
        with torch.no_grad():
            lg, cache = transformer.decode_step(params, cfg,
                                                torch.from_numpy(tok), cache)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1, :cfg.vocab_size], -1)
    assert cache["pos"] == PROMPT + STEPS == int(jcache["pos"])
    _assert_caches_close(cache["layers"], port_layout_cache(jcache, cfg),
                         **TOL)


def test_decode_matches_forward(lm):
    """The twin of ``tests/test_models.py::test_arch_decode_matches_forward``
    on the port: a prefill of 48 tokens and 4 decode steps give the train
    forward's logits at those positions, within the JAX test's 5e-2."""
    _, cfg, _, params, toks = lm
    t = torch.from_numpy(toks)
    with torch.no_grad():
        full, _, _ = transformer.forward(params, cfg, t, mode="train")
        _, cache, _ = transformer.forward(params, cfg, t[:, :PROMPT],
                                          mode="prefill", cache_pad=STEPS)
        for i in range(STEPS):
            logit, cache = transformer.decode_step(
                params, cfg, t[:, PROMPT + i:PROMPT + i + 1], cache)
            err = float((logit[:, 0] - full[:, PROMPT + i]).abs().max())
            assert err < 5e-2, (cfg.name, i, err)


def test_decode_writes_the_state_in_place(lm):
    """A decode step advances the cache's own tensors (what a CUDA graph of
    the step replays on) and returns them."""
    _, cfg, _, params, toks = lm
    with torch.no_grad():
        _, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(toks[:, :PROMPT]), mode="prefill",
            cache_pad=PAD)
        before = [{k: v.clone() for k, v in c.items()}
                  for c in cache["layers"]]
        ptrs = [{k: v.data_ptr() for k, v in c.items()}
                for c in cache["layers"]]
        _, new = transformer.decode_step(
            params, cfg, torch.from_numpy(toks[:, PROMPT:PROMPT + 1]), cache)
    for c, n, b, p in zip(cache["layers"], new["layers"], before, ptrs,
                          strict=True):
        assert {k: v.data_ptr() for k, v in c.items()} == p
        assert {k: v.data_ptr() for k, v in n.items()} == p
        assert any(not torch.equal(c[k], b[k]) for k in c)


def test_init_decode_cache_matches_jax(lm):
    jcfg, cfg, *_ = lm
    want = port_layout_cache(jtransformer.init_decode_cache(jcfg, 2, 40), cfg)
    got = transformer.init_decode_cache(cfg, 2, 40, device="cpu")
    assert got["pos"] == 40
    assert len(got["layers"]) == len(want)
    for c, w in zip(got["layers"], want):
        assert set(c) == set(w)
        for k in c:
            assert tuple(c[k].shape) == w[k].shape and not c[k].any()
            assert str(c[k].dtype).removeprefix("torch.") == str(w[k].dtype)


def test_engine_tokens_match_jax(lm):
    """The port's ``Engine`` serves the JAX ``Engine``'s tokens: batch 2,
    slots of 48, 4 new tokens, five prompts (three waves)."""
    jcfg, cfg, tree, params, _ = lm
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (48, 12, 33, 7, 25)]

    def serve(engine, req):
        handles = engine.submit([req(i, p, max_new=4)
                                 for i, p in enumerate(prompts)])
        engine.serve()
        out = {h.request.rid: h.result().out for h in handles}
        engine.close()
        return out

    want = serve(jengine.Engine(jcfg, tree, 2, PROMPT, 4), jengine.Request)
    got = serve(Engine(cfg, params, 2, PROMPT, 4, device="cpu"), Request)
    assert got == want
    assert all(len(o) == 4 for o in got.values())


def _grad_batch(cfg) -> dict:
    return {"tokens": np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)}


def _port_grads(cfg, params, batch):
    """(loss, the gradients of every leaf in ``tree_leaves`` order)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    total, _ = train_loop.make_loss_fn(cfg)(live, batch)
    return total.detach(), torch.autograd.grad(total, tree_leaves(live))


def test_train_step_gradients_match_jax(lm):
    """The train step's gradients (the loss with the MoE auxiliaries) from
    the same parameters and batch, within 1e-5 of each leaf's largest
    entry (RWKV: ``RWKV_GRAD_TOL``), and the loss within 1e-5."""
    jcfg, cfg, tree, params, _ = lm
    batch = _grad_batch(cfg)
    (jtotal, _), jgrads = jax.value_and_grad(
        jtrain_loop.make_loss_fn(jcfg), has_aux=True)(
            tree, jax.tree.map(jnp.asarray, batch))
    jgrads = transformer.params_from_jax(jax.tree.map(np.asarray, jgrads),
                                         cfg, device="cpu")
    total, grads = _port_grads(cfg, params, batch)
    np.testing.assert_allclose(float(total), float(jtotal),
                               rtol=1e-5, atol=1e-5)
    tol = RWKV_GRAD_TOL if cfg.name == "rwkv6-7b" else 1e-5
    for g, (path, jg) in zip(grads, tree_leaves_with_path(jgrads),
                             strict=True):
        err = float((g - jg).abs().max() / jg.abs().max().clamp(min=1e-30))
        assert err <= tol, (path, err)


def test_rwkv_grad_tol_is_twice_the_references_own_rounding():
    """``RWKV_GRAD_TOL`` rests on the JAX package's own f32 rounding: at the
    gradient test's batch its f32 gradients stand ``gap`` from its f64
    evaluation (the worst leaf, relative to the leaf's largest entry); the
    tolerance is at most twice that, and the port's f32 gradients stand no
    farther than ``gap`` from the f64 evaluation."""
    jcfg, cfg, tree, params = _lm("rwkv6-7b")
    batch = _grad_batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss = jtrain_loop.make_loss_fn(jcfg)
    j32 = jax.grad(lambda p: loss(p, jbatch)[0])(tree)
    with jax.enable_x64(True):
        jcfg64 = dataclasses.replace(jcfg, dtype="float64",
                                     attn_dtype="float64")
        loss64 = jtrain_loop.make_loss_fn(jcfg64)
        j64 = jax.grad(lambda p: loss64(p, jbatch)[0])(
            jax.tree.map(lambda a: np.asarray(a, np.float64), tree))
        j64 = jax.tree.map(lambda a: np.asarray(a, np.float64), j64)
    assert all(a.dtype == np.float64 for a in jax.tree.leaves(j64))

    def worst(got, want):
        return max(float(np.abs(np.asarray(g, np.float64) - w).max()
                         / max(np.abs(w).max(), 1e-30))
                   for g, w in zip(got, want, strict=True))

    gap = worst(jax.tree.leaves(j32), jax.tree.leaves(j64))
    assert RWKV_GRAD_TOL <= 2 * gap
    _, grads = _port_grads(cfg, params, batch)
    want = [w.numpy() for w in tree_leaves(
        transformer.params_from_jax(j64, cfg, device="cpu"))]
    assert worst([g.double().numpy() for g in grads], want) <= gap


def test_h2o_prefill_at_head_dim_120_matches_jax():
    """H2O's published head dim, 120, through the flash wrapper's plain
    path and the decode steps after it."""
    jcfg, cfg, tree, params = _lm("h2o-danube-3-4b", head_dim=120)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (2, PROMPT)).astype(np.int32)
    jl, jcache, _ = jtransformer.forward(tree, jcfg, jnp.asarray(toks),
                                         mode="prefill", cache_pad=PAD)
    with torch.no_grad():
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    _assert_caches_close(cache["layers"], port_layout_cache(jcache, cfg),
                         **TOL)
    assert cache["layers"][0]["k"].shape[-1] == 120


def test_maverick_adafactor_step_matches_jax():
    """One Adafactor step of reduced Maverick (the optimizer its config
    names) from the same state and batch: loss, auxiliaries and grad norm
    within 1e-4, the updated params and second moments within 1e-6. The
    update clip takes the RMS over each stacked JAX leaf
    (``layout_groups``)."""
    name = "llama4-maverick-400b-a17b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    assert cfg.optimizer == "adafactor"
    hp, jhp = optimizer.OptHParams(lr=1e-3), joptimizer.OptHParams(lr=1e-3)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(2), jcfg, jhp)
    batch = {"tokens": np.random.default_rng(10).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)}
    jnew, jm = jax.jit(jtrain_loop.make_train_step(jcfg, jhp))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})

    def port(tree):
        """A JAX tree (params, or Adafactor's moments: a small dict at each
        param leaf) in the port's layout."""
        def conv(node, index=None):
            if isinstance(node, dict):
                return {k: conv(v, index) for k, v in node.items()}
            x = np.asarray(node)
            return torch.from_numpy(np.array(x if index is None else x[index]))

        n_cycles = cfg.n_layers // len(cfg.attn_pattern)
        out = {k: conv(v) for k, v in tree.items()
               if k not in ("cycles", "rem")}
        out["layers"] = ([conv(c, i) for i in range(n_cycles)
                          for c in tree["cycles"]]
                         + [conv(lp) for lp in tree["rem"]])
        return out

    state = {"params": port(jstate["params"]),
             "opt": {"v": port(jstate["opt"]["v"])},
             "step": torch.tensor(0, dtype=torch.int32)}
    new, m = train_loop.make_train_step(cfg, hp)(state, batch)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for got, want in ((new["params"], port(jnew["params"])),
                      (new["opt"]["v"], port(jnew["opt"]["v"]))):
        for (path, a), b in zip(tree_leaves_with_path(got), tree_leaves(want),
                                strict=True):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6,
                                       err_msg=str(path))


def test_adafactor_trains_moe():
    """The twin of ``tests/test_training.py::test_adafactor_trains_moe``:
    reduced Maverick from the JAX test's parameters (``PRNGKey(0)``), 8
    Adafactor steps on the same batches, the last loss below the first; the
    losses are the JAX run's within 1e-4."""
    from repro.data.tokens import TokenStream as JTokenStream
    from repro_torch.data.tokens import TokenStream

    name = "llama4-maverick-400b-a17b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jhp, hp = joptimizer.OptHParams(lr=1e-3), optimizer.OptHParams(lr=1e-3)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    params = transformer.params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    jstep = jax.jit(jtrain_loop.make_train_step(jcfg, jhp))
    jds = JTokenStream(jcfg.vocab_size, 4, 32, 1)
    state = train_loop.init_train_state(cfg, hp, params, device="cpu")
    step = train_loop.make_train_step(cfg, hp)
    ds = TokenStream(cfg.vocab_size, 4, 32, 1)
    jlosses, losses = [], []
    for _ in range(8):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in next(jds).items()})
        state, m = step(state, next(ds))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
