"""Port parity for Pixtral-12B's vision frontend and SeamlessM4T-medium's
encoder-decoder at their ``reduced()`` sizes, against the JAX package on
the CPU.

Inputs (tokens, patch embeddings, source frames) come from seeded numpy
generators; the port's parameters are the JAX package's ``init_lm`` tree
carried over by ``params_from_jax``. Everything runs in f32. Tolerances:
prefill logits, every cache tensor and decode logits rtol = atol = 1e-4
(the flash kernel's plain version sums in another order than XLA's
chunked loop); greedy tokens exactly; a train step's gradients within
1e-5 of each leaf's largest entry and its loss within 1e-5, and the AdamW
step's updated params as ``tests/test_torch_training.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.training import optimizer as joptimizer
from repro.training import train_loop as jtrain_loop
from repro_torch.configs import get_config
from repro_torch.models import attention, transformer
from repro_torch.serving.engine import Engine, make_prefill
from repro_torch.training import optimizer, train_loop
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path, tree_map
from test_torch_training import _assert_updated_params_close, _state_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
PIXTRAL, SEAMLESS = "pixtral-12b", "seamless-m4t-medium"
NAMES = [PIXTRAL, SEAMLESS]
PROMPT, PAD, STEPS = 24, 4, 4
# Seamless's source lengths: shorter and longer than the prompt, so the
# cross attention runs with Sq > Skv and Sq < Skv
SRC_LENS = (16, 40)
# (name, source length) of every served case; Pixtral has no source
CASES = [(PIXTRAL, 0)] + [(SEAMLESS, n) for n in SRC_LENS]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _lm(name):
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, transformer.params_from_jax(tree, cfg,
                                                        device="cpu")


_LMS: dict = {}


def _model(name):
    if name not in _LMS:
        _LMS[name] = _lm(name)
    return _LMS[name]


def _inputs(cfg, src_len: int, seed: int = 3, batch: int = 2,
            length: int = PROMPT) -> dict:
    """Seeded tokens, and the config's extra input: 8 patch embeddings for
    Pixtral, ``src_len`` source frames for Seamless."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, length)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal(
            (batch, src_len, cfg.d_model)).astype(np.float32)
    return out


def _extra(inputs, to):
    return {k: to(v) for k, v in inputs.items() if k != "tokens"}


def _port_cache(jcache, cfg) -> list[dict]:
    """The JAX package's cache as the port's flat per-layer dicts: a
    layer's ``{"attn": {"k", "v"}, "cross": {"ck", "cv"}}`` merged, the
    stacked cycle un-stacked."""
    n = cfg.n_layers
    flat = {k: np.asarray(v) for sub in jcache["cycles"][0].values()
            for k, v in sub.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(name, reduced):
    ours, theirs = get_config(name), jax_get_config(name)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.vocab_padded == theirs.vocab_padded
    assert ours.param_count() == theirs.param_count()


def test_published_sizes():
    """Pixtral-12B 12.247 B parameters, SeamlessM4T-medium 0.615 B (its
    vocab of 256206 padded to 256256)."""
    pix, sea = get_config(PIXTRAL), get_config(SEAMLESS)
    assert round(pix.param_count() / 1e9, 3) == 12.247
    assert round(sea.param_count() / 1e9, 3) == 0.615
    assert sea.vocab_padded == 256256 and sea.tie_embeddings
    assert (pix.n_frontend_tokens, pix.frontend) == (256, "vision")


@pytest.mark.parametrize("name", NAMES)
def test_params_carry_the_encoder_and_cross_blocks(name):
    """``init_lm`` and ``params_from_jax`` give the same tree: an encoder
    of global layers with no cross block, a cross block in every decoder
    layer (Seamless), and neither for Pixtral."""
    jcfg, cfg, tree, params = _model(name)
    mine = transformer.init_lm(cfg, device="cpu")
    shapes = [(p, tuple(x.shape), x.dtype)
              for p, x in tree_leaves_with_path(params)]
    assert shapes == [(p, tuple(x.shape), x.dtype)
                      for p, x in tree_leaves_with_path(mine)]
    if cfg.is_encdec:
        enc = params["encoder"]
        assert len(enc["layers"]) == cfg.encoder_layers
        assert all("cross" not in lp for lp in enc["layers"])
        assert all({"cross", "ln_cross"} <= set(lp) for lp in params["layers"])
        np.testing.assert_array_equal(
            _np(enc["layers"][1]["attn"]["wq"]),
            tree["encoder"]["cycles"][0]["attn"]["wq"][1])
    else:
        assert "encoder" not in params
        assert all("cross" not in lp for lp in params["layers"])


@pytest.mark.parametrize("name,src_len", CASES)
def test_prefill_matches_jax(name, src_len):
    """Prefill logits and every cache tensor (the self-attention KV with
    its pad, and Seamless's cross keys and values) within 1e-4."""
    jcfg, cfg, tree, params = _model(name)
    inputs = _inputs(cfg, src_len)
    jlogits, jcache, _ = jtransformer.forward(
        tree, jcfg, jnp.asarray(inputs["tokens"]), mode="prefill",
        cache_pad=PAD, **_extra(inputs, jnp.asarray))
    with torch.no_grad():
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(inputs["tokens"]), mode="prefill",
            cache_pad=PAD, **_extra(inputs, torch.from_numpy))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    want = _port_cache(jcache, cfg)
    keys = {"k", "v", "ck", "cv"} if cfg.is_encdec else {"k", "v"}
    assert cache["pos"] == PROMPT
    for i, (c, w) in enumerate(zip(cache["layers"], want, strict=True)):
        assert set(c) == set(w) == keys
        for k in c:
            assert tuple(c[k].shape) == w[k].shape, (i, k)
            np.testing.assert_allclose(_np(c[k]), w[k], err_msg=f"{i} {k}",
                                       **TOL)


@pytest.mark.parametrize("name,src_len", CASES)
def test_decode_over_the_cross_cache_matches_jax(name, src_len):
    """Greedy decode steps from each package's own prefill: logits within
    1e-4 and tokens equal at every step; the port's cross cache is read
    and left as the prefill wrote it."""
    jcfg, cfg, tree, params = _model(name)
    inputs = _inputs(cfg, src_len)
    jlogits, jcache, _ = jtransformer.forward(
        tree, jcfg, jnp.asarray(inputs["tokens"]), mode="prefill",
        cache_pad=STEPS, **_extra(inputs, jnp.asarray))
    with torch.no_grad():
        logits, cache, _ = transformer.forward(
            params, cfg, torch.from_numpy(inputs["tokens"]), mode="prefill",
            cache_pad=STEPS, **_extra(inputs, torch.from_numpy))
        cross = [{k: c[k].clone() for k in ("ck", "cv") if k in c}
                 for c in cache["layers"]]
        jtok = np.argmax(np.asarray(jlogits)[:, -1, :cfg.vocab_size], -1)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
        for step in range(STEPS):
            np.testing.assert_array_equal(tok.numpy(), jtok, err_msg=step)
            jlogits, jcache = jtransformer.decode_step(
                tree, jcfg, jnp.asarray(jtok[:, None], jnp.int32), jcache)
            logits, cache = transformer.decode_step(
                params, cfg, tok[:, None].to(torch.int32), cache)
            np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                       err_msg=str(step), **TOL)
            jtok = np.argmax(np.asarray(jlogits)[:, -1, :cfg.vocab_size], -1)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
    for c, before in zip(cache["layers"], cross):
        for k, v in before.items():
            assert torch.equal(c[k], v), k


@pytest.mark.parametrize("name,src_len", CASES)
def test_served_tokens_match_jax(name, src_len):
    """``make_prefill(frontend_embeds=, enc_frames=)`` and then
    ``Engine.decode`` give the JAX package's greedy tokens (its
    ``make_prefill`` and ``make_serve_step`` in a loop)."""
    jcfg, cfg, tree, params = _model(name)
    inputs = _inputs(cfg, src_len)
    jprefill = jengine.make_prefill(jcfg, cache_pad=STEPS)
    jstep = jengine.make_serve_step(jcfg)
    jlast, jcache = jprefill(tree, jnp.asarray(inputs["tokens"]),
                             **_extra(inputs, jnp.asarray))
    jtok = jnp.argmax(jlast[:, :cfg.vocab_size], -1).astype(jnp.int32)
    want = [np.asarray(jtok)]
    for _ in range(STEPS - 1):
        jtok, _, jcache = jstep(tree, jtok[:, None], jcache)
        want.append(np.asarray(jtok))
    eng = Engine(cfg, params, batch=2, prompt_len=PROMPT, max_new=STEPS,
                 device="cpu")
    with torch.no_grad():
        last, cache = make_prefill(cfg, cache_pad=STEPS)(
            params, torch.from_numpy(inputs["tokens"]),
            **_extra(inputs, torch.from_numpy))
    got = eng.decode(last, cache)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    eng.close()


@pytest.mark.parametrize("name,src_len", CASES)
def test_train_forward_matches_jax(name, src_len):
    """The differentiable forward (the encoder too in ``"train"``) within
    1e-4 of the JAX package's train mode."""
    jcfg, cfg, tree, params = _model(name)
    inputs = _inputs(cfg, src_len)
    jlogits, _, _ = jtransformer.forward(
        tree, jcfg, jnp.asarray(inputs["tokens"]), mode="train",
        **_extra(inputs, jnp.asarray))
    logits, cache, _ = transformer.forward(
        params, cfg, torch.from_numpy(inputs["tokens"]), mode="train",
        **_extra(inputs, torch.from_numpy))
    assert cache is None
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)


def _batch(cfg, src_len: int) -> dict:
    return _inputs(cfg, src_len, seed=8, batch=4, length=33)


@pytest.mark.parametrize("name,src_len", CASES)
def test_train_step_gradients_match_jax(name, src_len):
    """The loss's gradients from the same parameters and batch (with the
    patch embeddings or the source frames as batch keys) within 1e-5 of
    each leaf's largest entry, the encoder's and cross blocks' too, and
    the loss within 1e-5."""
    jcfg, cfg, tree, params = _model(name)
    batch = _batch(cfg, src_len)
    (jtotal, _), jgrads = jax.value_and_grad(
        jtrain_loop.make_loss_fn(jcfg), has_aux=True)(
            tree, jax.tree.map(jnp.asarray, batch))
    jgrads = transformer.params_from_jax(jax.tree.map(np.asarray, jgrads),
                                         cfg, device="cpu")
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    total, _ = train_loop.make_loss_fn(cfg)(live, batch)
    grads = torch.autograd.grad(total, tree_leaves(live))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5, atol=1e-5)
    for g, (path, jg) in zip(grads, tree_leaves_with_path(jgrads),
                             strict=True):
        err = float((g - jg).abs().max() / jg.abs().max().clamp(min=1e-30))
        assert err <= 1e-5, (path, err)


@pytest.mark.parametrize("name,src_len", [(PIXTRAL, 0), (SEAMLESS, 40)])
def test_train_step_matches_jax(name, src_len):
    """One AdamW step (2 microbatches) from the JAX train state: loss and
    grad norm within 1e-5, updated params as ``tests/test_torch_training
    .py`` holds them. The weight decay reads the encoder's layers as one
    stacked leaf each (``layout_ranks``), as the JAX package stores
    them."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    hp, jhp = optimizer.OptHParams(lr=1e-3), joptimizer.OptHParams(lr=1e-3)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    batch = _batch(cfg, src_len)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jnew, jm = jax.jit(jtrain_loop.make_train_step(
        jcfg, jhp, n_microbatches=2))(jstate, jbatch)
    jgrads = transformer.params_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: jtrain_loop.make_loss_fn(jcfg)(p, jbatch)[0])(
            jstate["params"])), cfg, device="cpu")
    state = _state_from_jax(jstate, cfg)
    new, m = train_loop.make_train_step(cfg, hp, n_microbatches=2)(
        state, batch)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5)
    _assert_updated_params_close(new, jnew, jgrads, 1e-5, hp, cfg)


def test_layout_names_the_encoder_stack():
    """The encoder's layers count one dim more in the JAX layout (all of
    them stacked in one cycle), and their leaves form one group each."""
    cfg = get_config(SEAMLESS).reduced()
    params = transformer.init_lm(cfg, device="cpu")
    ranks = train_loop.layout_ranks(params, cfg)
    groups = train_loop.layout_groups(params, cfg)
    for i in range(cfg.encoder_layers):
        assert ranks["encoder"]["layers"][i]["ln1"] == 2
        assert groups["encoder"]["layers"][i]["attn"]["wq"] == (
            "encoder", "attn", "wq")
    assert ranks["encoder"]["final_norm"] == 1
    assert groups["encoder"]["final_norm"] is None
    assert ranks["layers"][0]["cross"]["wq"] == 3


@pytest.mark.parametrize("src_len", [0, 7])
def test_init_decode_cache_matches_jax(src_len):
    jcfg, cfg = (jax_get_config(SEAMLESS).reduced(),
                 get_config(SEAMLESS).reduced())
    jcache = jtransformer.init_decode_cache(jcfg, 2, 16, src_len)
    cache = transformer.init_decode_cache(cfg, 2, 16, src_len, device="cpu")
    want = _port_cache(jcache, cfg)
    assert cache["pos"] == int(jcache["pos"])
    for c, w in zip(cache["layers"], want, strict=True):
        assert {k: tuple(v.shape) for k, v in c.items()} == \
            {k: v.shape for k, v in w.items()}
        assert all(not v.any() for v in c.values())


def test_embed_raises_where_the_embeddings_do_not_fit():
    """P > S: the JAX package's ``dynamic_update_slice`` refuses it, and so
    does the port; P <= S replaces the first P positions."""
    _, cfg, _, params = _model(PIXTRAL)
    toks = torch.zeros((1, 6), dtype=torch.int32)
    fe = torch.randn((1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="do not fit"):
        transformer._embed(params, cfg, toks, fe)
    x = transformer._embed(params, cfg, torch.zeros((1, 10), dtype=torch.int32),
                           fe)
    assert torch.equal(x[:, :8], fe)
    assert torch.equal(x[:, 8:], transformer._embed(params, cfg, toks)[:, :2])


@pytest.mark.parametrize("sq,skv", [(24, 16), (24, 40)])
def test_chunked_attention_takes_the_cross_call(sq, skv):
    """The JAX package's cross-attention call (non-causal, Sq != Skv,
    ``q_offset=0``, its own chunks) through the prefill's kernel path and
    the train mode's plain loop, within 1e-4 of the JAX function; with a
    causal or window mask a wrong offset still raises."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, 4, 32), dtype=np.float32)
    k, v = (rng.standard_normal((2, skv, 4, 32), dtype=np.float32)
            for _ in range(2))
    kw = dict(causal=False, q_chunk=min(512, sq), kv_chunk=min(512, skv))
    want = np.asarray(jattention.chunked_attention(
        *map(jnp.asarray, (q, k, v)), **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fn in (attention.chunked_attention,
               attention.chunked_softmax_attention):
        np.testing.assert_allclose(_np(fn(tq, tk, tv, **kw)), want, **TOL)
    for mask in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="q_offset"):
            attention.chunked_attention(tq, tk, tv, q_offset=0, **mask)
