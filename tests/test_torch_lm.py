"""Port parity for the LM slice: configs, model components and the dense
decoder of ``repro_torch`` against ``repro`` on the CPU.

Inputs come from seeded numpy generators and go to both packages; the
port's parameters are the JAX package's ``init_lm`` tree carried over by
``params_from_jax``. Everything runs in f32 (the reduced configs' dtype)
with rtol = atol = 1e-4: the two packages sum matmuls and the flash
kernel's plain version sums the softmax in other orders than XLA's chunked
attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_NAMES, get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash.flash import flash_attention
from repro_torch.models import attention, common, mlp, transformer

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma2-2b", "stablelm-1.6b"]
# longer than the reduced window of 32, so Gemma's local layers mask the
# window in prefill and their caches take the ring layout
PROMPT, PAD, STEPS = 48, 4, 3


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(name, reduced):
    ours, theirs = get_config(name), jax_get_config(name)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.vocab_padded == theirs.vocab_padded
    assert ours.torch_dtype == getattr(torch, str(theirs.jnp_dtype))
    assert [ours.layer_kind(i) for i in range(ours.n_layers)] == \
        [theirs.layer_kind(i) for i in range(theirs.n_layers)]


def test_registry():
    """Every config of the JAX package is registered (Pixtral and Seamless
    came with part c of slice 10); an unknown name raises."""
    assert list_configs() == sorted(ARCHS + [
        "moonshot-v1-16b-a3b", "granite-8b", "h2o-danube-3-4b",
        "llama4-maverick-400b-a17b", "recurrentgemma-9b", "rwkv6-7b",
        "pixtral-12b", "seamless-m4t-medium"])
    assert list_configs() == jax_list_configs()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba-3b")


def test_arch_names_match_jax():
    """``configs.ARCH_NAMES`` is the JAX package's list, and the dry run
    reads it from there."""
    from repro_torch.launch import dryrun

    assert ARCH_NAMES == JAX_ARCH_NAMES == list_configs()
    assert dryrun.ARCH_NAMES is ARCH_NAMES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    """f32 inside, the input's dtype out, eps 1e-6: within 1e-6 of the JAX
    function in f32; in bf16 the same rounding of the same f32 result."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcommon.layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                              jnp.asarray(bias))
    got = common.layer_norm(torch.from_numpy(x).to(dtype),
                            torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        common.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), eps=1e-3).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), eps=1e-3)),
        rtol=1e-6, atol=1e-6)


def test_rms_norm_and_softcap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for cap in (None, 30.0):
        np.testing.assert_allclose(
            common.softcap(torch.from_numpy(x) * 20, cap).numpy(),
            np.asarray(jcommon.softcap(jnp.asarray(x) * 20, cap)), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40)[None] + 7, (2, 40)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(act):
    params = jax.tree.map(np.array, jmlp.init_mlp(
        jax.random.PRNGKey(2), 64, 128, act, jnp.float32))
    x = np.random.default_rng(2).normal(size=(2, 7, 64)).astype(np.float32)
    want = jmlp.apply_mlp(params, jnp.asarray(x), act)
    got = mlp.apply_mlp({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ring,t,window,cap", [
    (False, 20, None, None), (False, 33, None, 50.0), (True, 45, 32, 50.0),
    (True, 12, 32, None)])
def test_decode_attention_matches_jax(ring, t, window, cap):
    rng = np.random.default_rng(t)
    sbuf = 32 if ring else 40
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, sbuf, 2, 32)).astype(np.float32)
              for _ in range(2))
    kw = dict(ring=ring, window=window, logit_cap=cap)
    want = jattn.decode_attention(*map(jnp.asarray, (q, ck, cv)), t, **kw)
    got = attention.decode_attention(*map(torch.from_numpy, (q, ck, cv)), t,
                                     **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ring,t", [(True, 37), (False, 5)])
def test_cache_update_decode_matches_jax(ring, t):
    rng = np.random.default_rng(3)
    ck, cv = (rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
              for _ in range(2))
    want = jattn.cache_update_decode(*map(jnp.asarray, (ck, cv, kn, vn)), t,
                                     ring)
    got = attention.cache_update_decode(
        *map(torch.from_numpy, (ck.copy(), cv.copy(), kn, vn)), t, ring)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(IndexError):
        attention.cache_update_decode(*map(torch.from_numpy, (ck, cv, kn, vn)),
                                      32, False)


def test_init_kv_cache_matches_jax():
    want = jattn.init_kv_cache(3, 2, 32, 4, 16, jnp.bfloat16)
    got = attention.init_kv_cache(3, 2, 32, 4, 16, torch.bfloat16,
                                  device="cpu")
    assert got.buf_len == want.buf_len == 32
    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        assert not a.any()


def test_chunked_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 64, 2, 32)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=24, logit_cap=50.0)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), q_chunk=16,
                                   kv_chunk=16, **kw)
    got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="q_offset"):
        attention.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                    q_offset=3)
    with pytest.raises(ValueError, match="acc_dtype"):
        attention.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                    acc_dtype="bfloat16")


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


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    name = request.param
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    tree = jax.tree.map(np.asarray, jtransformer.init_lm(
        jax.random.PRNGKey(0), jcfg))
    params = transformer.params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return jcfg, cfg, tree, params, toks


def test_prefill_and_decode_match_jax(lm):
    jcfg, cfg, tree, params, toks = lm
    jlogits, jcache, _ = jtransformer.forward(
        tree, jcfg, jnp.asarray(toks), mode="prefill", cache_pad=PAD)
    launches = flash_attention.launches
    with torch.no_grad():
        logits, cache, aux = transformer.forward(
            params, cfg, torch.from_numpy(toks), mode="prefill",
            cache_pad=PAD)
    assert flash_attention.launches == launches  # CPU: the plain version
    assert aux == {} and cache["pos"] == PROMPT == int(jcache["pos"])
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    want_caches = _jax_layer_caches(jcache, cfg)
    assert len(cache["layers"]) == len(want_caches) == cfg.n_layers
    for c, (wk, wv) in zip(cache["layers"], want_caches):
        assert tuple(c["k"].shape) == wk.shape
        np.testing.assert_allclose(_np(c["k"]), wk, **TOL)
        np.testing.assert_allclose(_np(c["v"]), wv, **TOL)
    if cfg.name == "gemma2-2b":  # the local layers hold the window's ring
        assert cache["layers"][0]["k"].shape[1] == cfg.window
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
    assert cache["pos"] == PROMPT + STEPS
    for c, (wk, wv) in zip(cache["layers"], _jax_layer_caches(jcache, cfg)):
        np.testing.assert_allclose(_np(c["k"]), wk, **TOL)
        np.testing.assert_allclose(_np(c["v"]), wv, **TOL)


def test_train_forward_matches_jax_and_last_only(lm):
    jcfg, cfg, tree, params, toks = lm
    want, _, _ = jtransformer.forward(tree, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, cache, _ = transformer.forward(params, cfg,
                                            torch.from_numpy(toks),
                                            mode="train")
        last, _, _ = transformer.forward(params, cfg, torch.from_numpy(toks),
                                         mode="train", last_only=True)
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(last), _np(got)[:, -1:], **TOL)


def test_init_decode_cache_matches_jax_shapes(lm):
    jcfg, cfg, *_ = lm
    want = _jax_layer_caches(jtransformer.init_decode_cache(jcfg, 2, 40), cfg)
    got = transformer.init_decode_cache(cfg, 2, 40, device="cpu")
    assert got["pos"] == 40
    for c, (wk, _) in zip(got["layers"], want, strict=True):
        assert tuple(c["k"].shape) == wk.shape and not c["k"].any()


def test_init_lm_is_seeded_and_shaped_like_jax():
    cfg = get_config("stablelm-1.6b").reduced()
    a = transformer.init_lm(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    b = transformer.init_lm(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    tree = jtransformer.init_lm(jax.random.PRNGKey(0), jax_get_config(
        "stablelm-1.6b").reduced())
    want = transformer.params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                       device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, x), (_, y), (pw, w) in zip(flat(a), flat(b), flat(want),
                                        strict=True):
        assert pa == pw and x.shape == w.shape and x.dtype == w.dtype
        assert torch.equal(x, y)


@pytest.mark.parametrize("change,error,match", [
    (dict(encoder_layers=2), ValueError, "enc_frames"),
    (dict(frontend="vision"), ValueError, "do not fit"),
    (dict(attn_pattern=("mamba",)), ValueError, "mamba")])
def test_layers_of_later_slices_raise(change, error, match):
    """Encoder-decoder and vision configs are served now
    (``tests/test_torch_vlm_encdec.py``) and refuse what the JAX package
    refuses: an encoder-decoder forward without source frames, more patch
    embeddings than positions. A layer kind that no slice ports is
    refused at init, so none falls through to another kind's layer."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(), **change)
    assert isinstance(cfg, ModelConfig)
    with pytest.raises(error, match=match):
        params = transformer.init_lm(cfg, device="cpu")
        fe = torch.zeros((1, 5, cfg.d_model))
        transformer.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                            mode="prefill", frontend_embeds=fe)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.params_from_jax({}, cfg)


def test_rope_table_holds_rope_frequencies():
    """The table is ``rope_frequencies`` as it was computed per call, kept
    under (head_dim, theta, device)."""
    common.rope_table.cache_clear()
    cpu = torch.device("cpu")
    for d, theta in ((64, 1e4), (128, 5e4), (64, 5e4)):
        got = common.rope_table(d, theta, cpu)
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.from_numpy(
            common.rope_frequencies(d, theta)))
        assert common.rope_table(d, theta, cpu) is got
    assert common.rope_table.cache_info().currsize == 3


def test_f32_forward_does_not_depend_on_an_earlier_bf16_one():
    """In one process, a bf16 reduced-Gemma forward followed by an f32 one
    gives the same f32 logits, bit for bit, as the f32 forward on a
    cleared rope table."""
    cfg = get_config("gemma2-2b").reduced()
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)))
    params = transformer.init_lm(cfg, device="cpu")
    params16 = transformer.init_lm(cfg16, device="cpu")
    with torch.inference_mode():
        common.rope_table.cache_clear()
        want = transformer.forward(params, cfg, toks, mode="prefill")[0]
        common.rope_table.cache_clear()
        transformer.forward(params16, cfg16, toks, mode="prefill")
        got = transformer.forward(params, cfg, toks, mode="prefill")[0]
    assert torch.equal(got, want)
