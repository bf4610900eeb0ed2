"""Port parity for the recurrent layers: ``repro_torch.models.rglru`` (the
RG-LRU block of RecurrentGemma), ``repro_torch.models.rwkv6`` (the RWKV-6
time mix) and the RWKV channel mix of ``models.mlp`` against the JAX
package's on the CPU.

Inputs come from seeded numpy generators and parameters from the JAX
package's initializers, in f32. Where a scan runs (``rglru_scan`` and the
blocks around it, ``chunked_wkv`` and the time mix around it) the port's
log-depth scan and chunk loop associate their f32 sums in another order
than XLA's ``associative_scan`` and ``lax.scan``: there the largest error
is held within 1e-5 of the largest output, max(|want|, 1) (``_close``).
Elsewhere every element is held within rtol = atol = 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch.models import mlp, rglru, rwkv6

SCAN_TOL = 1e-5
TOL = dict(rtol=1e-6, atol=1e-6)
D, R, WIDTH = 32, 24, 4
H, HD = 3, 8   # RWKV heads of 8 over d = 32 (H * HD = 24)


def _np(x):
    return x.detach().float().numpy()


def _close(got, want, tol=SCAN_TOL):
    """max |got - want| <= tol * max(max |want|, 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, err


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def rg():
    return jax.tree.map(np.asarray, jrglru.init_rglru_block(
        jax.random.PRNGKey(0), D, R, WIDTH, jnp.float32))


@pytest.fixture(scope="module")
def tm():
    p = jax.tree.map(np.array, jrwkv.init_time_mix(
        jax.random.PRNGKey(1), D, H, HD, jnp.float32, lora_rank=16))
    rng = np.random.default_rng(1)
    # non-zero mixes and bonus, so every term of the time mix is live
    p["mu"] = rng.uniform(0, 1, p["mu"].shape).astype(np.float32)
    p["u"] = rng.normal(size=p["u"].shape).astype(np.float32) * 0.5
    p["ln_x_scale"] = rng.uniform(0.5, 1.5, p["ln_x_scale"].shape).astype(
        np.float32)
    return p


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def test_rglru_init_shapes_and_dtypes_match_jax(rg):
    got = rglru.init_rglru_block(torch.Generator().manual_seed(0), D, R,
                                 WIDTH, torch.bfloat16, torch.device("cpu"))
    want = jrglru.init_rglru_block(jax.random.PRNGKey(0), D, R, WIDTH,
                                   jnp.bfloat16)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    np.testing.assert_allclose(_np(got["lam"]), np.asarray(want["lam"]),
                               **TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_jax(rg, with_state):
    x = _x(2, 2, 9, R)
    st = _x(3, 2, WIDTH - 1, R) if with_state else None
    want, wst = jrglru._causal_conv(jnp.asarray(x), rg["conv_w"],
                                    rg["conv_b"] + 0.1,
                                    None if st is None else jnp.asarray(st))
    got, gst = rglru._causal_conv(
        torch.from_numpy(x), torch.from_numpy(rg["conv_w"]),
        torch.from_numpy(rg["conv_b"] + 0.1),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gst), np.asarray(wst), **TOL)


@pytest.mark.parametrize("t", [1, 7, 64, 300])
def test_rglru_scan_matches_jax(rg, t):
    x, h0 = _x(t, 2, t, R), _x(t + 1, 2, R)
    want, wlast = jrglru.rglru_scan(rg, jnp.asarray(x), jnp.asarray(h0))
    got, glast = rglru.rglru_scan(_t(rg), torch.from_numpy(x),
                                  torch.from_numpy(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, t, R)
    _close(_np(got), np.asarray(want))
    _close(_np(glast), np.asarray(wlast))


def test_rglru_scan_gradients_match_jax(rg):
    """The log-depth scan under autograd: gradients of a weighted sum with
    respect to the input, the carried-in state and the gates' weights."""
    x, h0, co = _x(4, 2, 37, R), _x(5, 2, R), _x(6, 2, 37, R)

    def jloss(x, h0, w_a):
        y, _ = jrglru.rglru_scan(dict(rg, w_a=w_a), x, h0)
        return jnp.sum(y * co)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(h0),
                                            jnp.asarray(rg["w_a"]))
    p = _t(rg)
    xs = [torch.from_numpy(a).requires_grad_()
          for a in (x, h0, rg["w_a"].copy())]
    y, _ = rglru.rglru_scan(dict(p, w_a=xs[2]), xs[0], xs[1])
    (y * torch.from_numpy(co)).sum().backward()
    for a, b in zip(xs, jg, strict=True):
        _close(a.grad.numpy(), np.asarray(b))


def test_rglru_step_matches_jax(rg):
    x, h = _x(7, 2, R), _x(8, 2, R)
    want, _ = jrglru.rglru_step(rg, jnp.asarray(x), jnp.asarray(h))
    got, again = rglru.rglru_step(_t(rg), torch.from_numpy(x),
                                  torch.from_numpy(h))
    assert again is got
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rglru_blocks_match_jax(rg):
    """The block over a prompt, then one decode step from its state."""
    x = _x(9, 2, 21, D)
    st = {"h": _x(10, 2, R), "conv": _x(11, 2, WIDTH - 1, R)}
    want, wst = jrglru.apply_rglru_block(rg, jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, st))
    got, gst = rglru.apply_rglru_block(_t(rg), torch.from_numpy(x), _t(st))
    _close(_np(got), np.asarray(want))
    for k in ("h", "conv"):
        _close(_np(gst[k]), np.asarray(wst[k]))
    x1 = _x(12, 2, 1, D)
    st1 = {k: np.asarray(v) for k, v in wst.items()}
    want, wst = jrglru.apply_rglru_block_decode(
        rg, jnp.asarray(x1), jax.tree.map(jnp.asarray, st1))
    got, gst = rglru.apply_rglru_block_decode(_t(rg), torch.from_numpy(x1),
                                              _t(st1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(gst[k]), np.asarray(wst[k]), **TOL)


def test_time_mix_init_shapes_and_dtypes_match_jax():
    got = rwkv6.init_time_mix(torch.Generator().manual_seed(0), D, H, HD,
                              torch.bfloat16, torch.device("cpu"))
    want = jrwkv.init_time_mix(jax.random.PRNGKey(0), D, H, HD, jnp.bfloat16)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    for k in ("mu", "w0", "u", "ln_x_scale", "ln_x_bias"):
        np.testing.assert_array_equal(_np(got[k]),
                                      np.asarray(want[k], np.float32))


def test_group_norm_heads_matches_jax(tm):
    x = _x(13, 2, 5, H * HD, scale=3.0)
    want = jrwkv._group_norm_heads(jnp.asarray(x), tm["ln_x_scale"],
                                   tm["ln_x_bias"] + 0.2, H)
    got = rwkv6._group_norm_heads(torch.from_numpy(x),
                                  torch.from_numpy(tm["ln_x_scale"]),
                                  torch.from_numpy(tm["ln_x_bias"] + 0.2), H)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _wkv_inputs(seed, t):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(2, t, H, HD)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(2, t, H, HD)) - 1.0).astype(np.float32)
    u = rng.normal(size=(H, HD)).astype(np.float32) * 0.5
    s0 = rng.normal(size=(2, H, HD, HD)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("t,chunk", [(48, 16), (64, 64), (40, 8)])
def test_chunked_wkv_matches_jax(t, chunk):
    """Several chunks from a non-zero state (and one chunk)."""
    args = _wkv_inputs(t + chunk, t)
    want, wst = jrwkv.chunked_wkv(*map(jnp.asarray, args), chunk)
    got, gst = rwkv6.chunked_wkv(*map(torch.from_numpy, args), chunk)
    _close(_np(got), np.asarray(want))
    _close(_np(gst), np.asarray(wst))


def test_chunked_wkv_gradients_match_jax():
    args = _wkv_inputs(14, 32)
    co = _x(15, 2, 32, H, HD)

    def jloss(r, k, v, logw, u, s0):
        o, s = jrwkv.chunked_wkv(r, k, v, logw, u, s0, 8)
        return jnp.sum(o * co) + jnp.sum(s)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    o, s = rwkv6.chunked_wkv(*xs, 8)
    ((o * torch.from_numpy(co)).sum() + s.sum()).backward()
    for a, b in zip(xs, jg, strict=True):
        _close(a.grad.numpy(), np.asarray(b))


def test_chunked_wkv_refuses_a_ragged_chunk():
    args = _wkv_inputs(16, 40)
    with pytest.raises(ValueError, match="does not divide"):
        rwkv6.chunked_wkv(*map(torch.from_numpy, args), 16)


def test_wkv_decode_step_matches_jax():
    r, k, v, logw, u, s0 = _wkv_inputs(17, 1)
    one = [x[:, 0] for x in (r, k, v, logw)]
    want, wst = jrwkv.wkv_decode_step(*map(jnp.asarray, one + [u, s0]))
    got, gst = rwkv6.wkv_decode_step(*map(torch.from_numpy, one + [u, s0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gst), np.asarray(wst), **TOL)


def test_time_mix_and_its_decode_match_jax(tm):
    """The time mix over a prompt of three chunks from a non-zero state,
    then one decode step from what it returns."""
    x, x_prev = _x(18, 2, 48, D), _x(19, 2, D)
    s0 = _x(20, 2, H, HD, HD)
    want, (wlast, wst) = jrwkv.apply_time_mix(
        tm, jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(s0), n_heads=H,
        chunk=16)
    got, (glast, gst) = rwkv6.apply_time_mix(
        _t(tm), torch.from_numpy(x), torch.from_numpy(x_prev),
        torch.from_numpy(s0), n_heads=H, chunk=16)
    _close(_np(got), np.asarray(want))
    np.testing.assert_allclose(_np(glast), np.asarray(wlast), **TOL)
    _close(_np(gst), np.asarray(wst))
    x1 = _x(21, 2, 1, D)
    s1 = np.asarray(wst)
    want, (wx, wst) = jrwkv.apply_time_mix_decode(
        tm, jnp.asarray(x1), jnp.asarray(np.asarray(wlast)), jnp.asarray(s1),
        n_heads=H)
    got, (gx, gst) = rwkv6.apply_time_mix_decode(
        _t(tm), torch.from_numpy(x1), torch.from_numpy(np.asarray(wlast)),
        torch.from_numpy(s1), n_heads=H)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gx), np.asarray(wx), **TOL)
    np.testing.assert_allclose(_np(gst), np.asarray(wst), **TOL)


def test_rwkv_channel_mix_matches_jax():
    p = jax.tree.map(np.array, jmlp.init_mlp(jax.random.PRNGKey(3), D, 64,
                                             "rwkv_cm", jnp.float32))
    rng = np.random.default_rng(22)
    for k in ("mu_k", "mu_r"):
        p[k] = rng.uniform(0, 1, p[k].shape).astype(np.float32)
    x = _x(23, 2, 6, D)
    x_prev = np.concatenate([_x(24, 2, 1, D), x[:, :-1]], axis=1)
    want = jmlp.apply_rwkv_channel_mix(p, jnp.asarray(x), jnp.asarray(x_prev))
    got = mlp.apply_rwkv_channel_mix(_t(p), torch.from_numpy(x),
                                     torch.from_numpy(x_prev))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    ours = mlp.init_mlp(torch.Generator().manual_seed(0), D, 64, "rwkv_cm",
                        torch.float32, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in p.items()}
