"""Port parity for LM training: the optimizers, EF-int8 gradients,
``lm_loss``, the train-mode forward, the microbatched train step and the
checkpoints of ``repro_torch.training`` against ``repro.training`` on the
CPU.

Inputs come from seeded numpy generators and go to both packages; LM
parameters are the JAX package's ``init_lm`` tree carried over by
``params_from_jax``. Tolerances are stated at each test: the optimizers'
elementwise f32 math 1e-6; a train step 1e-5 (dense) and 1e-4 (MoE, as
its forward parity), the order of f32 sums in the two packages' matmuls
and reductions.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.training import checkpoint as jcheckpoint
from repro.training import grad_compress as jgrad_compress
from repro.training import optimizer as joptimizer
from repro.training import train_loop as jtrain_loop
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm
from repro_torch.models import attention, moe, transformer
from repro_torch.training import checkpoint, grad_compress, optimizer, train_loop
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path, tree_map

OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, want, **tol):
    """``got`` (a port tree) against ``want`` (the JAX tree of the same
    paths), leaf by leaf."""
    flat = dict(tree_leaves_with_path(got))
    jflat = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
             for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat) == set(jflat)
    for path, leaf in flat.items():
        np.testing.assert_allclose(_np(leaf), np.asarray(jflat[path],
                                                         np.float32),
                                   err_msg=str(path), **tol)


def _opt_trees(seed: int, shapes: dict):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.01, 3.0)]
    return params, grads  # the second step's grads are clipped


# a matrix and a stacked (E, d, f) leaf the weight decay reaches, and a
# vector it does not
ADAMW_SHAPES = {"w": (48, 40), "experts": (3, 16, 24), "bias": (40,)}
# factored: both of the last two dims >= 128 (also stacked); not factored:
# one dim short of it, and a vector
ADAFACTOR_SHAPES = {"big": (160, 128), "stack": (2, 130, 136),
                    "narrow": (64, 200), "vec": (136,)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    params, grads = _opt_trees(0, ADAMW_SHAPES)
    jhp = joptimizer.OptHParams(lr=1e-2, moment_dtype=getattr(jnp,
                                                              moment_dtype))
    hp = optimizer.OptHParams(lr=1e-2, moment_dtype=getattr(torch,
                                                            moment_dtype))
    jp, js = params, joptimizer.adamw_init(params, jhp)
    p, s = _torch_tree(params), optimizer.adamw_init(_torch_tree(params), hp)
    assert all(x.dtype == hp.moment_dtype for x in tree_leaves(s))
    for step, g in enumerate(grads):
        jp, js, jm = joptimizer.adamw_update(jp, g, js, jnp.int32(step), jhp)
        p, s, m = optimizer.adamw_update(p, _torch_tree(g), s,
                                         torch.tensor(step, dtype=torch.int32),
                                         hp)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), **OPT_TOL)
        _assert_trees_close(p, jp, **OPT_TOL)
        _assert_trees_close(s, js, **OPT_TOL)
    assert float(m["grad_norm"]) > hp.grad_clip  # the clip was exercised


def test_adafactor_update_matches_jax():
    params, grads = _opt_trees(1, ADAFACTOR_SHAPES)
    jhp, hp = joptimizer.OptHParams(lr=1e-2), optimizer.OptHParams(lr=1e-2)
    jp, js = params, joptimizer.adafactor_init(params, jhp)
    p, s = _torch_tree(params), optimizer.adafactor_init(_torch_tree(params),
                                                         hp)
    assert set(s["v"]["big"]) == set(s["v"]["stack"]) == {"vr", "vc"}
    assert set(s["v"]["narrow"]) == set(s["v"]["vec"]) == {"v"}
    for step, g in enumerate(grads):
        jp, js, jm = joptimizer.adafactor_update(jp, g, js, jnp.int32(step),
                                                 jhp)
        p, s, m = optimizer.adafactor_update(p, _torch_tree(g), s, step, hp)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), **OPT_TOL)
        _assert_trees_close(p, jp, **OPT_TOL)
        _assert_trees_close(s, js, **OPT_TOL)


def test_adafactor_clips_over_a_stacked_group_as_jax():
    """Three layers that the JAX package stacks into one (3, 130, 136) leaf,
    with update RMS that differ per layer (layer 1's gradient has spikes,
    so its clip is active): with ``groups`` naming them one stack the
    port's update equals the JAX update of the stacked leaf within 1e-6;
    clipped per layer (no groups) it does not."""
    rng = np.random.default_rng(12)
    stack = rng.normal(size=(3, 130, 136)).astype(np.float32)
    g = rng.normal(size=(3, 130, 136)).astype(np.float32) * 0.01
    g[1, ::13, ::17] *= 300.0
    g[2] *= 0.1
    vec = rng.normal(size=(136,)).astype(np.float32)
    gvec = rng.normal(size=(136,)).astype(np.float32) * 0.01
    jhp, hp = joptimizer.OptHParams(lr=1e-2), optimizer.OptHParams(lr=1e-2)
    jparams = {"stack": stack, "vec": vec}
    jnew, _, _ = joptimizer.adafactor_update(
        jparams, {"stack": g, "vec": gvec},
        joptimizer.adafactor_init(jparams, jhp), jnp.int32(0), jhp)

    def port(x):
        return {"layers": [{"w": torch.from_numpy(x[i].copy())}
                           for i in range(3)]}

    params = dict(port(stack), vec=torch.from_numpy(vec))
    grads = dict(port(g), vec=torch.from_numpy(gvec))
    groups = {"layers": [{"w": ("cycle", 0, "w")}] * 3, "vec": None}
    ranks = {"layers": [{"w": 3}] * 3, "vec": 1}
    state = optimizer.adafactor_init(params, hp)
    us = []
    for grp in (groups, None):
        new, _, _ = optimizer.adafactor_update(params, grads, state, 0, hp,
                                               ranks, grp)
        us.append(np.stack([_np(lp["w"]) for lp in new["layers"]]))
        np.testing.assert_allclose(_np(new["vec"]), np.asarray(jnew["vec"]),
                                   **OPT_TOL)
    np.testing.assert_allclose(us[0], np.asarray(jnew["stack"]), **OPT_TOL)
    assert np.abs(us[1] - np.asarray(jnew["stack"])).max() > 1e-4


def test_layout_groups_name_the_stacked_layers():
    """RecurrentGemma's pattern at 8 layers: 2 cycles of 3 stacked by cycle
    position, 2 layers after them alone, like everything outside the
    layers."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              n_layers=8)
    params = transformer.init_lm(cfg, device="cpu")
    groups = train_loop.layout_groups(params, cfg)
    assert groups["embed"] is None and groups["final_norm"] is None
    for i, lg in enumerate(groups["layers"]):
        keys = {k for _, k in tree_leaves_with_path(lg)}
        if i < 6:
            assert {k[:2] for k in keys} == {("cycle", i % 3)}
            assert groups["layers"][i % 3] == lg
        else:
            assert keys == {None}


def test_microbatch_split_refuses_what_jax_refuses():
    """A batch of 3 rows in 2 microbatches: the JAX step's reshape fails,
    and the port's step raises (it used to train on 2 of the rows)."""
    name = "stablelm-1.6b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    hp, jhp = optimizer.OptHParams(lr=1e-3), joptimizer.OptHParams(lr=1e-3)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    with pytest.raises(TypeError, match="reshape"):
        jtrain_loop.make_train_step(jcfg, jhp, n_microbatches=2)(
            jstate, {"tokens": jnp.asarray(toks)})
    state = train_loop.init_train_state(cfg, hp, device="cpu")
    step = train_loop.make_train_step(cfg, hp, n_microbatches=2)
    with pytest.raises(ValueError, match="3 rows"):
        step(state, {"tokens": toks})


def test_clip_by_global_norm_and_make_optimizer_match_jax():
    _, (g, big) = _opt_trees(2, ADAMW_SHAPES)
    for tree in (g, big):
        want, jgn = joptimizer.clip_by_global_norm(tree, 1.0)
        got, gn = optimizer.clip_by_global_norm(_torch_tree(tree), 1.0)
        np.testing.assert_allclose(_np(gn), np.asarray(jgn), **OPT_TOL)
        _assert_trees_close(got, want, **OPT_TOL)
    hp = optimizer.OptHParams()
    assert optimizer.make_optimizer("adamw", hp) == (
        optimizer.adamw_init, optimizer.adamw_update)
    assert optimizer.make_optimizer("adafactor", hp)[1] is \
        optimizer.adafactor_update
    with pytest.raises(ValueError):
        optimizer.make_optimizer("sgd", hp)


def test_compress_decompress_equals_jax_bit_for_bit():
    """Three rounds of the EF-int8 round trip on leaves of ragged sizes
    (a last block short of 256, a block of zeros): the same bits in the
    gradients and the error state, and the same wire ratio."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(1000,)).astype(np.float32),
         "b": (rng.normal(size=(37, 29)) * 1e-3).astype(np.float32),
         "z": np.zeros((300,), np.float32)}
    je, e = jgrad_compress.init_error_state(g), grad_compress.init_error_state(
        _torch_tree(g))
    for _ in range(3):
        jout, je = jgrad_compress.compress_decompress(g, je)
        out, e = grad_compress.compress_decompress(_torch_tree(g), e)
        for tree, jtree in ((out, jout), (e, je)):
            for k in g:
                assert tree[k].dtype == torch.float32
                assert tree[k].numpy().tobytes() == \
                    np.asarray(jtree[k]).tobytes(), k
    q, s = grad_compress._quantize_int8(torch.from_numpy(g["a"]))
    jq, js = jgrad_compress._quantize_int8(jnp.asarray(g["a"]))
    assert q.dtype == torch.int8 and q.numpy().tobytes() == \
        np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    for nbytes in (2, 4):
        assert grad_compress.compression_ratio(_torch_tree(g), nbytes) == \
            jgrad_compress.compression_ratio(g, nbytes)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_lm_loss_matches_jax(masked):
    cfg, jcfg = get_config("stablelm-1.6b").reduced(), \
        jax_get_config("stablelm-1.6b").reduced()
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 9, cfg.vocab_padded)) * 4).astype(np.float32)
    logits[..., cfg.vocab_size:] = -1e30
    targets = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6) if masked else None
    want = jtransformer.lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                                jcfg, None if mask is None
                                else jnp.asarray(mask))
    got = transformer.lm_loss(torch.from_numpy(logits),
                              torch.from_numpy(targets), cfg, mask)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    # the gradient too (what the train step differentiates)
    jg = jax.grad(lambda x: jtransformer.lm_loss(
        x, jnp.asarray(targets), jcfg,
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    transformer.lm_loss(x, torch.from_numpy(targets), cfg, mask).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, logit_cap=None, sq=64, chunk=16),
    dict(causal=True, window=50, logit_cap=50.0, sq=64, chunk=16),
    dict(causal=True, window=8, logit_cap=None, sq=96, chunk=32),
    dict(causal=False, window=None, logit_cap=30.0, sq=48, chunk=16)],
    ids=["causal", "window_softcap", "local_span", "bidirectional"])
def test_chunked_softmax_attention_matches_jax(kw):
    """The train mode's attention against the JAX model's chunked online
    softmax, value and gradients (GQA groups of 2), at the JAX function's
    chunks: the scan over kv chunks, and the local span of a window that
    leaves most of the sequence out."""
    sq, chunk = kw.pop("sq"), kw.pop("chunk")
    rng = np.random.default_rng(sq + chunk)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sq, 2, 32)).astype(np.float32)
            for _ in range(2))
    co = rng.normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, q_chunk=chunk, kv_chunk=chunk,
                                    **kw)
        return jnp.sum(o * co), o

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = attention.chunked_softmax_attention(*xs, q_chunk=chunk,
                                              kv_chunk=chunk, **kw)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for x, jg in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def _state_from_jax(jstate, cfg):
    """The JAX train state (params, opt, step) in the port's layout."""
    params = transformer.params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    opt = {k: transformer.params_from_jax(jax.tree.map(np.asarray, v), cfg,
                                          device="cpu")
           for k, v in jstate["opt"].items()}
    return {"params": params, "opt": opt,
            "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}


def _jax_params_in_port_layout(jparams, cfg):
    return transformer.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")


@pytest.fixture(scope="module")
def dense():
    name = "stablelm-1.6b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    hp, jhp = optimizer.OptHParams(lr=1e-3), joptimizer.OptHParams(lr=1e-3)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 33)).astype(np.int32)}
    return jcfg, cfg, jhp, hp, jstate, batch


# Adam's first step moves each param by lr * g / (|g| + eps): a gradient
# of a few eps (1e-8), which f32 sums in another order change by a few
# percent, moves its param by a few percent of lr. Elements whose gradient
# is below ADAM_TINY_GRAD are held not to the 1e-5 of updated params but
# to the step each side's own moments give them: the two updated params
# must differ by lr * (u_jax - u_port), u = (m / c1) / (sqrt(v / c2) + eps),
# within the same tolerance. So a step of the wrong size or sign fails. The
# first moments (the step's clipped gradients times 1 - b1) agree within
# the tolerance of each leaf's largest entry, and few elements are excused.
ADAM_TINY_GRAD = 1e-6


def _assert_updated_params_close(new, jnew, grads, tol, hp, cfg):
    """``new`` (the port's state after one AdamW step from step 0) against
    ``jnew`` (the JAX one); ``grads`` are the JAX gradients in the port's
    layout, which pick the excused elements."""
    jparams, jm, jv = (_jax_params_in_port_layout(t, cfg) for t in (
        jnew["params"], jnew["opt"]["m"], jnew["opt"]["v"]))
    c1, c2 = 1.0 - hp.b1, 1.0 - hp.b2   # bias corrections at step + 1 = 1

    def step(m, v):
        m, v = m.double(), v.double()
        return (m / c1) / ((v / c2).sqrt() + hp.eps)

    tiny = total = 0
    for (path, a), b, g, m, m_j, v, v_j in zip(
            tree_leaves_with_path(new["params"]), tree_leaves(jparams),
            tree_leaves(grads), tree_leaves(new["opt"]["m"]), tree_leaves(jm),
            tree_leaves(new["opt"]["v"]), tree_leaves(jv), strict=True):
        err = float((m - m_j).abs().max() / m_j.abs().max().clamp(min=1e-30))
        assert err <= tol, (path, "first moment", err)
        off = (a - b).abs() > tol + tol * b.abs()
        assert bool((g[off].abs() < ADAM_TINY_GRAD).all()), path
        moved = hp.lr * (step(m_j, v_j) - step(m, v))
        miss = ((a - b).double() - moved)[off].abs()
        assert bool((miss <= tol + tol * b[off].abs()).all()), (path, miss)
        tiny, total = tiny + int(off.sum()), total + a.numel()
    assert tiny <= 1e-4 * total


def test_train_step_matches_jax(dense):
    """One AdamW step of reduced StableLM from the same state and batch:
    the gradients within 1e-5 of each leaf's largest entry, loss and grad
    norm within 1e-5, updated params within 1e-5 (see ADAM_TINY_GRAD)."""
    jcfg, cfg, jhp, hp, jstate, batch = dense
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    jnew, jm = jax.jit(jtrain_loop.make_train_step(jcfg, jhp))(jstate, jbatch)
    jgrads = _jax_params_in_port_layout(jax.grad(
        lambda p: jtrain_loop.make_loss_fn(jcfg)(p, jbatch)[0])(
            jstate["params"]), cfg)
    state = _state_from_jax(jstate, cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    total, _ = train_loop.make_loss_fn(cfg)(live, batch)
    grads = torch.autograd.grad(total, tree_leaves(live))
    for g, (path, jg) in zip(grads, tree_leaves_with_path(jgrads),
                             strict=True):
        err = float((g - jg).abs().max() / jg.abs().max())
        assert err <= 1e-5, (path, err)
    new, m = train_loop.make_train_step(cfg, hp)(state, batch)
    assert set(m) == set(jm) == {"loss", "grad_norm"}
    for k in m:
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5)
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert int(state["step"]) == 0  # the step's input is left as it was
    _assert_updated_params_close(new, jnew, jgrads, 1e-5, hp, cfg)


def test_compressed_training_converges():
    """The JAX test's EF-int8 run on the port: 10 steps, the loss falls by
    0.1, and the state carries the error of the last round trip."""
    cfg = get_config("stablelm-1.6b").reduced()
    hp = optimizer.OptHParams(lr=1e-3)
    state = train_loop.init_train_state(cfg, hp, device="cpu")
    state["err"] = grad_compress.init_error_state(state["params"])
    step = train_loop.make_train_step(cfg, hp, compress_grads=True)
    ds = TokenStream(cfg.vocab_size, 8, 48, 2)
    losses = []
    for _ in range(10):
        state, m = step(state, next(ds))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1
    assert any(bool(e.any()) for e in tree_leaves(state["err"]))


def test_microbatching_matches_full_batch(dense):
    """The JAX test's check on the port: 4 microbatches against 1, the mean
    loss within 1e-4 and the updated params within rtol 5e-3, atol 5e-5
    (``tests/test_training.py``)."""
    jcfg, cfg, jhp, hp, jstate, batch = dense
    s1, m1 = train_loop.make_train_step(cfg, hp, n_microbatches=1)(
        _state_from_jax(jstate, cfg), batch)
    s4, m4 = train_loop.make_train_step(cfg, hp, n_microbatches=4)(
        _state_from_jax(jstate, cfg), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s4["params"]),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-5)


def test_moe_train_step_matches_jax():
    """Reduced Moonshot (8 experts, top-2), two microbatches: the loss, the
    MoE auxiliaries and the updated params within 1e-4 of the JAX step
    (see ADAM_TINY_GRAD)."""
    name = "moonshot-v1-16b-a3b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    hp, jhp = optimizer.OptHParams(lr=1e-3), joptimizer.OptHParams(lr=1e-3)
    jstate = jtrain_loop.init_train_state(jax.random.PRNGKey(1), jcfg, jhp)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 25)).astype(np.int32)}
    jnew, jm = jax.jit(jtrain_loop.make_train_step(jcfg, jhp,
                                                   n_microbatches=2))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    launches = grouped_gemm.launches
    new, m = train_loop.make_train_step(cfg, hp, n_microbatches=2)(
        _state_from_jax(jstate, cfg), batch)
    assert grouped_gemm.launches == launches
    assert set(m) == set(jm) == {"loss", "grad_norm", "moe_lb_loss",
                                 "moe_z_loss", "moe_dropped"}
    for k in m:
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # the step's gradients: the mean of the two microbatches'
    jgrad = jax.jit(jax.grad(
        lambda p, t: jtrain_loop.make_loss_fn(jcfg)(p, {"tokens": t})[0]))
    jgrads = jax.tree.map(lambda a, b: (a + b) / 2,
                          *(jgrad(jstate["params"], jnp.asarray(t))
                            for t in np.split(batch["tokens"], 2)))
    _assert_updated_params_close(
        new, jnew, _jax_params_in_port_layout(jgrads, cfg), 1e-4, hp, cfg)


def test_loss_decreases_and_state_is_seeded():
    """The port's own 12 steps (the JAX test's): the loss falls by 0.2 and
    the grad norm stays finite; one generator seed gives one state."""
    cfg = get_config("stablelm-1.6b").reduced()
    hp = optimizer.OptHParams(lr=1e-3)
    state = train_loop.init_train_state(
        cfg, hp, device="cpu", generator=torch.Generator().manual_seed(0))
    again = train_loop.init_train_state(
        cfg, hp, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(again)))
    step = train_loop.make_train_step(cfg, hp)
    ds = TokenStream(cfg.vocab_size, batch=8, seq_len=64, seed=0)
    losses = []
    for _ in range(12):
        state, m = step(state, next(ds))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2
    assert np.isfinite(float(m["grad_norm"]))


def _counting(monkeypatch):
    """Wrap the flash and expert-GEMM wrappers the models call, counting
    calls (on CPU tensors the wrappers count no launch)."""
    calls = {"flash": 0, "gemm": 0}

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(attention, "flash_attention_bshd",
                        wrap("flash", attention.flash_attention_bshd))
    monkeypatch.setattr(moe, "grouped_gemm", wrap("gemm", moe.grouped_gemm))
    return calls


@pytest.mark.parametrize("remat_policy", ["full", "dots"])
def test_train_mode_runs_no_kernel_and_prefill_does(monkeypatch,
                                                    remat_policy):
    """``mode="train"`` differentiates without reaching a kernel wrapper,
    with and without remat (whose gradients equal the plain backward's);
    ``mode="prefill"`` calls flash once a layer and the expert GEMM three
    times a MoE layer, as before."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = transformer.init_lm(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 17)))
    calls = _counting(monkeypatch)
    grads = {}
    for policy in (None, remat_policy):
        c = cfg if policy is None else dataclasses.replace(
            cfg, remat=True, remat_policy=policy)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, cache, aux = transformer.forward(live, c, toks[:, :-1],
                                                 mode="train")
        assert cache is None and "moe_lb_loss" in aux
        loss = transformer.lm_loss(logits, toks[:, 1:], c) + aux["moe_lb_loss"]
        grads[policy] = torch.autograd.grad(loss, tree_leaves(live))
    assert calls == {"flash": 0, "gemm": 0}
    for a, b in zip(grads[None], grads[remat_policy], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        transformer.forward(params, cfg, toks, mode="prefill")
    assert calls == {"flash": cfg.n_layers, "gemm": 3 * cfg.n_layers}


def test_train_step_refuses_what_later_slices_bring():
    cfg = get_config("stablelm-1.6b").reduced()
    # slice 11b brought grad_shardings: taken, no longer refused
    # (tests/test_torch_launch.py holds a sharded accumulator's step)
    assert callable(train_loop.make_train_step(cfg, grad_shardings={}))
    # an encoder-decoder batch needs its source frames, as the JAX
    # package's loss reads batch["enc_frames"]
    encdec = dataclasses.replace(cfg, encoder_layers=2)
    with pytest.raises(KeyError, match="enc_frames"):
        train_loop.make_train_step(encdec)(
            train_loop.init_train_state(encdec, device="cpu"),
            {"tokens": np.zeros((2, 5), np.int32)})
    with pytest.raises(ValueError, match="remat_policy"):
        bad = dataclasses.replace(cfg, remat=True, remat_policy="offload")
        transformer.forward(transformer.init_lm(bad, device="cpu"), bad,
                            torch.zeros((1, 4), dtype=torch.long),
                            mode="train")


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop.init_train_state(cfg)
    state = {"w": torch.zeros(3)}
    checkpoint.save(state, str(tmp_path), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore(str(tmp_path), 0, state)


# ------------------------------ checkpoints --------------------------------

@pytest.fixture(scope="module")
def ckpt_state():
    cfg = get_config("stablelm-1.6b").reduced()
    state = train_loop.init_train_state(cfg, optimizer.OptHParams(),
                                        device="cpu")
    state, _ = train_loop.make_train_step(cfg)(
        state, next(TokenStream(cfg.vocab_size, 4, 16, 1)))
    return cfg, state


def _equal_trees(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_checkpoint_roundtrip_and_resume(ckpt_state, tmp_path):
    cfg, state = ckpt_state
    ds = TokenStream(cfg.vocab_size, 4, 16, 9)
    next(ds)
    path = checkpoint.save(state, str(tmp_path), 7, data_state=ds.state())
    assert path.endswith("step_00000007")
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored, man = checkpoint.restore(str(tmp_path), 7, state, device="cpu")
    _equal_trees(restored, state)
    assert man["step"] == 7 and man["keys"][0] == "opt/m/embed"
    assert len(man["keys"]) == len(tree_leaves(state))
    ds2 = TokenStream.from_state(cfg.vocab_size, 4, 16, man["data_state"])
    np.testing.assert_array_equal(next(ds)["tokens"], next(ds2)["tokens"])
    # a template of another shape is refused
    bad = dict(state, step=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape mismatch for step"):
        checkpoint.restore(str(tmp_path), 7, bad, device="cpu")


def test_checkpoint_layout_matches_jax(ckpt_state, tmp_path):
    """The same files as the JAX package writes: one npz entry a leaf path
    (the JAX key format), a manifest of the same fields; the JAX package
    restores an f32 state the port saved."""
    cfg, state = ckpt_state
    checkpoint.save(state, str(tmp_path / "port"), 3, data_state={"step": 1})
    jcheckpoint.save(jax.tree.map(lambda t: t.numpy(), state),
                     str(tmp_path / "jax"), 3, data_state={"step": 1})
    man = {}
    for side in ("port", "jax"):
        d = tmp_path / side / "step_00000003"
        assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
        man[side] = json.loads((d / "manifest.json").read_text())
    assert set(man["port"]) == set(man["jax"])
    assert man["port"]["keys"] == man["jax"]["keys"]
    for k in ("shapes", "dtypes", "data_state", "step"):
        assert man["port"][k] == man["jax"][k]
    back, _ = jcheckpoint.restore(str(tmp_path / "port"), 3,
                                  jax.tree.map(lambda t: t.numpy(), state))
    for (_, x), y in zip(tree_leaves_with_path(state),
                         jax.tree.leaves(back), strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_checkpoint_async_atomic_and_bf16_bits(tmp_path):
    """A bf16 state saved in a thread restores bit for bit (its 16-bit
    patterns, "bfloat16" in the manifest); a leftover ``.tmp`` directory is
    never the latest step; a snapshot no longer follows the live state."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="bfloat16")
    hp = optimizer.OptHParams(moment_dtype=torch.bfloat16)
    state = train_loop.init_train_state(cfg, hp, device="cpu")
    state, _ = train_loop.make_train_step(cfg, hp)(
        state, next(TokenStream(cfg.vocab_size, 2, 16, 2)))
    os.makedirs(tmp_path / "step_00000009.tmp")
    th = checkpoint.save_async(state, str(tmp_path), 3)
    for leaf in tree_leaves(state):  # the snapshot was taken: overwrite
        if leaf.is_floating_point():
            leaf.add_(1)
    checkpoint.wait_for_saves()
    assert not th.is_alive()
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert not os.path.exists(tmp_path / "step_00000003.tmp")
    restored, man = checkpoint.restore(str(tmp_path), 3, state, device="cpu")
    assert man["dtypes"]["params/embed"] == "bfloat16"
    assert man["dtypes"]["step"] == "int32"
    for (path, x), (_, y) in zip(tree_leaves_with_path(state),
                                 tree_leaves_with_path(restored)):
        assert x.dtype == y.dtype, path
        if x.is_floating_point():
            assert torch.equal(y + 1, x), path
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(restored))
