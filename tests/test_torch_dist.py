"""Port parity for the distribution layer (``repro_torch.dist``,
``repro_torch.launch``, ``models.moe``'s ``dispatch="a2a"`` and the
elastic ``training.checkpoint.restore``) against the JAX package on the
CPU.

The JAX side runs on the suite's 4 virtual CPU devices; the port's process
forms run in 2 spawned gloo processes (``tests/_dist_worker.py``: one run
serves every test below that reads ``gloo``), its loop forms and rules in
this process. Specs and integer results are held equal; data movement
(the exchange, the restored shards, the compressed sum of the same
contributions) bit for bit; the a2a MoE layer within rtol = atol = 1e-4 of
JAX's a2a (``tests/test_torch_moe.py``'s bound: the packages sum in other
orders) and bit for bit against the port's own gather at one rank; the
pipeline within 1e-5 of the serial apply.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding

import _dist_worker
from repro.configs import get_config as jax_get_config
from repro.dist import hints as jhints
from repro.dist.collectives import compressed_psum as jcompressed_psum
from repro.dist.collectives import expert_all_to_all as jexpert_all_to_all
from repro.dist.compat import make_mesh as jmake_mesh
from repro.dist.pipeline import pipeline_apply as jpipeline_apply
from repro.dist.pipeline import stack_stages as jstack_stages
from repro.dist.sharding import ShardingRules as JShardingRules
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.training.optimizer import OptHParams as JOptHParams
from repro.training.train_loop import init_train_state as jinit_train_state
from repro_torch.configs import get_config
from repro_torch.dist import (
    DP,
    ShardingRules,
    active_mesh,
    constrain,
    expert_all_to_all_local,
    pipeline_apply,
    stack_stages,
    use_mesh,
)
from repro_torch.dist.hints import constrain_spec, placements
from repro_torch.models import moe, transformer
from repro_torch.training import checkpoint, grad_compress, train_loop
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
# one CPU thread a gloo process, so its sums run in one order
THREADS = 1
# a bound on the gloo workers' join: a hung collective fails the test
JOIN_S = 240
MESHES = [((4, 1), ("data", "model"), ("data",)),
          ((2, 2), ("data", "model"), ("data",)),
          ((1, 4), ("data", "model"), ("data",)),
          ((1, 2, 2), ("pod", "data", "model"), ("pod", "data"))]
MOE_ARCH = "moonshot-v1-16b-a3b"
# (G, E, cap, d) of the exchange
A2A_SHAPE = (4, 8, 3, 5)


class FakeMesh:
    """What the port reads of a ``DeviceMesh`` (its dim names and shape),
    for what needs no process group: specs, placements and guards."""

    def __init__(self, shape, names):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)


def _moe_case():
    jcfg = jax_get_config(MOE_ARCH).reduced()
    rng = np.random.default_rng(11)
    g, tg = 4, 16
    params = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(3), jcfg.d_model, jcfg.d_ff, jcfg.moe.n_experts,
        jcfg.act, jnp.float32))
    x = rng.normal(size=(g, tg, jcfg.d_model)).astype(np.float32)
    kw = dict(top_k=jcfg.moe.top_k, act=jcfg.act,
              capacity=moe.moe_capacity(tg, jcfg.moe.top_k, jcfg.moe.n_experts,
                                        jcfg.moe.capacity_factor))
    return params, x, kw


def _restore_state(dtype):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype=dtype)
    return train_loop.init_train_state(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One 2-process gloo run of every process form, and what it was fed."""
    rng = np.random.default_rng(0)
    params, x, kw = _moe_case()
    ckpt = tmp_path_factory.mktemp("ckpt")
    state = _restore_state("bfloat16")
    checkpoint.save(state, str(ckpt), 1)
    case = {
        "hints": {"x": rng.normal(size=(4, 6)).astype(np.float32)},
        "a2a": {"x": rng.normal(size=A2A_SHAPE).astype(np.float32)},
        "moe": {"params": params, "x": x, "kw": kw,
                "probe": rng.normal(size=x.shape).astype(np.float32)},
        "psum": {"same": {"w": rng.normal(size=(300,)).astype(np.float32),
                          "b": rng.normal(size=(7, 5)).astype(np.float32)},
                 "err": {"w": rng.normal(size=(300,)).astype(np.float32)
                         * 1e-3,
                         "b": np.zeros((7, 5), np.float32)},
                 "per_rank": [{"w": rng.normal(size=(513,))
                               .astype(np.float32)} for _ in range(2)]},
        "pipe": {"w": (rng.normal(size=(2, 8, 8)) * 0.3).astype(np.float32),
                 "x": rng.normal(size=(5, 4, 8)).astype(np.float32)},
        "restore": {"dir": str(ckpt), "step": 1, "arch": "stablelm-1.6b",
                    "dtype": "bfloat16"},
    }
    port = _dist_worker.free_port()
    results, codes = _dist_worker.spawn(
        _dist_worker.run, lambda r: (r, 2, port, THREADS, case), 2, JOIN_S)
    by_rank = {rank: res for rank, res, _ in results}
    errors = [err for _, _, err in results if err]
    assert not errors and all(c == 0 for c in codes), (errors, codes)
    return case, by_rank, state


# ------------------------------------------------------------------- hints

def test_constrain_is_x_without_mesh(rng):
    x = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32))
    assert constrain(x, DP, None, "model") is x
    assert active_mesh() is None
    mesh = FakeMesh((2, 2), ("data", "model"))
    with use_mesh(mesh, dp=("pod", "data")) as m:
        assert m is mesh and active_mesh() == (mesh, ("data",))
        assert constrain(x, DP, None, "model") is x   # a rank's own block
        with pytest.raises(ValueError, match="entries for rank-3"):
            constrain(x, DP, None)
    assert active_mesh() is None
    with pytest.raises(ValueError, match="none of dp axes"):
        with use_mesh(mesh, dp=("nonexistent",)):
            pass


CONSTRAIN_CASES = [
    ((8, 6, 16), (jhints.DP, None, "model")),
    ((6, 8, 16), (jhints.DP, "model", None)),        # indivisible batch
    ((4, 8), ("model", jhints.DP)),
    ((8, 8), (("model", "data"), None)),               # tuple entry
    ((3, 8), (jhints.DP, "nonexistent")),              # absent axis
    ((8, 4, 12), ("data", "model", None)),             # DP's axis taken
    ((0, 8), (jhints.DP, "model")),
    ((8, 16), (("pod", "model"), jhints.DP)),
]


@pytest.mark.parametrize("full_dp", [False, True], ids=["dp", "full_dp"])
@pytest.mark.parametrize("mesh_case", MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
def test_constrain_spec_matches_jax(mesh_case, full_dp, monkeypatch):
    """The spec JAX's ``constrain`` hands ``with_sharding_constraint``
    (captured: an eager constraint on a host array may be refused) equals
    the port's."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: sharding)
    shape, names, dp = mesh_case
    if full_dp:
        dp = dp + ("model",)
    jmesh = jmake_mesh(shape, names)
    mesh = FakeMesh(shape, names)
    for arr_shape, entries in CONSTRAIN_CASES:
        ours = tuple(DP if e is jhints.DP else e for e in entries)
        with jhints.use_mesh(jmesh, dp=dp):
            want = tuple(jhints.constrain(jnp.zeros(arr_shape),
                                          *entries).spec)
        with use_mesh(mesh, dp=dp):
            _, got_dp = active_mesh()
            got = constrain_spec(arr_shape, ours, dict(zip(names, shape)),
                                 got_dp)
        assert got == want, (arr_shape, entries)


def test_constrain_redistributes_a_dtensor(gloo):
    """Inside ``use_mesh``, a replicated ``DTensor`` takes the hint's
    placements (rank r keeps rows [2r, 2r+2)); a plain tensor stays."""
    case, by_rank, _ = gloo
    x = case["hints"]["x"]
    for rank, res in by_rank.items():
        got = res["hints"]
        assert got["placements"] == ["Shard(dim=0)"]
        assert got["plain_is_x"]
        np.testing.assert_array_equal(got["local"], x[2 * rank:2 * rank + 2])


def test_model_call_sites_are_no_ops_without_mesh():
    """The hints in ``_embed``, ``_logits`` and the MoE layer return their
    inputs themselves without a mesh: the prefill's values and kernel
    launches do not move (``test_torch_lm``/``test_torch_moe`` hold them
    against the JAX package); under a mesh a plain tensor passes through."""
    cfg = get_config(MOE_ARCH).reduced()
    params = transformer.init_lm(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = transformer.forward(params, cfg, toks, mode="prefill")[0]
        with use_mesh(FakeMesh((2, 2), ("data", "model"))):
            got = transformer.forward(params, cfg, toks, mode="prefill")[0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------- sharding

def _drop(spec):
    return spec[1:] if spec else spec


def _port_layout(jtree, cfg, *, cache=False, n_layers=None, cycle=None):
    """A JAX-layout tree (leaves: specs) in the port's layout: the cycles'
    stacks un-stacked in layer order (their specs without the stack's
    entry), a decode cache's layer dicts flattened."""
    if isinstance(jtree, dict) and "cycles" in jtree:
        cycle = cycle or len(cfg.attn_pattern)
        n = (n_layers or cfg.n_layers) // cycle

        def conv(node, stacked):
            if isinstance(node, dict):
                return {k: conv(v, stacked) for k, v in node.items()}
            return _drop(node) if stacked else node

        cycles = jtree["cycles"] or []
        layers = [conv(cycles[j], True) for i in range(n)
                  for j in range(cycle)]
        layers += [conv(lp, False) for lp in jtree["rem"]]
        if cache:
            layers = [{k: v for c in lp.values() for k, v in c.items()}
                      for lp in layers]
        out = {k: _port_layout(v, cfg, cache=cache)
               for k, v in jtree.items() if k not in ("cycles", "rem")}
        out["layers"] = layers
        return out
    if isinstance(jtree, dict):
        return {k: (_port_layout(v, cfg, cache=cache, n_layers=cfg.encoder_layers,
                                 cycle=1) if k == "encoder"
                    else _port_layout(v, cfg, cache=cache))
                for k, v in jtree.items()}
    return jtree


def _jax_specs(shardings):
    return jax.tree.map(lambda s: tuple(s.spec), shardings,
                        is_leaf=lambda s: isinstance(s, JNamedSharding))


def _port_specs(shardings):
    return tree_map(lambda s: s.spec, shardings)


RULE_ARCHS = [("stablelm-1.6b", {}), (MOE_ARCH, {}),
              ("stablelm-1.6b", {"n_layers": 4}),   # a stack of 4 divides
              ("recurrentgemma-9b", {}),             # a cycle of 3 and rem
              ("seamless-m4t-medium", {})]           # the encoder's stack


def _configs(arch, change):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **change),
            dataclasses.replace(get_config(arch).reduced(), **change))


@pytest.mark.parametrize("full_dp", [False, True], ids=["dp", "full_dp"])
@pytest.mark.parametrize("mesh_case", MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
def test_sharding_rules_match_jax(mesh_case, full_dp):
    """Every leaf of the train states, of decode caches and of a batch gets
    the spec of its JAX leaf (a stacked leaf's without the stack entry)."""
    shape, names, _ = mesh_case
    jmesh, mesh = jmake_mesh(shape, names), FakeMesh(shape, names)
    for arch, change in RULE_ARCHS:
        jcfg, cfg = _configs(arch, change)
        jrules = JShardingRules(jcfg, jmesh, full_dp=full_dp)
        rules = ShardingRules(cfg, mesh, full_dp=full_dp)
        jstate = jax.eval_shape(lambda: jinit_train_state(
            jax.random.PRNGKey(0), jcfg, JOptHParams()))
        state = train_loop.init_train_state(cfg, device="meta")
        assert _port_specs(rules.state_shardings(state)) == _port_layout(
            _jax_specs(jrules.state_shardings(jstate)), cfg), arch
        assert _port_specs(rules.params_shardings(state["params"])) == \
            _port_layout(_jax_specs(jrules.params_shardings(
                jstate["params"])), cfg), arch
        src = 6 if cfg.is_encdec else 0
        jcache = jax.eval_shape(lambda: jtransformer.init_decode_cache(
            jcfg, 8, 16, src))
        cache = transformer.init_decode_cache(cfg, 8, 16, src, device="meta")
        assert _port_specs(rules.cache_shardings(cache)) == _port_layout(
            _jax_specs(jrules.cache_shardings(jcache)), cfg, cache=True), arch
    batch = {"tokens": torch.zeros((8, 65), dtype=torch.int32),
             "mask": torch.zeros((3, 64))}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in batch.items()}
    assert _port_specs(rules.batch_shardings(batch)) == \
        _jax_specs(jrules.batch_shardings(jbatch))
    assert rules.replicated().spec == tuple(jrules.replicated().spec) == ()


def test_sharding_rules_on_a_stack_the_jax_rule_splits():
    """With 4 stacked layers on a 4-wide data axis, the JAX cache rule
    shards the stack over "data"; the port cannot split one layer's
    tensor over layers, so that leaf is replicated over "data"."""
    jcfg, cfg = _configs("stablelm-1.6b", {"n_layers": 4})
    jmesh, mesh = jmake_mesh((4, 1), ("data", "model")), FakeMesh(
        (4, 1), ("data", "model"))
    jspec = tuple(JShardingRules(jcfg, jmesh).cache_shardings(
        jax.eval_shape(lambda: jtransformer.init_decode_cache(jcfg, 8, 16)))
        ["cycles"][0]["attn"]["k"].spec)
    assert jspec[0] == "data"
    got = ShardingRules(cfg, mesh).cache_shardings(
        transformer.init_decode_cache(cfg, 8, 16, device="meta"))
    k0 = got["layers"][0]["k"]
    assert k0.spec == jspec[1:] == (None, None, None, None)
    assert [repr(p) for p in k0.placements] == ["Replicate()", "Replicate()"]


def test_placements_of_specs():
    mesh = FakeMesh((2, 2, 2), ("pod", "data", "model"))
    assert [repr(p) for p in placements(mesh, (("pod", "data"), None,
                                               "model"))] == [
        "Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
    assert [repr(p) for p in placements(mesh, ())] == ["Replicate()"] * 3


# ------------------------------------------------------------- collectives

def test_expert_all_to_all_loop_form_matches_jax(rng):
    x = rng.normal(size=A2A_SHAPE).astype(np.float32)
    g, e = A2A_SHAPE[:2]
    jmesh = jmake_mesh((2,), ("model",))
    want = np.asarray(jexpert_all_to_all(jmesh, jnp.asarray(x)))
    blocks = torch.from_numpy(x).reshape(2, g // 2, *A2A_SHAPE[1:])
    fwd = expert_all_to_all_local(blocks)
    for r in range(2):
        np.testing.assert_array_equal(fwd[r].numpy(),
                                      want[:, r * e // 2:(r + 1) * e // 2])
    back = expert_all_to_all_local(fwd, split_axis=0, concat_axis=1)
    assert torch.equal(back, blocks)
    one = torch.from_numpy(x)[None]
    assert torch.equal(expert_all_to_all_local(one), one)
    np.testing.assert_array_equal(np.asarray(jexpert_all_to_all(
        jmake_mesh((1,), ("model",)), jnp.asarray(x))), x)


def test_expert_all_to_all_gloo_equals_loop_and_jax(gloo):
    case, by_rank, _ = gloo
    x = case["a2a"]["x"]
    g = x.shape[0]
    loop = expert_all_to_all_local(torch.from_numpy(x).reshape(
        2, g // 2, *x.shape[1:])).numpy()
    want = np.asarray(jexpert_all_to_all(jmake_mesh((2,), ("model",)),
                                         jnp.asarray(x)))
    e = x.shape[1]
    for rank, res in by_rank.items():
        got = res["a2a"]
        np.testing.assert_array_equal(got["fwd"], loop[rank])
        np.testing.assert_array_equal(
            got["fwd"], want[:, rank * e // 2:(rank + 1) * e // 2])
        np.testing.assert_array_equal(
            got["back"], x[rank * g // 2:(rank + 1) * g // 2])


def test_compressed_psum_matches_jax(gloo):
    """At 1 and 2 ranks, with and without error state, the same
    contributions on every rank (JAX's replicated input): equal bit for
    bit. An axis the mesh lacks raises, as in the JAX package."""
    case, by_rank, _ = gloo
    same = {k: jnp.asarray(v) for k, v in case["psum"]["same"].items()}
    err = {k: jnp.asarray(v) for k, v in case["psum"]["err"].items()}
    for name, n in (("one", 1), ("two", 2)):
        jmesh = jmake_mesh((n,), ("pod",))
        want = jcompressed_psum(jmesh, same, axis="pod")
        want_e, want_err = jcompressed_psum(jmesh, same, axis="pod",
                                            error_state=err)
        for rank, res in by_rank.items():
            got = res["psum"][name]
            for k in same:
                np.testing.assert_array_equal(got["summed"][k],
                                              np.asarray(want[k]))
                np.testing.assert_array_equal(got["summed_err"][k],
                                              np.asarray(want_e[k]))
                np.testing.assert_array_equal(got["new_err"][k],
                                              np.asarray(want_err[k]))
    for res in by_rank.values():
        assert "not in mesh axes" in res["psum"]["bad_axis"]
    with pytest.raises(ValueError):
        jcompressed_psum(jmake_mesh((2,), ("pod",)), same, axis="data")


def test_compressed_psum_sums_each_ranks_round_trip(gloo):
    """Different gradients on each rank: the sum is the ranks' EF-int8
    round trips added in rank order, bit for bit."""
    case, by_rank, _ = gloo
    trips = [grad_compress.compress_decompress(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.zeros(v.shape) for k, v in g.items()})[0]
        for g in case["psum"]["per_rank"]]
    want = trips[0]["w"] + trips[1]["w"]
    for res in by_rank.values():
        assert bytes(res["psum"]["per_rank"]["w"]) == want.numpy().tobytes()


# ---------------------------------------------------------------- pipeline

def _serial(w, x):
    out = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(w.shape[0]):
            h = _dist_worker.pipe_stage({"w": w[s]}, h)
        out.append(h)
    return torch.stack(out)


def test_pipeline_two_stages_match_serial_and_jax(gloo):
    case, by_rank, _ = gloo
    w, x = case["pipe"]["w"], case["pipe"]["x"]
    want = _serial(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    jwant = np.asarray(jpipeline_apply(
        jmake_mesh((2,), ("pipe",)),
        lambda p, t: jnp.tanh(t @ p["w"]) + t,
        jstack_stages([{"w": jnp.asarray(w[0])}, {"w": jnp.asarray(w[1])}]),
        jnp.asarray(x)))
    for res in by_rank.values():
        got = res["pipe"]
        np.testing.assert_allclose(got["out"], want, **PIPE_TOL)
        np.testing.assert_allclose(got["out"], jwant, **PIPE_TOL)
        assert "shape/dtype-preserving" in got["shape_error"]
        assert "1 stacked stages vs 2-wide" in got["count_error"]


def test_pipeline_single_stage_and_checks(rng):
    mesh = FakeMesh((1,), ("pipe",))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    out = pipeline_apply(mesh, _dist_worker.widen, stack_stages([{"w": w}]), x)
    assert out.shape == (5, 4, 3)   # one stage may change the shape
    jout = np.asarray(jpipeline_apply(
        jmake_mesh((1,), ("pipe",)), lambda p, t: t @ p["w"],
        jstack_stages([{"w": jnp.asarray(w.numpy())}]), jnp.asarray(x.numpy())))
    np.testing.assert_allclose(out.numpy(), (x @ w).numpy(), **PIPE_TOL)
    np.testing.assert_allclose(out.numpy(), jout, **PIPE_TOL)
    with pytest.raises(ValueError, match="at least one stage"):
        stack_stages([])
    with pytest.raises(ValueError, match="2 stacked stages vs 1-wide"):
        pipeline_apply(mesh, _dist_worker.widen,
                       stack_stages([{"w": w}, {"w": w}]), x)
    with pytest.raises(ValueError, match="not in mesh axes"):
        pipeline_apply(FakeMesh((1,), ("model",)), _dist_worker.widen,
                       stack_stages([{"w": w}]), x)


# --------------------------------------------------------------------- MoE

def test_moe_a2a_two_ranks_match_jax(gloo):
    """Each rank's G/2 groups through its 4 experts, concatenated: within
    1e-4 of JAX's a2a on a 2-device "model" mesh, the auxiliaries too
    (reduced over the ranks to the JAX call's averages over every group)."""
    case, by_rank, _ = gloo
    params, x, kw = (case["moe"][k] for k in ("params", "x", "kw"))
    jmesh = jmake_mesh((2,), ("model",))
    want, jaux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), mesh=jmesh, dispatch="a2a",
                                **kw)
    got = np.concatenate([by_rank[r]["moe"]["out"] for r in range(2)])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for res in by_rank.values():
        for k, v in jaux.items():
            np.testing.assert_allclose(res["moe"]["aux"][k], np.asarray(v),
                                       **TOL)
        np.testing.assert_array_equal(res["moe"]["aux"]["expert_load"],
                                      np.asarray(jaux["expert_load"]))


def test_moe_a2a_one_rank_equals_gather_bit_for_bit(gloo):
    _, by_rank, _ = gloo
    for res in by_rank.values():
        one = res["moe"]["one_rank"]
        assert bytes(one["a2a"]) == bytes(one["gather"])
        for k in one["gather_aux"]:
            assert bytes(one["a2a_aux"][k]) == bytes(one["gather_aux"][k]), k


def test_moe_a2a_under_autograd(gloo):
    """``train=True`` through the exchange and back: the outputs equal the
    gather path's, each rank's expert-weight gradients of the sum over
    every rank of ``out * probe`` equal the gather path's gradients of its experts, and the
    ranks' router gradients (each its own groups' share) sum to the
    gather path's."""
    case, by_rank, _ = gloo
    params, x, kw = (case["moe"][k] for k in ("params", "x", "kw"))
    live = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = moe.apply_moe(live, torch.from_numpy(x), train=True, **kw)
    (out * torch.from_numpy(case["moe"]["probe"])).sum().backward()
    got = np.concatenate([by_rank[r]["moe"]["train_out"] for r in range(2)])
    np.testing.assert_allclose(got, out.detach().numpy(), **TOL)
    e = params["router"].shape[1] // 2
    for rank, res in by_rank.items():
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(
                res["moe"]["grads"][k],
                live[k].grad[rank * e:(rank + 1) * e].numpy(), **TOL)
    np.testing.assert_allclose(
        by_rank[0]["moe"]["grads"]["router"]
        + by_rank[1]["moe"]["grads"]["router"],
        live["router"].grad.numpy(), **TOL)


def test_expert_shard_cuts_rows_and_groups():
    params, x, _ = _moe_case()
    params = {k: torch.tensor(v) for k, v in params.items()}
    part, xl = moe.expert_shard(params, torch.from_numpy(x), 1, 2)
    e = params["router"].shape[1]
    assert torch.equal(part["router"], params["router"])
    assert torch.equal(part["w_up"], params["w_up"][e // 2:])
    assert torch.equal(xl, torch.from_numpy(x)[2:])
    with pytest.raises(ValueError, match="must split over 3 ranks"):
        moe.expert_shard(params, torch.from_numpy(x), 0, 3)


# ----------------------------------------------------------------- restore

def _shard_of(t, placements_repr, rank):
    for i, p in enumerate(placements_repr):
        if p.startswith("Shard"):
            d = int(p[len("Shard(dim="):-1])
            assert i == 1            # the "model" dim of the (1, 2) mesh
            t = t.chunk(2, dim=d)[rank]
    return t


def test_restore_onto_a_two_rank_mesh(gloo):
    """A bf16 StableLM-2 train state restored with ``ShardingRules(cfg,
    mesh).state_shardings`` on a (1, 2) ("data", "model") mesh: each
    rank's local shards equal the matching slices of the saved leaves bit
    for bit, in the template's dtypes, with the rules' placements."""
    _, by_rank, state = gloo
    saved = {"/".join(map(str, p)): leaf
             for p, leaf in tree_leaves_with_path(state)}
    n_sharded = 0
    for rank, res in by_rank.items():
        got = res["restore"]
        assert got["step"] == 1
        assert set(got["leaves"]) == set(saved)
        for k, (data, dtype, places, spec) in got["leaves"].items():
            assert dtype == str(saved[k].dtype), k
            assert places[0] == "Replicate()", k
            assert (places[1] != "Replicate()") == ("model" in spec), k
            n_sharded += places[1] != "Replicate()"
            want = _shard_of(saved[k], places, rank)
            assert bytes(data) == want.contiguous().reshape(-1).view(
                torch.uint8).numpy().tobytes(), k
    assert n_sharded > len(saved)   # most leaves split over "model"


def test_restore_without_shardings_is_unchanged(tmp_path):
    state = _restore_state("bfloat16")
    checkpoint.save(state, str(tmp_path), 2)
    back, _ = checkpoint.restore(str(tmp_path), 2, state, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(back), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert type(b) is torch.Tensor


# ---------------------------------------------------------- meshes, raises

def test_production_and_host_meshes_under_fake_worlds():
    results, codes = _dist_worker.spawn(_dist_worker.fake_world, lambda r: (),
                                        1, JOIN_S)
    res, err = results[0]
    assert err is None and codes == [0], err
    assert res[(256, False)] == (("data", "model"), (16, 16))
    assert res[(512, True)] == (("pod", "data", "model"), (2, 16, 16))
    assert "needs a world of 512 ranks, not 256" in res[(256, True)]
    assert res["host"] == (4, 1) and res["host2"] == (2, 2)
    for bad in (0, 3, 5):
        assert "positive divisor of the device count (4)" in res[f"host_{bad}"]


def test_grad_shardings_waits_for_slice_11b():
    """Slice 11b brought ``grad_shardings``: ``make_train_step`` takes the
    tree and no longer raises (``tests/test_torch_launch.py`` holds a
    2-process step with it to the step without)."""
    cfg = get_config("stablelm-1.6b").reduced()
    assert callable(train_loop.make_train_step(cfg, grad_shardings={}))
