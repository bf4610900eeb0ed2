"""Spawned processes of ``tests/test_torch_launch.py``: the dry run's cells
and the op walker over ``fake`` worlds (one process each, since the default
process group is process-global), and a 2-process gloo train step with
``grad_shardings``. Each puts ``(result, error)`` (with a rank in front for
the gloo step) on a queue and imports no JAX."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.dist import ShardingRules
from repro_torch.dist.compat import make_mesh
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.training import train_loop
from repro_torch.training.optimizer import OptHParams
from repro_torch.training.tree import tree_leaves

# cells small enough for tier-1: the three kinds at the production shapes'
# proportions (batch a multiple of the microbatches and the data dim)
SMALL_SHAPES = (ShapeSpec("train_small", 64, 16, "train"),
                ShapeSpec("prefill_small", 256, 4, "prefill"),
                ShapeSpec("decode_small", 256, 8, "decode"))

# the walker cases: x (B, D) @ w1 (D, H) @ w2 (H, D) at a (2, 2) mesh
B, D, H = 16, 32, 64


def _counts():
    from repro_torch.serving.graphs import COUNTED
    return {k: fn.launches for k, fn in COUNTED.items()}


def cells(arch: str, out) -> None:
    """The reduced config's three kinds of cell at a fake (2, 2) world; the
    train cell as variant v3 (2 microbatches, the accumulator sharded
    through ``grad_shardings``), a quarter of the baseline's 8 passes."""
    try:
        cfg = get_config(arch).reduced()
        res = {}
        for spec in SMALL_SHAPES:
            before = _counts()
            r = run_cell(arch, spec, False, mesh_shape=(2, 2), cfg=cfg,
                         variant="v3" if spec.kind == "train" else "baseline")
            r["launches_moved"] = _counts() != before
            res[spec.kind] = r
        out.put((res, None))
    except BaseException as e:  # the parent reads the failure, not a hang
        out.put((None, repr(e)))
        raise


def walker(out) -> None:
    """Per-rank FLOPs of two matmuls at a fake (2, 2) world, and the
    collectives of a row-parallel matmul made replicated."""
    try:
        fake_world(4)
        try:
            mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
            mode = FakeTensorMode()
            with mode:
                x = distribute_tensor(torch.empty(B, D), mesh,
                                      [Shard(0), Replicate()],
                                      src_data_rank=None)
                w1 = distribute_tensor(torch.empty(D, H), mesh,
                                       [Replicate(), Shard(1)],
                                       src_data_rank=None)
                w2 = distribute_tensor(torch.empty(H, D), mesh,
                                       [Replicate(), Shard(0)],
                                       src_data_rank=None)
                xr = distribute_tensor(torch.empty(B, H), mesh,
                                       [Replicate(), Shard(1)],
                                       src_data_rank=None)

                def two(x, w1, w2):
                    return ((x @ w1) @ w2).redistribute(
                        mesh, [Shard(0), Replicate()])

                def row(x, w):
                    return (x @ w).redistribute(mesh, [Replicate()] * 2)

                _, c2 = analyze(two, x, w1, w2)
                _, cr = analyze(row, xr, w2)
                res = {"two": (c2.flops, dict(c2.coll_bytes),
                               dict(c2.coll_counts)),
                       "row": (cr.flops, dict(cr.coll_bytes),
                               dict(cr.coll_counts)),
                       "wrappers": _wrapper_placements(mesh)}
        finally:
            dist.destroy_process_group()
        out.put((res, None))
    except BaseException as e:
        out.put((None, repr(e)))
        raise


def _wrapper_placements(mesh) -> dict:
    """The kernel wrappers on fake ``DTensor``s: batch and heads shards
    (flash), experts and rows (the expert GEMM) run on the local shards
    and keep their placements; a summed dim sharded, or inputs sharded
    unlike, raise and name the dim."""
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm

    def dt(shape, placements, dtype=torch.bfloat16):
        return distribute_tensor(torch.empty(shape, dtype=dtype), mesh,
                                 placements, src_data_rank=None)

    out = {}
    q = dt((4, 16, 8, 32), [Shard(0), Shard(2)])
    kv = dt((4, 16, 4, 32), [Shard(0), Shard(2)])
    o = flash_attention(q, kv, kv)
    out["flash"] = (repr(o.placements), tuple(o.shape),
                    tuple(o.to_local().shape))
    xin = dt((8, 6, 16), [Shard(1), Shard(0)])
    w = dt((8, 16, 24), [Replicate(), Shard(0)])
    valid = dt((8, 6), [Shard(1), Shard(0)], torch.bool)
    g = grouped_gemm(xin, w, valid)
    out["gemm"] = (repr(g.placements), tuple(g.shape),
                   tuple(g.to_local().shape))
    for name, call in (
            ("flash_head_dim", lambda: flash_attention(
                dt((4, 16, 8, 32), [Shard(0), Shard(3)]),
                dt((4, 16, 4, 32), [Shard(0), Shard(3)]),
                dt((4, 16, 4, 32), [Shard(0), Shard(3)]))),
            ("flash_unlike", lambda: flash_attention(
                q, dt((4, 16, 4, 32), [Shard(0), Replicate()]),
                dt((4, 16, 4, 32), [Shard(0), Replicate()]))),
            ("gemm_summed", lambda: grouped_gemm(
                dt((8, 6, 16), [Replicate(), Shard(2)]),
                dt((8, 16, 24), [Replicate(), Shard(1)]),
                dt((8, 6), [Replicate(), Replicate()], torch.bool)))):
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out


def _state_and_batch(cfg, seed: int):
    g = torch.Generator().manual_seed(seed)
    hp = OptHParams()
    state = train_loop.init_train_state(cfg, hp, device="cpu", generator=g)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17),
                                           dtype=np.int64))
    return hp, state, {"tokens": tokens}


def grad_step(rank: int, port: int, threads: int, out) -> None:
    """One of 2 gloo processes: a 2-microbatch step of reduced StableLM-2
    with and without ``grad_shardings`` (the parameter rules on a (1, 2)
    mesh); -> both new states as numpy and the accumulator's placements."""
    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                                      dtype="float32")
            mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
            hp, state, batch = _state_and_batch(cfg, 0)
            shardings = ShardingRules(cfg, mesh).params_shardings(
                state["params"])
            seen = []
            real = train_loop.constrain_grads

            def spy(tree, sh):
                placed = real(tree, sh)
                seen.append([(tuple(x.placements), tuple(s.placements))
                             for x, s in zip(tree_leaves(placed),
                                             tree_leaves(sh))])
                return placed

            train_loop.constrain_grads = spy
            try:
                with_sh, _ = train_loop.make_train_step(
                    cfg, hp, n_microbatches=2, grad_shardings=shardings)(
                        state, batch)
            finally:
                train_loop.constrain_grads = real
            without, _ = train_loop.make_train_step(
                cfg, hp, n_microbatches=2)(state, batch)

            def host(tree):
                return [x.detach().numpy() for x in tree_leaves(tree)]

            res = {"with": host(with_sh), "without": host(without),
                   "placements": seen,
                   "plain": all(not isinstance(x, DTensor)
                                for x in tree_leaves(with_sh)),
                   "sharded": sum(any(isinstance(p, Shard) for p in got)
                                  for got, _ in seen[0])}
        finally:
            dist.destroy_process_group()
        out.put((rank, res, None))
    except BaseException as e:
        out.put((rank, None, repr(e)))
        raise
