"""One process of a 2-process gloo run of the distribution layer, for
``tests/test_torch_dist.py``, on the CPU: the expert all-to-all, the
expert-parallel MoE layer (``dispatch="a2a"``, forward and under
autograd), ``compressed_psum``, a 2-stage pipeline and the elastic
``restore`` and ``constrain`` on a ``DTensor``; and one process over
``fake`` worlds of 256, 512 and 4 ranks for the production and host
meshes. Each returns numpy arrays (a tensor as its bytes where bits are
compared) through a queue."""
import dataclasses
import multiprocessing as mp
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import get_config
from repro_torch.dist import (
    DP,
    ShardingRules,
    compressed_psum,
    constrain,
    expert_all_to_all,
    pipeline_apply,
    stack_stages,
    use_mesh,
)
from repro_torch.models import moe
from repro_torch.training import checkpoint, train_loop
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target, args_of_rank, n: int, timeout: float):
    """``n`` spawned processes of ``target(*args_of_rank(r), queue)``
    (never forked: the caller may hold a CUDA context); -> their queued
    results and exit codes, each wait bounded by ``timeout`` s, stragglers
    killed."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=args_of_rank(r) + (out,))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=timeout) for _ in procs]
        for p in procs:
            p.join(timeout=timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return results, [p.exitcode for p in procs]


def tensor_bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def a2a_step(rank, case):
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    x = torch.from_numpy(case["x"])
    g = x.shape[0] // 2
    block = x[rank * g:(rank + 1) * g]
    fwd = expert_all_to_all(mesh, block)
    back = expert_all_to_all(mesh, fwd, split_axis=0, concat_axis=1)
    return {"fwd": fwd.numpy(), "back": back.numpy()}


def moe_step(rank, case):
    params, x, kw = _t(case["params"]), torch.from_numpy(case["x"]), case["kw"]
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    part, xl = moe.expert_shard(params, x, rank, 2)
    with torch.no_grad():
        out, aux = moe.apply_moe(part, xl, mesh=mesh, dispatch="a2a", **kw)
    res = {"out": out.numpy(), "aux": _np(aux)}
    # under autograd: the weights' gradients of the sum over every rank of
    # out * probe, through the exchange and back
    live = {k: v.clone().requires_grad_() for k, v in part.items()}
    out_t, _ = moe.apply_moe(live, xl, mesh=mesh, dispatch="a2a", train=True,
                             **kw)
    _, probe = moe.expert_shard(params, torch.from_numpy(case["probe"]),
                                rank, 2)
    (out_t * probe).sum().backward()
    res["train_out"] = out_t.detach().numpy()
    res["grads"] = {k: v.grad.numpy() for k, v in live.items()}
    # one rank on the "model" dim: the exchange is the identity
    one = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    with torch.no_grad():
        a2a, a2a_aux = moe.apply_moe(params, x, mesh=one, dispatch="a2a",
                                     **kw)
        gather, gather_aux = moe.apply_moe(params, x, **kw)
    res["one_rank"] = {
        "a2a": tensor_bytes(a2a), "gather": tensor_bytes(gather),
        "a2a_aux": {k: tensor_bytes(v) for k, v in a2a_aux.items()},
        "gather_aux": {k: tensor_bytes(v) for k, v in gather_aux.items()}}
    return res


def psum_step(rank, case):
    pod = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
    one = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "pod"))
    same, err = _t(case["same"]), _t(case["err"])
    res = {}
    for name, mesh in (("two", pod), ("one", one)):
        summed = compressed_psum(mesh, same, axis="pod")
        summed_e, new_err = compressed_psum(mesh, same, axis="pod",
                                            error_state=err)
        res[name] = {"summed": _np(summed), "summed_err": _np(summed_e),
                     "new_err": _np(new_err)}
    own = compressed_psum(pod, _t(case["per_rank"][rank]), axis="pod")
    res["per_rank"] = {k: tensor_bytes(v) for k, v in own.items()}
    try:
        compressed_psum(pod, same, axis="data")
    except ValueError as e:
        res["bad_axis"] = str(e)
    return res


def pipe_stage(p, x):
    return torch.tanh(x @ p["w"]) + x


def widen(p, x):
    return x @ p["w"]


def pipe_step(rank, case):
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pipe",))
    w = torch.from_numpy(case["w"])
    stacked = stack_stages([{"w": w[0]}, {"w": w[1]}])
    out = pipeline_apply(mesh, pipe_stage, stacked,
                         torch.from_numpy(case["x"]))
    res = {"out": out.numpy()}
    wide = torch.zeros((8, 16))
    try:
        pipeline_apply(mesh, widen, stack_stages([{"w": wide}, {"w": wide}]),
                       torch.from_numpy(case["x"]))
    except ValueError as e:
        res["shape_error"] = str(e)
    try:
        pipeline_apply(mesh, pipe_stage, stack_stages([{"w": w[0]}]),
                       torch.from_numpy(case["x"]))
    except ValueError as e:
        res["count_error"] = str(e)
    return res


def restore_step(rank, case):
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype=case["dtype"])
    template = train_loop.init_train_state(cfg, device="cpu")
    shardings = ShardingRules(cfg, mesh).state_shardings(template)
    restored, man = checkpoint.restore(case["dir"], case["step"], template,
                                       device="cpu", shardings=shardings)
    leaves = {}
    for (path, leaf), sh in zip(
            tree_leaves_with_path(restored), tree_leaves(shardings),
            strict=True):
        leaves["/".join(map(str, path))] = (
            tensor_bytes(leaf.to_local()), str(leaf.dtype),
            [repr(p) for p in leaf.placements], list(sh.spec))
    return {"leaves": leaves, "step": man["step"]}


def hints_step(rank, case):
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    x = torch.from_numpy(case["x"])
    whole = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    with use_mesh(mesh):
        got = constrain(whole, DP, None)
        plain_is_x = constrain(x, DP, None) is x
    return {"local": got.to_local().numpy(), "plain_is_x": plain_is_x,
            "placements": [repr(p) for p in got.placements]}


STEPS = {"hints": hints_step, "a2a": a2a_step, "moe": moe_step,
         "psum": psum_step, "pipe": pipe_step, "restore": restore_step}


def run(rank: int, world: int, port: int, threads: int, case: dict,
        out) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out.put((rank, {k: fn(rank, case[k]) for k, fn in STEPS.items()},
                 None))
    except BaseException as e:  # the parent reads the failure, not a hang
        out.put((rank, None, repr(e)))
        raise
    finally:
        dist.destroy_process_group()


def fake_world(out) -> None:
    """The production and host meshes over ``fake`` worlds (no traffic)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import make_host_mesh, make_production_mesh

    res = {}
    try:
        for world, multi_pod in ((256, False), (512, True), (256, True),
                                 (4, False)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            try:
                if world == 4:
                    res["host"] = tuple(make_host_mesh(device="cpu").shape)
                    res["host2"] = tuple(make_host_mesh(2, device="cpu").shape)
                    for bad in (0, 3, 5):
                        try:
                            make_host_mesh(bad, device="cpu")
                        except ValueError as e:
                            res[f"host_{bad}"] = str(e)
                    continue
                try:
                    mesh = make_production_mesh(multi_pod=multi_pod,
                                                device="cpu")
                    res[(world, multi_pod)] = (mesh.mesh_dim_names,
                                               tuple(mesh.shape))
                except ValueError as e:
                    res[(world, multi_pod)] = str(e)
            finally:
                dist.destroy_process_group()
        out.put((res, None))
    except BaseException as e:
        out.put((None, repr(e)))
        raise


def _card_moe(mesh, case) -> dict:
    """The a2a MoE layer on the card in bf16 over ``mesh``'s "model" dim:
    this rank's output (as bytes) and its expert-GEMM launches."""
    from repro_torch.kernels.moe_gemm.moe_gemm import grouped_gemm

    rank = mesh.get_local_rank("model")
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    params = {k: torch.from_numpy(v).cuda().to(torch.bfloat16)
              for k, v in case["params"].items()}
    params["router"] = params["router"].float()
    x = torch.from_numpy(case["x"]).cuda().to(torch.bfloat16)
    part, xl = moe.expert_shard(params, x, rank, size)
    before = grouped_gemm.launches
    with torch.inference_mode():
        y, _ = moe.apply_moe(part, xl, mesh=mesh, dispatch="a2a",
                             **case["kw"])
    torch.cuda.synchronize()
    return {"out": tensor_bytes(y), "launches": grouped_gemm.launches - before}


def card_a2a_moe(rank: int, port: int, case: dict, out) -> None:
    """One of 2 processes that share the card in a gloo group."""
    from repro_torch.dist.compat import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            res = _card_moe(make_mesh((2,), ("model",)), case)
        finally:
            dist.destroy_process_group()
        out.put((rank, res, None))
    except Exception as e:
        out.put((rank, None, repr(e)))
        raise


def card_nccl_one_rank(port: int, case: dict, out) -> None:
    """A one-rank NCCL group on the card: the expert all-to-all is the
    identity, and the a2a layer launches the expert GEMM 3 times."""
    from repro_torch.dist.compat import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1,), ("model",))
            x = torch.from_numpy(case["x"]).cuda()
            y = expert_all_to_all(mesh, x)
            res = {"identity": bool(torch.equal(y, x)),
                   "moe": _card_moe(mesh, case)}
        finally:
            dist.destroy_process_group()
        out.put((0, res, None))
    except Exception as e:
        out.put((0, None, repr(e)))
        raise
