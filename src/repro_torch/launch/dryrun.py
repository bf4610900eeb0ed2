"""Multi-pod dry run: place and walk every (arch x shape x mesh) cell
(port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware: a ``fake``
process group of 256 (16x16) or 512 (2x16x16) ranks stands in for a pod of
H100s, and one process plays rank 0. For each cell:

    specs (fake tensors) -> ShardingRules -> DTensors on the mesh
    -> the step, run once under the op walker (``launch.hlo_analysis``)
    -> the rank's live bytes                 (fits in 80 GB?)
    -> the rank's FLOPs, bytes, collectives  -> the roofline terms

Nothing is allocated: every tensor is fake, so the step's ops compute
shapes only, and the four hand-written kernels take their fake launches
(``kernels.abstract``), which add their work to the walker and launch
nothing. The JAX package lowers and compiles each cell; here the step
runs eagerly on fake tensors, so ``compile_s`` is the seconds that run
takes, and ``--no-compile`` places the specs and shardings without running
the step (``status: "lowered"``). Memory goes under ``fits_80GB``, an H100's
HBM, where the JAX package has ``fits_16GB`` (a TPU v5e's). It is the
walker's count of a rank's live local bytes: ``torch.distributed._tools.
mem_tracker.MemTracker`` also sees each ``DTensor`` op's global-shape
output and the sharding propagator's tensors, and counts them as the
rank's (a 32 KB step read as 224 KB in a probe on torch 2.13).

The default process group is process-global: each cell makes its own fake
world and destroys it after.

Usage:
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod --out results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist.compat import make_mesh
from repro_torch.dist.hints import use_mesh
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import build_roofline
from repro_torch.launch.shapes import (
    SHAPES,
    ShapeSpec,
    cell_supported,
    input_specs,
)
from repro_torch.training.tree import tree_map

N_MICROBATCHES = 8  # train grad-accumulation steps (per-device micro <= 2)
HBM_BYTES = 80e9    # one H100's memory

# Cumulative optimization variants for the SPerf hillclimb:
#   v1: shard the grad accumulator like the params (RS instead of replicated AR)
#   v2: v1 + bf16 online-softmax score traffic
#   v3: v2 + 2 microbatches + bf16 grad accumulator
#   v4: v3 + full-mesh DP (model axis -> data parallelism; small archs)
#   v5: v1 + bf16 scores + 4 microbatches (memory-bounded MoE compromise)
VARIANTS = ("baseline", "v1", "v2", "v3", "v4", "v5")


def fake_world(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0: collectives move nothing."""
    # registers the fake backend on torch versions that do not by default
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def _place(tree, shardings):
    """Each fake tensor of ``tree`` as a ``DTensor`` on its sharding;
    anything else (a cache's ``pos``) as it is."""
    def one(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, sh.mesh, sh.placements,
                                 src_data_rank=None)

    return tree_map(one, tree, shardings)


def _train_step(cfg, mesh, specs, fake_mode, variant="baseline",
                n_micro=N_MICROBATCHES):
    from repro_torch.training.optimizer import OptHParams
    from repro_torch.training.train_loop import (
        init_train_state,
        make_train_step,
    )

    hp = OptHParams(moment_dtype=torch.bfloat16)
    rules = ShardingRules(cfg, mesh, full_dp=(variant == "v4"))
    accum_dtype = torch.float32
    grad_sh = None
    if variant in ("v2", "v3", "v4", "v5"):
        cfg = dataclasses.replace(cfg, attn_dtype="bfloat16")
    if variant == "v5":
        n_micro = 4
        accum_dtype = torch.bfloat16
    if variant == "v3":
        n_micro = 2
        accum_dtype = torch.bfloat16
    if variant == "v4":
        # full-mesh DP: every device needs >= 1 batch row per microbatch
        n_micro = 1
        accum_dtype = torch.bfloat16
    with fake_mode:
        state = init_train_state(cfg, hp, device="cpu")
    state = _place(state, rules.state_shardings(state))
    if variant in ("v1", "v2", "v3", "v5"):
        grad_sh = rules.params_shardings(state["params"])
    batch = _place(specs["batch"], rules.batch_shardings(specs["batch"]))
    step = make_train_step(cfg, hp, n_microbatches=n_micro,
                           grad_shardings=grad_sh, accum_dtype=accum_dtype)
    return step, (state, batch), True


def _params(cfg, rules, fake_mode):
    from repro_torch.models.transformer import init_lm

    with fake_mode:
        params = init_lm(cfg, device="cpu")
    return _place(params, rules.params_shardings(params))


def _prefill_step(cfg, mesh, specs, fake_mode):
    from repro_torch.serving.engine import make_prefill

    rules = ShardingRules(cfg, mesh)
    params = _params(cfg, rules, fake_mode)
    inputs = {k: specs[k] for k in ("tokens", "frontend_embeds", "enc_frames")
              if k in specs}
    inputs = _place(inputs, rules.batch_shardings(inputs))
    fn = make_prefill(cfg)

    def prefill(params, inputs):
        return fn(params, **inputs)

    return prefill, (params, inputs), False


def _decode_step(cfg, mesh, specs, fake_mode):
    from repro_torch.serving.engine import make_serve_step

    rules = ShardingRules(cfg, mesh)
    params = _params(cfg, rules, fake_mode)
    cache = _place(specs["cache"], rules.cache_shardings(specs["cache"]))
    token = _place(specs["token"], rules.batch_shardings(specs["token"]))
    step = make_serve_step(cfg, moe_groups=1 if cfg.is_moe else None)
    return step, (params, token, cache), False


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        return (make_production_mesh(multi_pod=multi_pod, device="cpu"),
                "2x16x16" if multi_pod else "16x16")
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    return (make_mesh(mesh_shape, axes, device="cpu"),
            "x".join(map(str, mesh_shape)))


def run_cell(arch: str, shape_name, multi_pod: bool,
             compile_: bool = True, variant: str = "baseline", *,
             mesh_shape=None, cfg=None) -> dict:
    """One cell in a fake world of its own. ``mesh_shape`` (e.g. ``(2,
    2)``), ``cfg`` (e.g. a ``reduced()`` config) and a ``ShapeSpec`` for
    ``shape_name`` stand in for the production mesh, ``get_config(arch)``
    and ``SHAPES`` in tests."""
    cfg = cfg or get_config(arch)
    spec = (shape_name if isinstance(shape_name, ShapeSpec)
            else SHAPES[shape_name])
    shape_name = spec.name
    ok, why = cell_supported(cfg, shape_name)
    world = (math.prod(mesh_shape) if mesh_shape is not None
             else 512 if multi_pod else 256)
    result = {"arch": arch, "shape": shape_name,
              "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                       else "2x16x16" if multi_pod else "16x16"),
              "variant": variant}
    if not ok:
        result["status"] = "skipped"
        result["reason"] = why
        return result
    fake_world(world)
    try:
        return _run(cfg, spec, multi_pod, compile_, variant, mesh_shape,
                    result)
    finally:
        dist.destroy_process_group()


def _run(cfg, spec, multi_pod, compile_, variant, mesh_shape,
         result) -> dict:
    mesh, mesh_name = _mesh(multi_pod, mesh_shape)
    # real inputs: the index tables DTensor sizes strided shards with
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    specs = input_specs(cfg, spec, fake_mode=fake_mode)
    t0 = time.time()
    dp = (("pod", "data", "model") if variant == "v4"
          else ("pod", "data"))
    # placing runs DTensor ops on fake shards: inside the one fake mode
    with fake_mode:
        if spec.kind == "train":
            step, args, grad = _train_step(cfg, mesh, specs, fake_mode,
                                           variant)
        elif spec.kind == "prefill":
            step, args, grad = _prefill_step(cfg, mesh, specs, fake_mode)
        else:
            step, args, grad = _decode_step(cfg, mesh, specs, fake_mode)
    result["lower_s"] = round(time.time() - t0, 1)
    if not compile_:
        result["status"] = "lowered"
        return result

    def walked(*a):
        # a plain tensor that meets a DTensor (a position table, a mask)
        # is every rank's whole value, as in the JAX program
        with implicit_replication(), use_mesh(mesh, dp=dp), \
                torch.set_grad_enabled(grad):
            return step(*a)

    t0 = time.time()
    with fake_mode:
        _, cost = analyze(walked, *args)
    result["compile_s"] = round(time.time() - t0, 1)
    mem = cost.memory()
    result["memory"] = dict(
        mem, fits_80GB=bool(mem["peak_bytes_per_device"] < HBM_BYTES))
    rf = build_roofline(result["arch"], spec.name, mesh_name, mesh.size(),
                        cost, cfg, spec)
    result["roofline"] = rf.to_dict()
    result["status"] = "ok"
    print(f"[{result['arch']} x {spec.name} x {mesh_name} x {variant}] "
          f"walk={result['compile_s']}s "
          f"mem/dev={mem['peak_bytes_per_device'] / 1e9:.2f}GB "
          f"bound={rf.bound} terms(c/m/coll)=({rf.compute_s:.4f},"
          f"{rf.memory_s:.4f},{rf.collective_s:.4f})s mfu={rf.mfu:.3f}",
          flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    r = run_cell(arch, shape, mp,
                                 compile_=not args.no_compile,
                                 variant=args.variant)
                except Exception as e:  # a failing cell is a bug: record it
                    r = {"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "status": "error", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                    print(f"[{arch} x {shape}] FAILED: {e}", flush=True)
                results.append(r)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
