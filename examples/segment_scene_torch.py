"""Batched 3D-segmentation serving through the PyTorch/CUDA port.

The twin of ``examples/segment_scene.py`` on ``repro_torch``: representative
scenes pin the SPADE dataflow decisions once (offline-SPADE, §V-C), then
``serving.scene_engine.SceneEngine`` serves waves of pointcloud requests:
per scene one cached AdMAC/SOAR plan build, per wave one pass over all its
scenes, on the card one CUDA graph replayed by every wave. By default the
engine runs its async pipeline (plan builds for wave k+1 overlap device
execution of wave k) and prints the per-stage timings; ``--sync`` falls
back to the blocking wave loop for comparison. Sharded serving
(``--shards`` of the JAX example) comes with a later slice.

Run:  PYTHONPATH=src python examples/segment_scene_torch.py [--requests 8] [--sync]
      (add ``--device cpu`` to run without a card)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.models.scn import SCNUNet, UNetConfig
from repro_torch.serving.scene_engine import SceneEngine, SceneRequest
from repro_torch.sparse.tensor import SparseVoxelTensor


def load_scene(seed, res, cap):
    coords, feats, _, mask = make_scene(seed, res, cap)
    return SparseVoxelTensor(coords, feats, mask)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--cap", type=int, default=4096)
    ap.add_argument("--sync", action="store_true",
                    help="serve with the blocking wave loop instead of the "
                         "async plan/dispatch/drain pipeline")
    ap.add_argument("--planner-threads", type=int, default=1)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = UNetConfig(widths=(16, 32, 48), reps=1, resolution=args.res,
                     capacity=args.cap, n_classes=N_CLASSES)
    model = SCNUNet(cfg, device=args.device,
                    generator=torch.Generator().manual_seed(0))

    t0 = time.time()
    reps = [load_scene(123 + i, args.res, args.cap) for i in range(2)]
    # offline-SPADE: pin the per-level dataflow from representative scenes
    spec = engine.build_plan_spec(reps, cfg, mem_budget=64 * 1024)
    for li, d in enumerate(spec.levels):
        print(f"spec level{li}: {d.backend} walk={d.walk} "
              f"dO={d.delta_o} dI={d.delta_i} tiles={d.n_tiles}")
    print(f"plan spec pinned in {time.time() - t0:.1f}s")
    ctx = engine.ExecutionContext(device=args.device)
    eng = SceneEngine(cfg, model, batch=args.batch, spec=spec, ctx=ctx,
                      sync=args.sync, depth=args.depth,
                      planner_threads=args.planner_threads)
    t_serve = time.time()
    reqs = [SceneRequest(rid, load_scene(1000 + rid, args.res, args.cap))
            for rid in range(args.requests)]
    handles = eng.submit(reqs)
    eng.serve()
    for h in handles:
        r = h.result()
        mask = np.asarray(r.scene.mask)
        hist = np.bincount(r.pred[mask], minlength=N_CLASSES)
        print(f"req {r.rid}: {int(mask.sum())} voxels, classes={hist.tolist()}")
    tm = eng.timings()
    mode = "sync" if args.sync else "async"
    n_graphs = 0 if eng.graphs is None else len(eng.graphs)
    print(f"{mode} serve of {args.requests} reqs on {eng.device} in "
          f"{time.time() - t_serve:.1f}s over {tm['waves']} waves "
          f"(signatures={eng.n_compilations}, graphs={n_graphs}, "
          f"plan cache {eng.cache.hits} hits / {eng.cache.misses} misses)")
    print(f"pipeline: plan={tm['plan_ms']:.0f}ms "
          f"(waited {tm['plan_wait_ms']:.0f}ms) "
          f"device={tm['device_ms']:.0f}ms drain={tm['drain_ms']:.0f}ms "
          f"overlap_frac={tm['overlap_frac']:.2f}")
    eng.close()


if __name__ == "__main__":
    main()
