"""Serve a synthetic LiDAR sweep through the PyTorch/CUDA port's streaming
scene engine.

The twin of ``examples/stream_scene.py`` on ``repro_torch``: opens a stream
on a ``SceneEngine``, feeds it an ego-motion sweep from
``make_lidar_sweep``, and prints per-frame plan-reuse stats: after the
first frame's full build, each frame's host plan is *patched* from the
previous one (delta-based incremental planning), falling back to a full
rebuild only under heavy churn. With ``--spec`` a plan spec is pinned from
the sweep's first frame, so the tiled convs run the fused SSpNNA kernel (on
the card inside the bucket's CUDA graph); without it every conv runs on
``reference``, as in the JAX example.

Run:  PYTHONPATH=src python examples/stream_scene_torch.py [--frames 8] [--spec]
      (add ``--device cpu`` to run without a card)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_lidar_sweep
from repro_torch.models.scn import SCNUNet, UNetConfig
from repro_torch.serving.scene_engine import SceneEngine
from repro_torch.sparse.tensor import SparseVoxelTensor


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=48)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--step", type=int, default=4,
                    help="ego translation (voxels) per frame along x")
    ap.add_argument("--churn", type=float, default=0.05,
                    help="fraction of voxels appearing/disappearing per frame")
    ap.add_argument("--sync", action="store_true",
                    help="blocking waves instead of the async pipeline")
    ap.add_argument("--spec", action="store_true",
                    help="pin a plan spec from the first frame, so tiled "
                         "convs run the fused SSpNNA kernel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = UNetConfig(widths=(16, 32, 32), reps=1, resolution=args.resolution,
                     capacity=args.capacity, n_classes=N_CLASSES)
    model = SCNUNet(cfg, device=args.device,
                    generator=torch.Generator().manual_seed(0))
    frames, shifts = make_lidar_sweep(
        0, args.frames, resolution=args.resolution, capacity=args.capacity,
        step=args.step, churn=args.churn)
    scenes = [SparseVoxelTensor(c, f, m) for c, f, _, m in frames]
    spec = None
    if args.spec:
        spec = engine.build_plan_spec(scenes[:1], cfg)
        print("spec: " + "; ".join(
            f"L{li} {d.backend}" + (f" dO={d.delta_o} dI={d.delta_i} "
                                    f"T={d.n_tiles}"
                                    if d.backend == engine.SSPNNA else "")
            for li, d in enumerate(spec.levels)))
    eng = SceneEngine(cfg, model, batch=2, spec=spec,
                      ctx=engine.ExecutionContext(device=args.device),
                      sync=args.sync, depth=2, planner_threads=1)

    stream = eng.open_stream(stream_id="lidar0")
    t0 = time.time()
    reqs = eng.serve_stream(scenes, shifts, stream=stream)
    wall = time.time() - t0

    print("frame  mode     overlap  plan_ms  active  uploaded")
    for r in reqs:
        info = r.plan_info
        n_act = int(np.asarray(r.scene.mask).sum())
        up = info["upload"]
        print(f"{r.frame_no:>5}  {info['mode']:<8} {info['overlap']:>6.3f}"
              f"  {info['plan_ms']:>7.2f}  {n_act:>6}  "
              f"{up['bytes']}/{up['of_bytes']} B")
    agg = stream.stats()
    n_graphs = 0 if eng.graphs is None else len(eng.graphs)
    print(f"\n{agg['frames']} frames in {wall:.2f}s on {eng.device} "
          f"(graphs={n_graphs}) | patched={agg['patched']} "
          f"rebuilt={agg['rebuilt']} reused={agg['reused']} | mean overlap "
          f"{agg['mean_overlap']:.3f} | mean host plan "
          f"{agg['mean_plan_ms']:.2f} ms")
    notes = [w.notes for w in eng.wave_stats if w.notes]
    if notes:
        print(f"last wave notes: {notes[-1]}")
    eng.close()


if __name__ == "__main__":
    main()
