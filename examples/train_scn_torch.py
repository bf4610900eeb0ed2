"""End-to-end driver: train the SCN U-Net on synthetic labelled scenes
with the PyTorch port (the twin of ``examples/train_scn.py``).

The paper's workload (3D semantic segmentation) learning on the sparse-conv
stack. Each scene's plan is built once, untiled, so every conv runs the
``reference`` backend (gather + one product), which autograd
differentiates; plain SGD at lr 0.3; then the mIoU of a held-out scene.
Run:
    PYTHONPATH=src python examples/train_scn_torch.py [--steps 300] [--res 32] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import engine
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.models.scn import SCNUNet, UNetConfig, miou, segmentation_loss
from repro_torch.sparse.tensor import SparseVoxelTensor


def scene_plan(seed, cfg, device):
    coords, feats, labels, mask = make_scene(seed, cfg.resolution,
                                             cfg.capacity)
    host = engine.build_scene_plan_host(
        SparseVoxelTensor(coords, feats, mask), cfg, plan_tiles=False)
    return feats, engine.upload_scene_plan(host, device), labels, mask


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--cap", type=int, default=4096)
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = UNetConfig(widths=(16, 32, 48), reps=1, resolution=args.res,
                     capacity=args.cap, n_classes=N_CLASSES)
    # a small dataset of scenes and their plans (one AdMAC pass a scene)
    data = [scene_plan(s, cfg, dev) for s in range(args.scenes)]
    model = SCNUNet(cfg, device=dev,
                    generator=torch.Generator().manual_seed(0))

    lr = 0.3
    t0 = time.time()
    for step in range(args.steps):
        feats, plan, labels, mask = data[step % len(data)]
        model.zero_grad()
        loss, acc = segmentation_loss(
            engine.apply_unet(model, feats, plan, device=dev), labels, mask)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(lr * p.grad)
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss.item():.4f} acc {acc.item():.3f} "
                  f"({time.time() - t0:.0f}s)")

    # held-out scene
    feats, plan, labels, mask = scene_plan(999, cfg, dev)
    with torch.no_grad():
        pred = engine.apply_unet(model, feats, plan, device=dev).argmax(-1)
    m = miou(pred.cpu().numpy(), labels, mask, N_CLASSES)
    print(f"held-out mIoU: {m:.3f}")


if __name__ == "__main__":
    main()
