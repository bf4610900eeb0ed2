"""Train a ~100M-param LM (scaled stablelm family) on the synthetic stream
with the PyTorch port (the twin of ``examples/lm_train.py``).

Run:  PYTHONPATH=src python examples/lm_train_torch.py [--steps 200] [--device cpu]
(defaults sized to finish on a CPU host; --full bumps to ~100M params)
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptHParams
from repro_torch.training.train_loop import init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slower on CPU)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    base = get_config("stablelm-1.6b")
    if args.full:  # ~100M params
        cfg = dataclasses.replace(
            base, n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
            head_dim=64, d_ff=1408, vocab_size=64000, tie_embeddings=False,
            dtype="float32", remat=False)
        batch, seq = 4, 128
    else:
        cfg = dataclasses.replace(
            base.reduced(), n_layers=4, d_model=256, d_ff=512,
            vocab_size=2048)
        batch, seq = 8, 128
    n_params = cfg.param_count()
    print(f"config: {cfg.n_layers}L d={cfg.d_model} ~{n_params/1e6:.0f}M params")

    hp = OptHParams(lr=1e-3)
    state = init_train_state(cfg, hp, device=args.device,
                             generator=torch.Generator().manual_seed(0))
    step_fn = make_train_step(cfg, hp, n_microbatches=2)
    ds = TokenStream(cfg.vocab_size, batch, seq, seed=0)
    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step_fn(state, next(ds))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.0f}s)")
        if args.ckpt and i and i % 100 == 0:
            checkpoint.save_async(state, args.ckpt, i, data_state=ds.state())
    if args.ckpt:
        checkpoint.wait_for_saves()
        print("checkpoints:", checkpoint.latest_step(args.ckpt))


if __name__ == "__main__":
    main()
