"""Readings that set the limits of ``correct``: for each seed, one short
run of the cell (the program's reading of each compared number) and the
cell's control (the reference in the next lower precision put in the
program's place: TF32 for the f32 SCN U-Net, fp8 for the bf16 decoder) on
what that run served.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one JSON line a seed: ``{"seed", "program": {...}, "control":
{...}}``. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if len(args.seeds) > 1:
        # one process a seed: each run's program holds most of the card
        return max(subprocess.run(
            [sys.executable, __file__, "--workload", args.workload,
             "--seconds", str(args.seconds), "--seeds", str(seed)]).returncode
            for seed in args.seeds)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness
    from portbench.run import cache_dirs

    cache_dirs()
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "program": {k: c["value"]
                                      for k, c in r["checks"].items()},
                          "control": r["control"],
                          "metrics": r["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
