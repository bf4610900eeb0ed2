"""``python -m repro_torch.analysis`` — run every static-analysis pass over
the port (port of ``repro.analysis.__main__``).

Passes (select with ``--only`` / drop with ``--skip``):

* ``lint``  — AST rules over src/repro_torch, examples/*_torch.py and
  chip_smoke.py.
* ``locks`` — lock-graph extraction + order check over src/repro_torch.
* ``plans`` — build canonical plans (batched spec'd, sharded, streaming)
  from a small synthetic scene with the port's planners and run every
  structural invariant.
* ``hlo``   — launch the fused SSpNNA kernel on a budgeted tile plan of the
  canonical scene and gate its profiler trace (no gather or scatter; no
  kernel but the fused one and the output's fill), its graph signature
  and its modeled shared memory (and the modeled geometry against the
  launch's). It needs the card: without one it raises.

Exit status is the number of findings (0 = clean, capped at 125).
``--json`` additionally writes findings + the extracted lock graph.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.findings import Finding, render

PASSES = ("lint", "locks", "plans", "hlo")
#: the canonical scene and the fused conv the ``hlo`` pass launches
RESOLUTION, CAPACITY, C_IN, C_OUT, DELTA_O, DELTA_I = 16, 512, 8, 8, 16, 48
#: device kernels the fused conv may run: the tile kernel and the fill of
#: its zeroed output
FUSED_KERNELS = ("tile_kernel", "FillFunctor", "Memset")


def find_root(start: Path | None = None) -> Path:
    """Repo root: the nearest ancestor holding ``src/repro_torch`` (falls
    back to the package's own checkout layout)."""
    cands = [start] if start else []
    cands += [Path.cwd(), Path(__file__).resolve().parents[3]]
    for c in cands:
        if c is not None and (c / "src" / "repro_torch").is_dir():
            return c
    raise SystemExit("cannot locate repo root (need a src/repro_torch dir); "
                     "pass --root")


def run_lint(root: Path) -> list[Finding]:
    from repro_torch.analysis.lint import lint_repo
    return lint_repo(root)


def run_locks(root: Path):
    from repro_torch.analysis.concurrency import extract
    return extract(root)


def _canonical_scene(seed: int = 0, resolution: int = RESOLUTION,
                     capacity: int = CAPACITY):
    import torch

    from repro_torch.data.scenes import make_scene
    from repro_torch.sparse.tensor import SparseVoxelTensor
    coords, feats, _, mask = make_scene(seed, resolution=resolution,
                                        capacity=capacity)
    return SparseVoxelTensor(torch.as_tensor(coords), torch.as_tensor(feats),
                             torch.as_tensor(mask))


def run_plans(root: Path) -> list[Finding]:
    """Build one plan of each kind from a canonical synthetic scene and
    validate every structural invariant, plus the cache-key rotations."""
    del root
    from repro_torch import engine
    from repro_torch.analysis.plan_check import (
        check_cache_keys,
        check_scene_plan,
        check_sharded_scene_plan,
        check_stream_state,
    )
    from repro_torch.data.scenes import N_CLASSES
    from repro_torch.engine.autotune import CostTable
    from repro_torch.engine.backends import BreakerBoard, default_registry
    from repro_torch.engine.plan import PlanCache, StreamPlanState
    from repro_torch.engine.shard import ShardLayout
    from repro_torch.models.scn import UNetConfig

    res, cap = RESOLUTION, CAPACITY
    cfg = UNetConfig(widths=(8, 16), reps=1, resolution=res, capacity=cap,
                     n_classes=N_CLASSES)
    t = _canonical_scene(0, res, cap)
    out: list[Finding] = []

    # batched, SPADE-planned with tile tables (the fused-kernel shape)
    spec = engine.build_plan_spec([t], cfg, mem_budget=64 * 1024)
    plan = engine.build_scene_plan_host(t, cfg, spec=spec, plan_tiles=True)
    out.extend(check_scene_plan(plan, "scene_plan"))

    # reference-dispatch plan (no tiles) exercises the COIR-only checks
    ref = engine.build_scene_plan_host(t, cfg, plan_tiles=False)
    out.extend(check_scene_plan(ref, "reference_plan"))

    # sharded plan with halo send tables
    layout = ShardLayout(n_shards=2, halo=256)
    splan = engine.build_sharded_scene_plan_host(t, cfg, layout=layout)
    out.extend(check_sharded_scene_plan(splan, "sharded_plan"))

    # streaming: frame 0 rebuild, frame 1 patched under an ego shift
    state = StreamPlanState(cfg, spec=spec, wait_s=30.0, device="cpu")
    state.plan_frame(t, 0)
    state.plan_frame(t, 1, ego_shift=(1, 0, 0))
    out.extend(check_stream_state(state, "stream"))

    # cache keys must rotate with version/topology/generations
    cache = PlanCache(capacity=cap)
    out.extend(check_cache_keys(
        cache, t, cfg, autotune=CostTable(),
        breakers=BreakerBoard(default_registry())))
    return out


@dataclass
class FusedCase:
    """The ``hlo`` pass's conv: the canonical scene's budgeted tile plan,
    random features and weights, as tensors on one device."""

    feats: object
    weights: object
    out_rows: object
    in_rows: object
    local_idx: object
    pair_counts: object
    n_out: int

    def tables(self) -> dict:
        return {"out_rows": self.out_rows, "in_rows": self.in_rows,
                "local_idx": self.local_idx, "pair_counts": self.pair_counts}

    def fused(self):
        """The conv through ``run_sspnna_conv`` (the fused kernel)."""
        from repro_torch.kernels.sspnna.ops import run_sspnna_conv
        return run_sspnna_conv(self.feats, self.weights, self.out_rows,
                               self.in_rows, self.local_idx, n_out=self.n_out,
                               pair_counts=self.pair_counts, use_kernel=True)

    def plain(self):
        """The same conv through the kernel's plain version."""
        from repro_torch.kernels.sspnna.sspnna import sspnna_fused_plain
        return sspnna_fused_plain(self.feats, self.weights, **self.tables(),
                                  n_out=self.n_out)


def fused_case(device="cuda") -> FusedCase:
    """The canonical scene's submanifold COIR, SOAR order, a (16, 48)
    tile plan and its kernel tables, features (V, 8) and weights (27, 8,
    8) from seed 0, on ``device``."""
    import numpy as np
    import torch

    from repro_torch.core import soar
    from repro_torch.core.hashgrid import build_neighbor_table, kernel_offsets
    from repro_torch.core.sparse_conv import submanifold_coir
    from repro_torch.core.tiles import build_tile_plan, dma_tile_tables
    from repro_torch.device import host_array

    t = _canonical_scene(0, RESOLUTION, CAPACITY)
    coir = submanifold_coir(t, RESOLUTION, 3)
    nbr = host_array(build_neighbor_table(
        t.coords, t.mask, torch.as_tensor(kernel_offsets(3)), RESOLUTION))
    order = soar.soar_order(nbr, host_array(t.mask), 128).order
    tp = build_tile_plan(host_array(coir.indices), order, DELTA_O, DELTA_I)
    dma = dma_tile_tables(tp, t.capacity)
    rng = np.random.default_rng(0)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    return FusedCase(
        feats=dev(rng.normal(size=(t.capacity, C_IN)), torch.float32),
        weights=dev(rng.normal(size=(27, C_IN, C_OUT)) * 0.1, torch.float32),
        out_rows=dev(dma.out_rows, torch.int32),
        in_rows=dev(dma.in_rows, torch.int32),
        local_idx=dev(tp.local_idx, torch.int32),
        pair_counts=dev(dma.pair_counts, torch.int32), n_out=t.capacity)


def gate_fake_trace(case: FusedCase | None = None) -> list[Finding]:
    """H001 on the fused conv's dispatched ops, run on fake CUDA tensors
    (no card needed: the wrapper takes its fake launch, so the trace is
    what surrounds the kernel)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.hlo_gates import forbidden_ops, op_trace

    import torch

    case = case or fused_case("cpu")
    with FakeTensorMode():
        fake = FusedCase(**{k: (torch.empty(v.shape, dtype=v.dtype,
                                            device="cuda")
                                if isinstance(v, torch.Tensor) else v)
                            for k, v in vars(case).items()})
        _, trace = op_trace(fake.fused)
    return forbidden_ops(trace, where="sspnna_fused:fake_cuda")


def run_hlo(root: Path) -> list[Finding]:
    """Launch the fused SSpNNA conv on the card on a budgeted tile plan of
    the canonical scene; gate its profiler trace, its graph signature and
    its modeled shared memory. Raises without a card."""
    del root
    import torch

    from repro_torch.analysis.hlo_gates import (
        device_kernels,
        forbidden_ops,
        gate_compile_budget,
        gate_geometry_matches,
        gate_smem_budget,
        geometry,
        only_kernels,
        op_trace,
    )
    from repro_torch.kernels.sspnna import sspnna
    from repro_torch.serving.graphs import Graphs

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the hlo pass launches the fused SSpNNA kernel and needs a CUDA "
            "card (an H100); none is available here (run the other passes "
            "with --skip hlo)")
    case = fused_case("cuda")
    where = "sspnna_fused"
    _, trace = op_trace(case.fused)
    out = forbidden_ops(trace, where=f"{where}:ops")
    kernels = device_kernels(case.fused)
    if not any("tile_kernel" in k for k in kernels):
        out.append(Finding("REPRO-H001", f"{where}:kernels",
                           f"the profiler traced no fused kernel ({kernels}): "
                           f"a trace of nothing gates nothing"))
    out.extend(forbidden_ops(kernels, where=f"{where}:kernels"))
    out.extend(only_kernels(kernels, FUSED_KERNELS, where=f"{where}:kernels"))
    graphs = Graphs(torch.device("cuda"))
    key = tuple(case.feats.shape)
    for _ in range(2):   # the second call replays: no new signature
        if key not in graphs.keys():
            graphs.capture(key, case.fused)
        graphs.replay(key)
    out.extend(gate_compile_budget(graphs, 1, where=where))
    t, d_o, k = tuple(case.local_idx.shape)
    out.extend(gate_smem_budget(n_tiles=t, delta_o=d_o, c_in=C_IN,
                                c_out=C_OUT, k=k, where=where))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out.extend(gate_geometry_matches(
        sspnna.launch_geometry(sspnna.KERNEL, t, d_o, k, C_IN, C_OUT),
        geometry(t * d_o, C_IN, C_OUT, k, 4, sms), where=where))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="write findings + lock graph as JSON")
    ap.add_argument("--only", choices=PASSES, action="append",
                    help="run only these passes")
    ap.add_argument("--skip", choices=PASSES, action="append", default=[],
                    help="skip these passes")
    args = ap.parse_args(argv)
    root = find_root(args.root)
    selected = [p for p in (args.only or PASSES) if p not in args.skip]

    findings: list[Finding] = []
    graph_json = None
    for name in selected:
        if name == "locks":
            got, graph = run_locks(root)
            graph_json = {
                "locks": graph.locks,
                "reentrant": sorted(graph.reentrant),
                "edges": sorted(list(e) for e in graph.edges),
            }
        else:
            got = {"lint": run_lint, "plans": run_plans,
                   "hlo": run_hlo}[name](root)
        print(f"[analysis] {name}: "
              f"{'clean' if not got else f'{len(got)} finding(s)'}")
        findings.extend(got)

    if findings:
        print(render(findings), file=sys.stderr)
    if args.json is not None:
        args.json.write_text(json.dumps({
            "passes": selected,
            "n_findings": len(findings),
            "findings": [f.to_dict() for f in findings],
            "lock_graph": graph_json,
        }, indent=2) + "\n")
        print(f"[analysis] wrote {args.json}")
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
