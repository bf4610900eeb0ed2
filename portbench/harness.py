"""The benchmark harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``: ``configs/<config>.json`` (which
names its family, ``families/<family>.py``), ``traffic/<traffic>.json``
and ``metrics/<metric>.py`` (``metrics/<base>.py`` for a ``<base>.<part>``
without a file of its own). A run:

1. set-up (``setup_s``): the family builds the program with weights from
   the seed and warms up the cell's shapes;
2. the window: a closed loop of the mix's clients, or its open-loop
   arrivals (``frozen/traffic.py``), one wave of the engine at a time, for
   ``--seconds`` (with ``--trace 1``: the mix's ``trace_waves`` waves under
   ``torch.profiler``); after it nothing more is sent and the requests out
   are served, so every request of the window is answered and timed;
3. the device's peak memory is read, the program is freed, and the
   family's reference checks what the window served;
4. the metrics are read and printed as one JSON line.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench.frozen.trace import Trace, read_profile
from portbench.frozen.traffic import (ArrivalTimes, RequestDraws,
                                      check_mix, load_mix)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run's process must not hold once the window
#: has closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WINDOW = "portbench.window"  # the spans' names start with trace.SPAN_PREFIX


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> dict:
    """The files of one cell, found by the names ``BENCHMARK.json`` gives."""
    cell = find(bench["workloads"], workload, "workload")
    config = find(bench["configs"], cell["config"], "config")
    cfg = json.loads((ROOT / config["file"]).read_text())
    return {"config": cfg,
            "family": HERE / "families" / f"{cfg['family']}.py",
            "mix": HERE / "traffic" / f"{cell['traffic']}.json"}


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or for a name ``<base>.<part>`` without a file
    of its own, its base's reader ``metrics/<base>.py``: one reader serves
    a quantity that each kind of cell reports under its own name."""
    path = HERE / "metrics" / f"{name}.py"
    if path.is_file():
        return path
    return HERE / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    return load_module(reader_path(name),
                       "portbench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Served:
    """One request of the window, as the client saw it."""

    fields: dict
    t_submit: float
    t_done: float | None = None
    status: str = "queued"
    wave: int = -1
    units: dict = field(default_factory=dict)


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    setup_s: float = 0.0
    window_s: float = 0.0
    served: list = field(default_factory=list)
    trace: Trace | None = None
    #: the traced window's waves: request fields, ``WaveStats``, counters
    traced_fields: list = field(default_factory=list)
    traced_stats: list = field(default_factory=list)
    traced_units: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)

    def completed(self) -> list[Served]:
        return [s for s in self.served if s.status == "completed"]

    def latencies_s(self, traced: bool = False) -> list[float]:
        """Submit-to-answer seconds of the completed requests, of those
        answered in the traced waves only with ``traced``."""
        last = self.counters.get("waves", 0) if traced else float("inf")
        return [s.t_done - s.t_submit for s in self.completed()
                if s.wave <= last]

    def total(self, unit: str, traced: bool = False) -> float:
        """Units of the completed requests, of the traced waves only with
        ``traced``."""
        if traced:
            return sum(u.get(unit, 0) for wave in self.traced_units
                       for u in wave)
        return sum(s.units.get(unit, 0) for s in self.completed())


def drive(sut, mix: dict, seed: int, seconds: float, trace: bool,
          run: Run) -> list:
    """The window: the mix's closed loop of clients, or its open-loop
    arrivals, served one wave of the engine at a time. Returns
    [(fields, answer)] of every request."""
    from torch.profiler import ProfilerActivity, profile, record_function

    draws = RequestDraws(mix, seed)
    arrivals = ArrivalTimes(mix, seed) if mix["loop"] == "open" else None
    kept, outstanding = [], []
    trace_waves = int(mix["trace_waves"])
    warm = len(sut.wave_stats())

    def send(t_arrive: float) -> None:
        rec = Served(draws.next(), t_arrive)
        outstanding.append((rec, sut.submit(rec.fields)))

    prof = None
    if trace:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        before = sut.counters()
        window = record_function(WINDOW)
        window.__enter__()
    t0 = time.perf_counter()

    def due(t_arrive: float) -> bool:
        """An arrival at ``t_arrive`` belongs to the window."""
        return trace or t_arrive - t0 < seconds

    if arrivals is None:
        for _ in range(int(mix["clients"])):
            send(time.perf_counter())
    else:
        t_next = t0 + arrivals.next()
    wave, sending, t_last = 0, True, t0
    while True:
        if arrivals is not None:
            # every arrival whose time has come; idle until the next one
            # where nothing is out
            now = time.perf_counter()
            if sending and not outstanding and due(t_next) and t_next > now:
                with record_function("portbench.idle"):
                    time.sleep(t_next - now)
                now = time.perf_counter()
            while sending and t_next <= now and due(t_next):
                send(t_next)
                t_next = t0 + arrivals.next()
            sending = sending and due(t_next)
        if not outstanding:
            break
        with record_function("portbench.wave"):
            sut.serve_wave()
        t = time.perf_counter()
        wave += 1
        done, still = 0, []
        for rec, h in outstanding:
            if h.done():
                rec.t_done, rec.status, rec.wave = t, h.status, wave
                rec.units = sut.units(h) if h.status == "completed" else {}
                kept.append((rec.fields, sut.answer(h)
                             if h.status == "completed" else None))
                run.served.append(rec)
                done += 1
            else:
                still.append((rec, h))
        outstanding = still
        t_last = t
        if prof is not None and wave <= trace_waves:
            run.traced_fields.append([r.fields for r in run.served
                                      if r.wave == wave])
            run.traced_units.append([r.units for r in run.served
                                     if r.wave == wave])
        if sending and arrivals is None:
            with record_function("portbench.clients"):
                for _ in range(done):
                    send(time.perf_counter())
        if trace:
            sending = sending and wave < trace_waves
        elif arrivals is None:
            sending = t - t0 < seconds
        if prof is not None and wave == trace_waves:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window.__exit__(None, None, None)
            after = sut.counters()
            prof.__exit__(None, None, None)
            run.trace = read_profile(prof, WINDOW)
            run.traced_stats = sut.wave_stats()[warm: warm + trace_waves]
            run.counters = {k: after[k] - before[k] for k in after}
            run.counters["waves"] = trace_waves
            prof = None
    # an open window lasts its seconds even where its last arrivals were
    # answered before they ran out
    run.window_s = t_last - t0
    if arrivals is not None and not trace:
        run.window_s = max(run.window_s, seconds)
    return kept


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, *, bench: dict | None = None,
             config_override: dict | None = None,
             mix_override: dict | None = None,
             control: bool = False) -> dict:
    """One run of ``workload``; returns the result line as a dict. The
    overrides replace keys of the configuration and the mix (the tests'
    small sizes). ``control`` also reads the family's control (the
    reference in a lower precision in the program's place) on what the
    window served, under ``"control"`` (``control.py``; never in a
    benchmark run)."""
    bench = bench or load_benchmark()
    files = cell_files(bench, workload)
    config = {**files["config"], **(config_override or {})}
    mix = check_mix({**load_mix(files["mix"]), **(mix_override or {})})
    family = load_module(files["family"],
                         "portbench_family_" + config["family"])
    on_card = device.type == "cuda"

    t_setup = time.perf_counter()
    sut = family.setup(config, mix, seed, device)
    if on_card:
        torch.cuda.synchronize()
    run = Run(setup_s=time.perf_counter() - t_setup)

    kept = drive(sut, mix, seed, seconds, trace, run)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run's process holds {found} after the window")
    facts = sut.facts()
    print(f"portbench: {workload} seed {seed}: set-up {run.setup_s:.3f} s, "
          f"window {run.window_s:.3f} s, {len(run.served)} requests; "
          f"program: {facts}", file=sys.stderr, flush=True)
    # the program's state (weights, plans, graph pools) is freed before the
    # reference runs; the engine's objects hold cycles, so collect them
    sut.close()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        print(f"portbench: program freed, "
              f"{torch.cuda.memory_allocated(device)} bytes left on the card",
              file=sys.stderr, flush=True)

    failed = [s for s in run.served if s.status != "completed"]
    answered = [(f, a) for f, a in kept if a is not None]
    checks, run.work = family.after_window(
        config, mix, seed, device, answered, facts, run.traced_fields)
    if control:
        control_readings = family.control(config, mix, seed, device, answered)
    correct = (not failed and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))

    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.served),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    if control:
        result["control"] = control_readings
    result["checks"] = checks
    return result
