"""The readers of the program's own spans, counters and CUDA-event timings:
on a small CPU run of each cell, on a run with planted records, and on a
program that has none of them; the idle split by innermost span."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.frozen.trace import Trace
from portbench.tests.conftest import LM, SCN

SCN_SPANS = ["serve_admit", "serve_plan", "serve_dispatch", "serve_drain",
             "scene_upload", "scene_stage", "scene_replay", "scene_wait",
             "scene_readback", "scene_finish"]
LM_SPANS = ["serve_admit", "serve_plan", "serve_dispatch", "serve_drain",
            "lm_prefill", "lm_decode", "lm_wait", "lm_readback", "lm_finish"]
LEVELS = ["rows", "stem", "level0", "level1", "level2", "level3", "head"]
#: per cell: the readers that read spans or counters (a number on the CPU)
#: and those that read CUDA events (None on the CPU)
READERS = {
    SCN: (["scn_upload_ms_per_scene", "scn_readback_ms_per_scene",
           "scn_finish_ms_per_scene", "scn_readback_mb_per_scene",
           "queue_wait_ms.scn"]
          + [f"scn_idle_ms_per_scene.{s}" for s in SCN_SPANS + ["outside"]],
          ["scn_forward_device_ms_per_scene"]
          + [f"scn_level_device_ms_per_scene.{s}" for s in LEVELS]),
    LM: (["queue_wait_ms.lm"]
         + [f"lm_idle_ms.{s}" for s in LM_SPANS + ["outside"]],
         ["lm_prefill_device_ms", "lm_first_token_ready_ms"]),
}


@pytest.mark.parametrize("cell", [SCN, LM])
def test_readers_on_a_small_cpu_run(small_run, cell):
    res = small_run(cell, trace=True)
    assert res["correct"]
    numbers, events = READERS[cell]
    for name in numbers:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0.0, name
    for name in events:
        assert name not in res["metrics"]
    if cell == SCN:  # the small cell's waves are full: 2 x 2048 x 20 x 4 B
        assert res["metrics"]["scn_readback_mb_per_scene"]["value"] == \
            pytest.approx(2048 * 20 * 4 / 1e6)
    # no device on the CPU: the whole window is idle, most of it under the
    # program's spans
    idle = [v["value"] for k, v in res["metrics"].items() if "_idle_ms" in k]
    assert sum(idle) > 0


def test_new_readers_belong_to_their_cells():
    bench = harness.load_benchmark()
    for cell, (numbers, events) in READERS.items():
        names = {m["name"] for m in harness.metrics_of(bench, cell, True)}
        assert set(numbers + events) <= names
        other = LM if cell == SCN else SCN
        assert not set(numbers + events) & {
            m["name"] for m in harness.metrics_of(bench, other, True)}


def _wave(**kw):
    from repro_torch.serving.scheduler import WaveStats

    return WaveStats(0, (0, 1), True, **kw)


def _planted() -> harness.Run:
    device = [("k", 0, 1_000_000, 1), ("k", 6_000_000, 7_000_000, 2)]
    trace = Trace(0, 10_000_000, device=device, host=[
        ("scene.upload", 1_000_000, 1_500_000),
        ("scene.stage", 5_000_000, 5_500_000),
        ("scene.readback", 2_000_000, 4_000_000),
        ("scene.finish", 4_000_000, 4_250_000),
        ("serve.drain", 1_900_000, 4_300_000)])
    stats = [_wave(event_ms={"forward": 30.0, "prefill": 500.0,
                             "level1": 12.0},
                   readback_bytes=4_000_000, queue_wait_ms=(10.0, 30.0),
                   first_token_ms=(3600.0, 3700.0)),
             _wave(event_ms={"forward": 50.0, "prefill": 520.0,
                             "level1": 16.0},
                   readback_bytes=4_000_000, queue_wait_ms=(20.0, 40.0),
                   first_token_ms=(3800.0, 3900.0))]
    units = [[{"scenes": 1}, {"scenes": 1}]] * 2
    return harness.Run(trace=trace, traced_stats=stats, traced_units=units)


@pytest.mark.parametrize("name,want", [
    ("scn_upload_ms_per_scene", 1.0 / 4),
    ("scn_readback_ms_per_scene", 2.0 / 4),
    ("scn_finish_ms_per_scene", 0.25 / 4),
    ("scn_readback_mb_per_scene", 8.0 / 4),
    ("scn_forward_device_ms_per_scene", 80.0 / 4),
    ("lm_prefill_device_ms", 510.0),
    ("lm_first_token_ready_ms", 3750.0),
    ("queue_wait_ms.scn", 25.0),
    ("queue_wait_ms.lm", 25.0),
    ("scn_level_device_ms_per_scene.level1", 28.0 / 4),
    # idle: 1-6 ms and 7-10 ms of the window, split by the innermost span
    ("scn_idle_ms_per_scene.scene_upload", 0.5 / 4),
    ("scn_idle_ms_per_scene.serve_drain", 0.15 / 4),
    ("scn_idle_ms_per_scene.scene_readback", 2.0 / 4),
    ("scn_idle_ms_per_scene.scene_finish", 0.25 / 4),
    ("scn_idle_ms_per_scene.scene_stage", 0.5 / 4),
    ("scn_idle_ms_per_scene.outside", 4.6 / 4),
    ("lm_idle_ms.outside", 4.6 / 2),
])
def test_readers_read_planted_records(name, want):
    assert harness.reader(name).read(_planted()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(
    {n for numbers, events in READERS.values() for n in numbers + events}))
def test_a_program_without_the_records_reads_none(name):
    """The parent's program: its ``WaveStats`` lack the counters and event
    timings, its trace lacks the spans."""
    old = SimpleNamespace(plan_ms=1.0, device_ms=2.0, notes={})
    run = harness.Run(trace=Trace(0, 10, host=[("portbench.wave", 0, 10)]),
                      traced_stats=[old, old],
                      traced_units=[[{"scenes": 1, "tokens": 4}]] * 2)
    assert harness.reader(name).read(run) is None


@pytest.mark.parametrize("name", [f"scn_idle_ms_per_scene.{s}" for s in (
    "serve_admit", "serve_plan", "scene_wait")] + ["lm_idle_ms.lm_wait"])
def test_a_span_missing_from_the_window_reads_none(name):
    assert harness.reader(name).read(_planted()) is None


def test_idle_split_adds_up_to_the_idle_time():
    """Every idle nanosecond goes to one name; nested and back-to-back
    spans, a span over the window's edge and a busy stretch under a span."""
    device = [("k", 0, 2, 1), ("k", 30, 35, 2), ("k", 90, 95, 3)]
    host = [("portbench.wave", 0, 100), ("aten::mm", 3, 9),
            ("serve.drain", 10, 40), ("scene.readback", 10, 20),
            ("scene.finish", 20, 34), ("serve.plan", 38, 50),
            ("serve.plan", 50, 60), ("serve.dispatch", 85, 120),
            ("scene.upload", 85, 90)]
    tr = Trace(0, 100, device=device, host=host)
    split = spans.idle_split(tr)
    want = {"serve.drain": 3, "scene.readback": 10, "scene.finish": 10,
            "serve.plan": 12 + 10, "serve.dispatch": 5, "scene.upload": 5,
            spans.OUTSIDE: 8 + 25}
    assert split == pytest.approx({k: v / 1e6 for k, v in want.items()})
    idle = sum(e - s for s, e in tr.idle_gaps())
    assert sum(split.values()) == pytest.approx(idle / 1e6)
    assert spans.idle_split(Trace(0, 100, device=device,
                                  host=host[:2])) is None
