"""The trace reduction on a hand-made event list: device time, idle gaps,
graph replays' kernels, and the benchmark's spans kept off the device."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.frozen import trace


class Evt:
    def __init__(self, name, start, dur, device=False, corr=0, ann=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._a = device, corr, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def profile_of(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


EVENTS = [
    Evt("portbench.window", 100, 1000, ann=True),
    Evt("portbench.wave", 100, 900, ann=True),
    Evt("portbench.wave", 150, 800, device=True),   # its device-side range
    Evt("cudaGraphLaunch", 120, 10, corr=7),
    Evt("aten::copy_", 600, 100),
    Evt("k1", 200, 100, device=True, corr=7),
    Evt("k2", 250, 150, device=True, corr=7),
    Evt("k3", 700, 100, device=True, corr=9),
    Evt("outside", 5000, 10, device=True),
]


def test_busy_idle_and_graph_kernels():
    tr = trace.read_profile(profile_of(EVENTS), "portbench.window")
    assert tr.window_s == pytest.approx(1000e-9)
    assert [n for n, *_ in tr.device] == ["k1", "k2", "k3"]
    assert tr.busy_intervals() == [(200, 400), (700, 800)]
    assert tr.busy_s() == pytest.approx(300e-9)
    assert tr.idle_gaps() == [(100, 200), (400, 700), (800, 1100)]
    assert tr.graph_launches == {7}
    assert tr.device_seconds(lambda n: n == "k2") == pytest.approx(150e-9)


def test_idle_time_by_what_the_host_was_doing():
    tr = trace.read_profile(profile_of(EVENTS), "portbench.window")
    # each gap goes to the innermost host span open where it begins
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"portbench.wave": 700e-9})
    assert tr.host_labels([150, 650, 1050]) == [
        "portbench.wave", "aten::copy_", "portbench.window"]
    ops = dict(tr.breakdown()["device_ops"])
    assert ops == pytest.approx({"k1": 100e-9, "k2": 150e-9, "k3": 100e-9})


def test_one_window_span_is_required():
    with pytest.raises(RuntimeError):
        trace.read_profile(profile_of(EVENTS[1:]), "portbench.window")
