"""The traffic generator's arrival processes, and the harness's window
over an open-loop mix: requests arrive at times drawn from the seed, and
their latency runs from the arrival."""
from __future__ import annotations

import time

import numpy as np
import pytest

from portbench import harness
from portbench.frozen.traffic import ArrivalTimes, check_mix
from portbench.tests.conftest import LM, SCN

OPEN = {
    "poisson": {"bursts": {"rate_per_s": 40.0, "size": [1, 1]}},
    "periodic": {"periodic": {"rate_per_s": 10.0, "streams": 2}},
    "bursts": {"bursts": {"rate_per_s": 5.0, "size": [2, 6]}},
}


def open_mix(kind: str, **extra) -> dict:
    return {"loop": "open", "arrivals": OPEN[kind], "trace_waves": 2,
            "request": {"room": {"choice": [0, 1, 2]}}, **extra}


def times(mix: dict, seed: int, n: int) -> np.ndarray:
    arr = ArrivalTimes(mix, seed)
    return np.array([arr.next() for _ in range(n)])


@pytest.mark.parametrize("kind", sorted(OPEN))
def test_arrivals_are_the_seeds_and_in_order(kind):
    mix = check_mix(open_mix(kind))
    a, b = times(mix, 2**33 + 5, 400), times(mix, 2**33 + 5, 400)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, times(mix, 2**33 + 6, 400))
    assert (np.diff(a) >= 0).all() and a[0] >= 0


def test_arrival_rates_and_shapes():
    poisson = times(check_mix(open_mix("poisson")), 7, 4000)
    assert 4000 / poisson[-1] == pytest.approx(40.0, rel=0.1)
    assert len(np.unique(poisson)) == 4000
    per = times(check_mix(open_mix("periodic")), 7, 200)
    for k in range(2):  # each stream every 0.1 s
        assert np.allclose(np.diff(per[k::2]), 0.1)
    assert per[:2].max() < 0.1
    bursts = times(check_mix(open_mix("bursts")), 7, 3000)
    instants, sizes = np.unique(bursts, return_counts=True)
    assert sizes.min() >= 2 and sizes.max() <= 6
    assert len(instants) / instants[-1] == pytest.approx(5.0, rel=0.15)


@pytest.mark.parametrize("mix", [
    {"loop": "open", "arrivals": {"uniform": {"rate_per_s": 1.0}}},
    {"loop": "open", "arrivals": {"bursts": {"rate_per_s": 0.0,
                                             "size": [1, 1]}}},
    {"loop": "open", "arrivals": {"periodic": {"rate_per_s": 2.0}}},
    {"loop": "open"},
    {"loop": "closed", "clients": 0},
    {"loop": "sometimes", "clients": 3},
], ids=["unknown", "no_rate", "missing_streams", "no_arrivals",
        "no_clients", "unknown_loop"])
def test_mixes_the_generator_does_not_know_are_refused(mix):
    with pytest.raises(ValueError):
        check_mix(mix)


class Handle:
    def __init__(self, fields):
        self.fields, self.status = fields, "queued"

    def done(self):
        return self.status == "completed"


class FakeEngine:
    """Serves up to ``batch`` queued requests a wave, in ``wave_s``."""

    def __init__(self, batch: int, wave_s: float):
        self.batch, self.wave_s, self.queue, self.waves = batch, wave_s, [], []

    def submit(self, fields):
        h = Handle(fields)
        self.queue.append(h)
        return h

    def serve_wave(self):
        take, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        time.sleep(self.wave_s)
        for h in take:
            h.status = "completed"
        self.waves.append(len(take))

    def answer(self, h):
        return h.fields["index"]

    def units(self, h):
        return {"scenes": 1}

    def wave_stats(self):
        return list(self.waves)

    def counters(self):
        return {}


def test_open_window_sends_every_due_arrival_and_times_from_it():
    mix = check_mix(open_mix("periodic"))
    seed, seconds = 2**32 + 11, 0.6
    due = times(mix, seed, 64)
    due = due[due < seconds]
    engine, run = FakeEngine(batch=4, wave_s=0.03), harness.Run()
    kept = harness.drive(engine, mix, seed, seconds, False, run)
    assert [f["index"] for f, _ in kept] == list(range(len(due)))
    assert len(run.completed()) == len(due) == sum(engine.waves)
    t0 = run.served[0].t_submit - due[0]
    got = sorted(s.t_submit - t0 for s in run.served)
    assert np.allclose(got, due, atol=1e-9)
    # each waited at least its own wave, and never for long at this load
    lat = run.latencies_s()
    assert min(lat) >= 0.03 and max(lat) < 0.5
    assert run.window_s >= seconds


def test_open_window_counts_the_wait_behind_a_busy_engine():
    mix = check_mix(open_mix("bursts"))
    engine, run = FakeEngine(batch=1, wave_s=0.02), harness.Run()
    harness.drive(engine, mix, 5, 0.5, False, run)
    # a burst of n served one a wave: its last waits n waves from arrival
    assert max(run.latencies_s()) >= 2 * 0.02
    assert all(w == 1 for w in engine.waves)


@pytest.mark.parametrize("cell", [SCN, LM])
def test_a_cell_runs_on_an_open_loop_mix(small_run, cell):
    mix = {"loop": "open", "arrivals": OPEN["periodic"]}
    r = small_run(cell, seconds=1.0, mix_override=mix)
    due = times(check_mix(mix), 12345678901, 200)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] == int((due < 1.0).sum())
