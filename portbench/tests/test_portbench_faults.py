"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have (no cell exchanges anything between
chips), and a sound run comes out correct. Each fault is planted in the
program where its answer is produced; the run is the harness's own, past
its look for a card."""
from __future__ import annotations

import pytest

from portbench.tests.conftest import LM, SCN


@pytest.mark.parametrize("cell", [SCN, LM])
def test_a_sound_run_is_correct(small_run, cell):
    r = small_run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


def test_scn_an_answer_altered_where_it_is_produced(small_run, monkeypatch):
    from repro_torch.serving.scene_engine import SceneEngine

    drain = SceneEngine._drain_stage

    def altered(self, reqs, logits):
        drain(self, reqs, logits)
        row = reqs[0].logits
        row[0] = row[0] + 1e-2 * abs(row).max()

    monkeypatch.setattr(SceneEngine, "_drain_stage", altered)
    assert not small_run(SCN)["correct"]


def test_scn_half_of_the_wave_left_out(small_run, monkeypatch):
    from repro_torch.serving.scene_engine import SceneEngine

    run_wave = SceneEngine.run_wave

    def half(self, feats, plans, capacity, **kw):
        keep = max(len(feats) // 2, 1)
        feats = list(feats[:keep]) + [f * 0 for f in feats[keep:]]
        return run_wave(self, feats, plans, capacity, **kw)

    monkeypatch.setattr(SceneEngine, "run_wave", half)
    assert not small_run(SCN)["correct"]


def test_scn_a_wave_that_returns_the_last_waves_state(small_run,
                                                     monkeypatch):
    from repro_torch.serving.scene_engine import SceneEngine

    run_wave = SceneEngine.run_wave
    last = {}

    def stale(self, feats, plans, capacity, **kw):
        out = run_wave(self, feats, plans, capacity, **kw)
        prev, last["out"] = last.get("out", out), out
        return prev

    monkeypatch.setattr(SceneEngine, "run_wave", stale)
    assert not small_run(SCN)["correct"]


def test_lm_half_of_the_wave_left_out(small_run, monkeypatch):
    from repro_torch.serving.engine import Engine

    dispatch = Engine._dispatch_stage

    def half(self, reqs, rows, stats):
        keep = max(len(rows) // 2, 1)
        rows = list(rows[:keep]) + [r * 0 for r in rows[keep:]]
        return dispatch(self, reqs, rows, stats)

    monkeypatch.setattr(Engine, "_dispatch_stage", half)
    assert not small_run(LM)["correct"]


def test_lm_a_token_altered_where_it_is_produced(small_run, monkeypatch):
    from repro_torch.serving.engine import Engine

    drain = Engine._drain_stage

    def altered(self, reqs, emitted):
        drain(self, reqs, emitted)
        for r in reqs:
            r.out[1] = (r.out[1] + 1) % self.cfg.vocab_size

    monkeypatch.setattr(Engine, "_drain_stage", altered)
    assert not small_run(LM)["correct"]


def test_lm_a_step_that_returns_its_state_unchanged(small_run, monkeypatch):
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "cache_update_decode",
                        lambda ck, cv, k, v, t, ring: (ck, cv))
    assert not small_run(LM)["correct"]


def test_a_failed_request_is_not_correct(small_run, monkeypatch):
    from repro_torch.serving.scheduler import WaveScheduler

    finish = WaveScheduler._finish
    calls = {"n": 0}

    def lose_one(self, reqs, st):
        calls["n"] += 1
        if calls["n"] == 3:
            self.fail_request(reqs[0], RuntimeError("lost"))
            reqs = reqs[1:]
        finish(self, reqs, st)

    monkeypatch.setattr(WaveScheduler, "_finish", lose_one)
    r = small_run(SCN)
    assert r["failed"] >= 1 and not r["correct"]
