"""Each cell's control, the reference in the next lower precision put in
the program's place, fails the cell's limit (at the small size here; on the
card at the cell's own size by ``portbench/control.py``)."""
from __future__ import annotations

from portbench.tests.conftest import LM, SCN


def test_scn_tf32_control_fails_the_limit(small_run):
    r = small_run(SCN, control=True)
    limit = r["checks"]["logits_rel_err"]["limit"]
    assert r["checks"]["logits_rel_err"]["value"] < limit
    assert r["control"]["logits_rel_err"] > 3 * limit


def test_lm_fp8_control_fails_the_limit(small_run):
    worst = 0.0
    for seed in (1, 2, 3):
        r = small_run(LM, seed=seed, control=True)
        assert r["correct"]
        worst = max(worst, r["control"]["token_logit_gap"])
    assert worst > r["checks"]["token_logit_gap"]["limit"]
