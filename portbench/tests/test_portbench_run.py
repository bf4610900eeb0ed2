"""The command: no result without a card, none without the program."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scn-unet-m16.rooms", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py runs the cell")
    p = run(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
