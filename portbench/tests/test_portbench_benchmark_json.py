"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its files."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness
from portbench.frozen.traffic import load_mix

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in BENCH["configs"]] + CELLS
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert harness.reader_path(metric["name"]).is_file()
    assert hasattr(harness.reader(metric["name"]), "read")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("text", [x[k] for group in (
    BENCH["configs"], BENCH["workloads"], BENCH["per_layer"])
    for x in group for k in ("why", "layer", "source") if k in x]
    + BENCH["command"])
def test_free_text_is_one_short_line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_fields():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # every cell it lists reports the metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_and_reports_enough(cell):
    files = harness.cell_files(BENCH, cell)
    assert files["family"].is_file() and files["mix"].is_file()
    load_mix(files["mix"])
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, True)


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["name"] == c["name"]


def test_run_seconds_fit_a_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200
