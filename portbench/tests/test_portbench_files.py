"""The benchmark's files: every configuration, cell, traffic mix and
per-layer metric loads by the name ``BENCHMARK.json`` gives it, and the
file keeps to the contract's forms (names, units, lengths, bounds)."""

from __future__ import annotations

import re

import pytest

from portbench import run as harness

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(harness.json.dumps(BENCH)) <= 64 * 1024


def test_full_check_fits_its_time_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = harness.load_json(harness.CHECKOUT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files_load_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    spec = harness.cell_spec(cell["name"], BENCH)
    for key in ("config", "traffic", "chips", "why"):
        assert spec["cell"][key] == cell[key]
    assert (harness.ROOT / "traffic" / f"{spec['mix']['kind']}.py").exists()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:  # what a per-layer metric moves, the cell reports
        assert m["moves"] in e2e
    assert spec["cell"]["limits"]


def test_names_unique_and_pairs_once():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_forms(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert one_line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_declares_what_benchmark_json_says(metric):
    reader = harness.load_module(harness.ROOT / "metrics" / f"{metric['name']}.py", "reader")
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES, reader.BETTER) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"], metric["better"])
    assert reader.WORKLOADS == metric["workloads"]
    assert callable(reader.read)


def test_layers_named_alike_and_end_to_end_everywhere():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
    for cell in BENCH["workloads"]:
        spec = harness.cell_spec(cell["name"], BENCH)
        assert "setup_s" in {m["name"] for m in spec["end_to_end"]}


def test_every_file_under_paths_is_named_from_name_characters():
    for p in harness.ROOT.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(harness.CHECKOUT).as_posix()
        assert PATH.match(rel), rel
