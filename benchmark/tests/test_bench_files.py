"""BENCHMARK.json against its format rules and against the files it names:
every cell's file names an existing configuration, traffic and driver,
every per-layer metric has a reader that agrees with its entry, names
and units keep to their character sets, and a full check of 24 cells
fits its time."""

from __future__ import annotations

import json
import os
import re

import pytest

import tiny  # noqa: F401  (puts benchmark/ on the path)
from harness import Cell, benchmark_spec, cell_metrics, metric_reader

ROOT = tiny.ROOT
SPEC = benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    cell = Cell.load(w["name"])
    assert cell.spec["config"] == w["config"] and cell.spec["traffic"] == w["traffic"]
    assert cell.spec["chips"] == w["chips"] == cell.config["chips"]
    assert cell.spec["why"] == w["why"] and len(w["why"]) <= 200
    assert os.path.exists(os.path.join(ROOT, "drivers", cell.spec["driver"] + ".py"))
    assert hasattr(cell.driver(), "Driver")
    assert set(cell.spec["limits"]) and all(v >= 0 for v in cell.spec["limits"].values())
    assert w["config"] in {c["name"] for c in SPEC["configs"]}
    reports = {m["name"] for m in cell_metrics(SPEC, w["name"], "end_to_end")}
    assert "setup_s" in reports and len(reports) >= 2
    assert cell_metrics(SPEC, w["name"], "per_layer")


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    with open(os.path.join(tiny.REPO, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []
    assert c["file"].startswith("benchmark/configs/")
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_agrees(m):
    mod = metric_reader(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["better"], m["source"], m["moves"])
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_names_units_and_sources():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for section in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[section]}) == len(SPEC[section])
    for x in metrics + SPEC["configs"] + SPEC["workloads"]:
        assert NAME.match(x["name"]), x["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_rooflines_have_a_step_mfu_beside_them(w):
    per = cell_metrics(SPEC, w["name"], "per_layer")
    moves = {m["moves"] for m in per if "_roofline" in m["name"]}
    assert moves <= {m["moves"] for m in per if m["name"].startswith("mfu")}
