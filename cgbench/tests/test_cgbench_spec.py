"""Every cell, configuration, mix, metric and work count of BENCHMARK.json
loads by its name, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from cgbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert spec.BENCHMARK.stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["cgbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.fullmatch(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    assert all(UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
               for m in METRICS)
    assert all(_line(e["why"]) for e in BENCH["configs"] + BENCH["workloads"])
    assert all(_line(c["source"]) for c in BENCH["configs"])


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"cgbench/configs/{c['name']}.json"
        data = spec.load_json("configs", c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert CELLS == ["p2d3200.fp32_stream", "p2d1000.fp32_resident",
                     "p2d3200.fp32_neumann_stream"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"solve_s", "solve_p95_s", "peak_mem_gib", "setup_s"} == e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "kernels_roofline", "device_idle_pct", "launches_per_iter", "us_per_iter",
        "iters_per_solve"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] == "solve_s" and m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    roof = next(m for m in BENCH["per_layer"] if m["name"].endswith("_roofline"))
    assert roof["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    c = spec.load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:  # each moves an end-to-end metric this cell reports
        assert m["moves"] in names
    for m in METRICS:
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_its_pieces_by_name(cell):
    c = spec.load_cell(cell)
    assert c.mix["loop"] == "closed" and c.mix["clients"] == 1
    assert set(c.cell["limits"]) == {"x_gap", "k_gap", "residual_over_tol", "unconverged"}
    assert c.cell["limits"]["unconverged"] == 0 and int(c.cell["judged"]) >= 1
    # the mix's tolerance is the configuration's own limit on the residual
    assert c.cell["limits"]["residual_over_tol"] == 1.0
    assert callable(spec.load_module("work", c.cell["work"]["method"]).count)
    assert callable(spec.load_module("problems", c.config["problem"]).operator)
    ref = spec.load_module("reference", c.config["problem"])
    assert ref.size(c.config) == c.config["n"]
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_every_file_of_a_kind_belongs_to_a_name():
    assert {p.stem for p in (spec.HERE / "cells").glob("*.json")} == set(CELLS)
    used = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (spec.HERE / "mixes").glob("*.json")} == used
    assert {p.stem for p in (spec.HERE / "metrics").glob("*.py")} == {m["name"] for m in METRICS}


def test_names_outside_the_pattern_are_refused():
    with pytest.raises(ValueError):
        spec.load_json("configs", "../BENCHMARK")
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_benchmark_json_is_plain_json():
    json.loads(spec.BENCHMARK.read_text())
