"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""

import importlib
import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("end_to_end", "per_layer"):
        for m in BENCH[key]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.find_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    importlib.import_module(f"benchmark.traffic.{cell.mix['driver']}")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_paths_and_command():
    assert BENCH["paths"] == ["benchmark"]
    assert all((harness.ROOT / p).is_dir() for p in BENCH["paths"])
    assert BENCH["command"][1].startswith("benchmark/")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert all(0 < len(c[k]) <= 200 and "\n" not in c[k] for k in ("source", "why"))
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_reader_found_by_whole_name_then_by_its_first_part():
    assert harness.reader_path("mfu.train").name == "mfu.train.py"
    assert harness.reader_path("idle_share.train").name == "idle_share.py"


def test_per_layer_metric_without_workloads_goes_where_its_moves_is(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "idle_share.any", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_step_ms"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    for name in CELLS:
        reports = {m["name"] for m in harness.find_cell(name, path).per_layer}
        wanted = name in next(m for m in BENCH["end_to_end"]
                              if m["name"] == "train_step_ms")["workloads"]
        assert ("idle_share.any" in reports) == wanted, name
