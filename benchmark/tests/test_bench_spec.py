"""BENCHMARK.json against the limits its format sets (names, units, sizes,
bounds, the check's time budget), and every file a cell needs found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"] and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_sources():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert _line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file()
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (ROOT / "benchmark" / "limits" / f"{cell}.json").is_file()
    for m in SPEC["per_layer"]:
        if _reports(m, cell):
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
            assert _reports(next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"]), cell)
    reported = [m for m in SPEC["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(_reports(m, cell) for m in SPEC["per_layer"])


def test_cells_and_configs():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
