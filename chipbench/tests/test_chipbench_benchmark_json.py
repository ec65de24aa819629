"""BENCHMARK.json against the contract's form: names, units and lines
of the allowed characters, every cell's files where the harness looks
for them, the metrics' cells and `moves`, the bounds and the run
length."""
from __future__ import annotations

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = ROOT / "chipbench"


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names(name):
    assert NAME.match(name), name


def test_keys_units_lines():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_find_their_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "workloads" / f"{w['traffic']}.json")
                             .read_text())
        assert (HERE / "drivers" / f"{traffic['kind']}.py").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        got = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
