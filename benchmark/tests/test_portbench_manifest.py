"""BENCHMARK.json against the benchmark's contract: keys, characters,
files found by name, metrics reported where their ``moves`` is."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import load_cell

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
M = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (CHECKOUT / p).is_dir()
        assert not p.endswith("_torch")
    assert (CHECKOUT / M["command"][1]).is_file()
    assert 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in M["configs"]] + CELLS + [
        m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    c = load_cell(cell, M)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in M["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_file_is_found_by_name():
    for c in M["configs"]:
        f = CHECKOUT / c["file"]
        assert f.is_file() and c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        conf = json.loads(f.read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and all(k in conf for k in c["reduced"])
        assert set(conf["limits"]) >= {"reduced_bytes_off", "restore_bytes_over_1lsb"}
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    for w in M["workloads"]:
        t = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "drivers" / f"{t['driver']}.py").is_file()
    for m in M["end_to_end"]:
        assert (ROOT / "end_to_end" / f"{m['name']}.py").is_file()
    for m in M["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert (ROOT / "roofline" / f"{m['name'][:-len('_roofline')]}.py").is_file()
