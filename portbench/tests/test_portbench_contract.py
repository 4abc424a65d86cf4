"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name under ``portbench/``."""
import json
import re
from pathlib import Path

import pytest

from portbench import cases

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"] and B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # A full check of 24 cells at this run length fits in 43,200 s.
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_workloads():
    names = [w["name"] for w in B["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(names)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        row = cases.cell(w["name"])  # configuration, traffic and limits found by name
        control = row["control"]
        assert set(control) <= {"dtype", "tf32", "intrinsic_dtype"} and row["limits"]
        assert control["dtype"] in ("float32", "float64")


def test_metrics():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in B["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2  # setup_s and at least one more
        assert any(cell in m["workloads"] for m in B["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_files_are_named_from_names(cell):
    row = cases.cell(cell)
    for path in (f"configs/{row['config']}.json", f"traffic/{row['traffic']}.json",
                 f"cells/{cell}.json"):
        assert re.match(r"^[A-Za-z0-9_./-]+$", path)
