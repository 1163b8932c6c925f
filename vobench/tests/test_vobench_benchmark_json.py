"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
bounds, and every file a cell needs."""

import json
import pathlib
import re

import pytest

from vobench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "vobench/run.py"] and BENCH["paths"] == ["vobench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank"))]
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("vobench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        if m["name"].endswith("_roofline_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["entry"] in harness.ENTRIES
    assert {"frames_per_s", "pose_latency_ms_p90", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    from vobench import check

    assert set(c.limits) | set(check.EXACT) >= {"pose_gap_um", "kp_off", "decisions_off"}
    assert all(v >= 0 for v in c.limits.values())
