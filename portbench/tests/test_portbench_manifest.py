"""BENCHMARK.json against the contract's shapes, the files each entry
names, and a cell added by data alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import manifest, run

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:3] == ["python3", "-m", "portbench.run"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert c["reduced"] == config["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in config for k in c["reduced"])
        assert config["assumed"]["pool"] >= 2
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "portbench/mixes" / f"{w['traffic']}.json").exists()
        names.append(w["name"])
    # a cell of four chips: at most a quarter of the cells, and one always
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"decode_Gints_s", "decode_p95_ms", "encode_Gints_s",
                   "bpi", "setup_s"}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for name in names:
        assert NAME.match(name), name
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    for cell in manifest.cells():
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        if "_roofline" in " ".join(m["name"] for m in cell.per_layer):
            assert all(m["unit"] == "%" for m in cell.per_layer
                       if m["name"].endswith("_roofline"))


def test_a_mix_file_adds_a_cell(tmp_path):
    """A new traffic mix is a data file and entries: the harness finds the
    cell by name and runs it, and every file that was there is
    unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    (tmp_path / "portbench/mixes/write-d4.json").write_text(json.dumps({
        "call": "encode", "sections": 4, "clients": 1,
        "why": "closed loop, one client: a prepared encode of 4 sections"}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    name = "ansfold2-zipf125.write-d4"
    bench["workloads"].append({
        "name": name, "config": "ansfold2-zipf125", "traffic": "write-d4",
        "chips": 1, "why": "the blocked container's prepared encode"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ansfold2-zipf125.write" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    listed = {c.name: c for c in manifest.cells(tmp_path)}
    cell = listed[name]
    assert cell.mix["sections"] == 4
    assert {m["name"] for m in cell.end_to_end} == {"encode_Gints_s", "bpi",
                                                    "setup_s"}
    res = run.run_cell(cell, 7, 0.2, False, "cpu", time.perf_counter(),
                       n=1 << 14)
    assert res["correct"] is True and set(res["metrics"]) == {
        "encode_Gints_s", "bpi", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
