"""BENCHMARK.json against the contract's shapes, the files each entry
names, a cell added by data alone, a codec added by files alone, and what
the lane codec's cells read through the lookup."""

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, inputs, manifest, ranks, run, spans

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


# a toy codec: the lane codec's blob behind a tag of its own, on each side;
# its control flips one bit of the first value
TAGGED_PROGRAM = """\
from portbench import program

TAG = b"TAG1"
STAGED = []  # the arrays of each stage call


def stage(config, mix, xs, device):
    STAGED.append(len(xs))
    staged = program.stage(config, mix, xs, device)
    staged.blobs = [TAG + b for b in staged.blobs]
    return staged


def decoded_values(out, n, sections):
    return program.decoded_values(out, n, sections)
"""
TAGGED_REFERENCE = """\
import numpy as np

from portbench import reference


def encode(method, x, lanes, sections=0, counts=None):
    enc = reference.encode(method, x, lanes, sections, counts)
    enc.blob = b"TAG1" + enc.blob
    return enc


def lossy_values(x):
    y = np.array(x, dtype=np.uint32)
    y[0] ^= 1
    return y
"""


def _copy_with_a_codec(tmp_path, codec, files):
    """A copy of the benchmark with the configuration tagged-zipf20 (that
    of ans-zipf20 under `codec`), its cell tagged-zipf20.read and `files`
    (path under portbench: text); returns the bytes of each file of the
    copy's portbench/ before the additions."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    for rel, text in files.items():
        (tmp_path / "portbench" / rel).parent.mkdir(exist_ok=True)
        (tmp_path / "portbench" / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = next(c for c in bench["configs"] if c["name"] == "ans-zipf20")
    config = json.loads((ROOT / base["file"]).read_text())
    file = "portbench/configs/tagged-zipf20.json"
    (tmp_path / file).write_text(json.dumps(dict(
        config, name="tagged-zipf20", codec=codec)))
    bench["configs"].append(dict(base, name="tagged-zipf20", file=file))
    name = "tagged-zipf20.read"
    bench["workloads"].append({
        "name": name, "config": "tagged-zipf20", "traffic": "read",
        "chips": 1, "why": "the large alphabet under a codec of its own"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ans-zipf20.read" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


def test_a_codec_of_new_files_adds_a_configuration(tmp_path):
    """A configuration that names a codec of its own, the codec's two
    files and a cell: the run, the control and the span run go through
    the codec's program and reference sides, and every file that was
    there is unchanged."""
    before = _copy_with_a_codec(tmp_path, "tagged", {
        "codecs/tagged.py": TAGGED_PROGRAM,
        "references/tagged.py": TAGGED_REFERENCE})
    cell = {c.name: c for c in manifest.cells(tmp_path)}["tagged-zipf20.read"]
    assert cell.codec.name == "tagged"
    staged = cell.codec.program.STAGED
    seed, n = (1 << 31) + 2203, 1 << 14
    res = run.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter(),
                       n=n)
    # the program's blobs carry the tag: they equal only a reference that
    # writes it, so the run held them to the toy's reference side
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"decode_Gints_s", "decode_p95_ms", "bpi",
                                   "setup_s"}
    assert staged == [2]
    # the toy's control: its one altered value, and the blob it changes
    got = control.readings(cell, seed, torch.device("cpu"), n)
    assert got["values_wrong"] == 1 and got["blob_bytes_wrong"] > 0
    assert not check.passed(got)
    traced = spans.run_cell(cell, seed, 0.2, True, "cpu", n=n)
    assert traced["failed"] == 0 and traced["prepare_s"] > 0
    assert staged == [2, 2]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_codec_without_its_files_is_refused(tmp_path):
    _copy_with_a_codec(tmp_path, "missing",
                       {"codecs/missing.py": TAGGED_PROGRAM})
    with pytest.raises(KeyError, match="references/missing.py"):
        manifest.cell("tagged-zipf20.read", tmp_path)
    (tmp_path / "portbench/codecs/missing.py").unlink()
    with pytest.raises(KeyError, match="codecs/missing.py"):
        manifest.cell("tagged-zipf20.read", tmp_path)


# What each cell read at N values and seed SEED on the CPU through
# program.stage and reference.encode before the codec lookup (the parent
# commit of the lookup): each call's class, a digest of each set-up blob
# and of each call's first output (a decode's values, an encode's stream
# and states), whether the set-up recorded its model half, the bytes a
# request must move and the control's readings.  Shard4 stages rank 0's
# shard of 4 in one process (its model from that shard alone) and codes
# the reference and the control under the counts of the 4 shards.
N, SEED = 1 << 14, (1 << 31) + 2101
FOLD_CONTROL = {"blob_bytes_wrong": 3730, "bpi_gap": 0.0,
                "values_wrong": 2904}
PARENT = {
    "ansfold2-zipf125.read": dict(
        kind="decode", sections=0, calls=["PreparedDecoder"] * 3,
        blobs=["4a8b16b191478774", "6c438d46578591b1", "e44d7098d8d6ee03"],
        blob_bytes=[31663, 31563, 31887],
        outputs=["3338566f838c274e", "a78d2b8f3e49ef15", "4dd00a71af014b07"],
        model_build=True, request_bytes=111908, control=FOLD_CONTROL),
    "ans-zipf20.read": dict(
        kind="decode", sections=0, calls=["PreparedDecoder"] * 2,
        blobs=["bc7c69d67b45d316", "dc317eb218676031"],
        blob_bytes=[43897, 43754],
        outputs=["7b022c626ae4beaf", "6e558a18a928ace1"],
        model_build=True, request_bytes=233849,
        control={"blob_bytes_wrong": 43664, "bpi_gap": 5.4501953125,
                 "values_wrong": 8623}),
    "ansfold2-zipf125.write": dict(
        kind="encode", sections=0, calls=["PreparedEncoder"] * 3,
        blobs=["4a8b16b191478774", "6c438d46578591b1", "e44d7098d8d6ee03"],
        blob_bytes=[31663, 31563, 31887],
        outputs=["8f31bd606ed85350", "1c0121b3f255f392", "00bb9ceea1061666"],
        model_build=False, request_bytes=115652,
        control={"blob_bytes_wrong": 3730, "bpi_gap": 0.0,
                 "stream_bytes_wrong": 3730, "states_wrong": 0}),
    "ansfold2-zipf125.read-d32": dict(
        kind="decode", sections=32, calls=["PreparedBatchDecoder"] * 3,
        blobs=["0297e71c6270fb99", "7eef84ba47f544d7", "65d136de294012f1"],
        blob_bytes=[534547, 534492, 534787],
        outputs=["3338566f838c274e", "a78d2b8f3e49ef15", "4dd00a71af014b07"],
        model_build=False, request_bytes=614148, control=FOLD_CONTROL),
    "multihost-zipf20.shard4": dict(
        kind="decode", sections=16, calls=["PreparedBatchDecoder"] * 4,
        blobs=["e15d12f9071aacab", "9b71287f2d7fe029", "3eb57bb631ec6bcb",
               "d60a215b0f68ba09"],
        blob_bytes=[267938, 267988, 267950, 267948],
        outputs=["e518e680e59184ed", "3eb13c05587cfc62", "c97f5b480467c9f8",
                 "50070fc01567e743"],
        model_build=True, request_bytes=413818,
        control={"blob_bytes_wrong": 133221, "bpi_gap": 12.4140625,
                 "values_wrong": 2132}),
}


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for a in parts:
        h.update(a if isinstance(a, bytes) else
                 np.ascontiguousarray(a.cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(PARENT))
def test_the_lane_codec_reads_what_it_read_before_the_lookup(name):
    cell = manifest.cell(name)
    assert cell.codec.name == manifest.LANE
    config = dict(cell.config, n=N)
    sections = int(cell.mix.get("sections", 0))
    if cell.mix.get("shards"):
        per = N // cell.chips
        xs = inputs.shard(config, SEED, 0, per, "cpu")
        counts = ranks.summed_counts([
            inputs.shard(config, SEED, r, per, "cpu", count=1)[0]
            for r in range(cell.chips)])
    else:
        xs, counts = inputs.make(config, SEED, "cpu"), None
    staged = cell.codec.program.stage(config, cell.mix, xs,
                                      torch.device("cpu"))
    outputs = []
    for call in staged.calls:
        out = call()
        outputs.append(_digest(cell.codec.program.decoded_values(
            out, len(xs[0]), sections)) if staged.kind == "decode"
            else _digest(*out))
    ref = cell.codec.reference.encode(config["method"], xs[0],
                                      int(config["lanes"]), sections, counts)
    got = dict(kind=staged.kind, sections=staged.sections,
               calls=[type(c).__qualname__ for c in staged.calls],
               blobs=[_digest(b) for b in staged.blobs],
               blob_bytes=[len(b) for b in staged.blobs], outputs=outputs,
               model_build=staged.model_build_ns is not None,
               request_bytes=run.request_bytes(staged.kind, len(xs[0]), ref),
               control=control.readings(cell, SEED, torch.device("cpu"), N))
    assert got == PARENT[name]
