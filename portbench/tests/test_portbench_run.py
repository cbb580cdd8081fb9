"""A run of each cell at a small n on the CPU (the port's plain versions in
the kernels' place): the result line, the refusal without a card, the
faults that `correct` must catch, and the byte counts of the rooflines."""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import manifest, program, reference, run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load()["workloads"]]
N = 1 << 14
SEED = (1 << 31) + 977


def small_run(name, trace=False, seed=SEED):
    return run.run_cell(manifest.cell(name), seed, 0.2, trace, "cpu",
                        time.perf_counter(), n=N)


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    res = small_run(name)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = manifest.cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert all(c == {"value": 0, "limit": 0} or
               (c["value"] == 0.0 and c["limit"] == 0)
               for c in res["checks"].values())


def test_traced_run_reports_per_layer_metrics_only():
    res = small_run("ansfold2-zipf125.write", trace=True)
    names = {m["name"] for m in manifest.cell(
        "ansfold2-zipf125.write").per_layer}
    # the CPU has no device trace: the readers of the trace return nothing
    assert set(res["metrics"]) == names - {"encode_roofline", "idle.write"}
    assert set(res["metrics"]) == {"launches.write"}
    assert "busy_s" not in res["device"] and res["correct"] is True


def test_a_read_cell_reports_the_model_build_of_its_pool():
    res = small_run("ans-zipf20.read", trace=True)
    assert set(res["metrics"]) == {"model_build_s", "launches.read"}
    assert res["metrics"]["model_build_s"]["value"] > 0


def test_no_card_no_result():
    """Without CUDA the command prints nothing on stdout and fails: it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    err = json.loads(proc.stderr.strip().splitlines()[-1])
    assert err["error"] == "no card" and err["cuda_available"] is False


def _faulty(monkeypatch, alter):
    """Stage the program as usual, then break its output underneath."""
    stage = program.stage

    def broken(config, mix, xs, device):
        staged = stage(config, mix, xs, device)
        staged.calls = [lambda call=call: alter(call(), staged)
                        for call in staged.calls]
        return staged
    monkeypatch.setattr(program, "stage", broken)


def _another_arrays_output(monkeypatch):
    """Each request returns what the next array of the pool gives."""
    stage = program.stage

    def broken(config, mix, xs, device):
        staged = stage(config, mix, xs, device)
        staged.calls = staged.calls[1:] + staged.calls[:1]
        return staged
    monkeypatch.setattr(program, "stage", broken)


def _value_altered(out, staged):
    out = out.clone()
    out.view(-1)[7] ^= 1
    return out


def _half_of_the_batch(out, staged):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _unchanged(out, staged):
    if staged.kind == "decode":
        return torch.zeros_like(out)
    stream, states = out
    return stream, torch.full_like(states, reference.A_L)


def _byte_altered(out, staged):
    stream, states = out
    stream = stream.clone()
    stream[len(stream) // 2] ^= 0x10
    return stream, states


FAULTS = [("ansfold2-zipf125.read", _value_altered),
          ("ans-zipf20.read", _value_altered),
          ("ansfold2-zipf125.read-d32", _value_altered),
          ("ansfold2-zipf125.read-d32", _half_of_the_batch),
          ("ansfold2-zipf125.read", _unchanged),
          ("multihost-zipf20.shard4", _value_altered),
          ("multihost-zipf20.shard4", _half_of_the_batch),
          ("multihost-zipf20.shard4", _unchanged),
          ("ansfold2-zipf125.write", _byte_altered),
          ("ansfold2-zipf125.write", _unchanged)]


@pytest.mark.parametrize("name,alter", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, alter):
    _faulty(monkeypatch, alter)
    res = small_run(name)
    assert res["correct"] is False
    assert any(c["value"] > 0 for c in res["checks"].values())


@pytest.mark.parametrize("name", ["ansfold2-zipf125.read",
                                  "ansfold2-zipf125.write"])
def test_another_arrays_output_is_not_correct(monkeypatch, name):
    _another_arrays_output(monkeypatch)
    res = small_run(name)
    assert res["correct"] is False
    key = "values_wrong" if name.endswith("read") else "stream_bytes_wrong"
    assert res["checks"][key]["value"] > 0


def test_an_altered_blob_is_not_correct(monkeypatch):
    stage = program.stage

    def broken(config, mix, xs, device):
        staged = stage(config, mix, xs, device)
        for i, blob in enumerate(staged.blobs):
            b = bytearray(blob)
            b[-1] ^= 1
            staged.blobs[i] = bytes(b)
        return staged
    monkeypatch.setattr(program, "stage", broken)
    res = small_run("ansfold2-zipf125.read")
    assert res["correct"] is False
    # a read checks the blob of one array of the pool
    assert res["checks"]["blob_bytes_wrong"]["value"] == 1


def test_request_bytes_from_shapes():
    ref = SimpleNamespace(streams=[np.zeros(1000, np.uint8),
                                   np.zeros(24, np.uint8)],
                          states=np.zeros((2, 32), np.uint32), sigma=10,
                          exception_bytes=300)
    assert run.request_bytes("decode", 5000, ref) == 1024 + 256 + 160 + 20000
    assert run.request_bytes("encode", 5000, ref) == (20000 + 300 + 160
                                                      + 1024 + 256)


def test_banned_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ans_tpu_torch_lookalike", sys)
    assert "ans_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]


def test_result_line_is_json_and_checks_come_last(capsys):
    res = small_run("ansfold2-zipf125.read")
    line = json.dumps(res)
    assert list(json.loads(line))[-1] == "checks"
