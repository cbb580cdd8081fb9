"""The cell over several cards, run small by two gloo ranks on the CPU
through the command's own parent: a copy of the benchmark whose sharded
cell asks for 2 chips at a small n, a parent that believes it has two
cards and names the CPU as each rank's device, and ranks that may be
broken underneath.  Each run ends inside its test's limit and leaves no
process behind."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import manifest, ranks

ROOT = Path(__file__).resolve().parents[2]
CELL = "multihost-zipf20.shard4"
N = 1 << 14
SEED = (1 << 31) + 1201
LIMIT = 60  # s a run may take here

PARENT = """\
import sys
sys.path[:0] = [{tmp!r}, {root!r}]
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 2
from portbench import ranks, run
ranks.SETUP_LIMIT = {setup_limit!r}
run.RANK_COMMAND = [sys.executable, {rank!r}]
run.RANK_DEVICE = {rank_device!r}
sys.exit(run.main())
"""

RANK = """\
import sys, time
sys.path[:0] = [{tmp!r}, {root!r}]
from ans_tpu_torch.parallel import multihost
from portbench import program, ranks, run
rank = int(sys.argv[sys.argv.index("--rank") + 1])
stage = program.stage
{everywhere}


def broken(config, mix, xs, device):
    staged = stage(config, mix, xs, device)
    calls, made = staged.calls, [0]

    def fail():
        raise RuntimeError("a broken card")

    def altered(out):
        out = out.clone()
        out.view(-1)[7] ^= 1
        return out

    def late(i):
        made[0] += 1
        if made[0] > 8:  # the window's first: the warm-up makes 8
            fail()
        return calls[i]()

    if rank == 1:
{fault}
    return staged


program.stage = broken
sys.exit(run.main())
"""

FAULTS = {
    "none": "pass",
    "raises": "staged.calls = [fail] * len(calls)",
    "raises_in_window": ("staged.calls = [lambda i=i: late(i) "
                         "for i in range(len(calls))]"),
    "another_array": "staged.calls = calls[1:] + calls[:1]",
    "value_altered": ("staged.calls = [lambda c=c: altered(c()) "
                      "for c in calls]"),
    "hangs": "time.sleep(600)",
}
# faults planted on every rank, before the run
EVERYWHERE = {
    # each rank's model from its own histogram: no exchange between cards
    "exchange_left_out": ("multihost.MultiHostBlockCodec._global_hist = "
                          "lambda self, hist: hist"),
    # each rank reports a card that it did not run on
    "count_faked": ("reduce = ranks.reduce\n"
                    "ranks.reduce = lambda s, m: reduce(dict(s, cards=1), m)"),
}


def _leftovers(tmp_path) -> list:
    """Processes whose command line names a file of this test's copy."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        if str(tmp_path).encode() in cmd and int(pid) != os.getpid():
            found.append(pid)
    return found


def small_run(tmp_path, fault: str, setup_limit=ranks.SETUP_LIMIT,
              trace=0, rank_device="cpu"):
    """(exit code, stdout, stderr, seconds) of the command run in a copy
    of the benchmark whose sharded cell takes 2 ranks and N values."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load()
    for w in bench["workloads"]:
        if w["name"] == CELL:
            w["chips"] = 2
            file = next(c["file"] for c in bench["configs"]
                        if c["name"] == w["config"])
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    config = json.loads((copy / file).read_text())
    (copy / file).write_text(json.dumps(dict(config, n=N)))
    rank = tmp_path / "rank.py"
    rank.write_text(RANK.format(
        tmp=str(copy), root=str(ROOT), everywhere=EVERYWHERE.get(fault, ""),
        fault=" " * 8 + FAULTS.get(fault, "pass")))
    parent = tmp_path / "parent.py"
    parent.write_text(PARENT.format(tmp=str(copy), root=str(ROOT),
                                    rank=str(rank), setup_limit=setup_limit,
                                    rank_device=rank_device))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(parent), "--workload", CELL, "--seed", str(SEED),
         "--seconds", "0.3", "--trace", str(trace)],
        cwd=copy, capture_output=True, text=True, timeout=LIMIT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    seconds = time.monotonic() - t0
    assert not _leftovers(tmp_path)
    return proc.returncode, proc.stdout, proc.stderr, seconds


def test_two_ranks_decode_their_shards_correctly(tmp_path):
    rc, out, err, _ = small_run(tmp_path, "none")
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    # the blob of each rank's shard against the reference's under the
    # counts summed over both ranks, and its decodes against its shard
    assert res["checks"]["blob_bytes_wrong"]["value"] == 0
    assert res["checks"]["values_wrong"]["value"] == 0
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    assert set(res["metrics"]) == {"decode_Gints_s", "decode_p95_ms", "bpi",
                                   "setup_s"}
    assert "rank 1: window:" in err and "rank 0: window:" in err
    assert err.strip().splitlines()[-1].startswith("check ")
    # no rank ran on a card, and each had half of the CPUs
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["count"] == 0
    for r in (0, 1):
        assert f"rank {r}: cpu, {ranks.threads(2)} threads" in err


def test_a_traced_run_reports_the_rendezvous_and_the_model_build(tmp_path):
    rc, out, err, _ = small_run(tmp_path, "none", trace=1)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    # the CPU has no device trace: its readers return nothing
    assert set(res["metrics"]) == {"launches.read", "rendezvous_ms",
                                   "model_build_s"}
    assert res["metrics"]["model_build_s"]["value"] > 0
    assert res["metrics"]["rendezvous_ms"]["value"] >= 0


def test_a_rank_without_its_card_ends_every_rank(tmp_path):
    """A rank named a card that it cannot find exits before it joins, and
    the run ends with no result: no rank falls back to the CPU."""
    rc, out, err, seconds = small_run(tmp_path, "none",
                                      rank_device="cuda:9{rank}")
    assert rc != 0 and out == ""
    assert "no card cuda:" in err and "killing every rank" in err
    assert seconds < LIMIT / 2


def test_a_result_that_counts_another_number_of_cards_is_refused(tmp_path):
    rc, out, err, _ = small_run(tmp_path, "count_faked")
    assert rc != 0 and out == ""
    assert "2 ranks ran on a card, 0 were started on one" in err


@pytest.mark.parametrize("fault,setup_limit", [("raises", 1080.0),
                                               ("hangs", 5.0)])
def test_a_rank_that_fails_ends_every_rank(tmp_path, fault, setup_limit):
    """A rank that raises in its set-up, or hangs past the set-up's limit,
    ends the whole run: no result line and another exit code than 0."""
    rc, out, err, seconds = small_run(tmp_path, fault, setup_limit)
    assert rc != 0 and out == ""
    assert "killing every rank" in err
    assert seconds < LIMIT / 2


def test_a_request_that_raises_on_one_rank_ends_every_window(tmp_path):
    rc, out, err, _ = small_run(tmp_path, "raises_in_window")
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] == 1
    assert "a request failed on 1 other rank(s)" in err


@pytest.mark.parametrize("fault,wrong", [
    ("another_array", "values_wrong"),  # rank 1 reads another array
    ("value_altered", "values_wrong"),  # one value of rank 1's shard
    ("exchange_left_out", "blob_bytes_wrong")])
def test_a_broken_rank_is_not_correct(tmp_path, fault, wrong):
    """A fault on one rank, or the exchange of histograms between the
    cards left out, reaches rank 0's checks: summed over the ranks."""
    rc, out, err, _ = small_run(tmp_path, fault)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"][wrong]["value"] > 0

