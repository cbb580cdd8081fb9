"""The command end to end on the card: one short run of each cell, its
result line correct, over as many cards as the cell asks for.  Marked
`cuda`; it skips where there is no CUDA device, or fewer cards than the
cell asks for."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import manifest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_a_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < manifest.cell(name).chips:
        pytest.skip(f"needs {manifest.cell(name).chips} CUDA devices")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str((1 << 31) + 41), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == manifest.cell(name).chips
