"""The plain reference against the program at small sizes, its control,
the inputs, the trace's reduction and the import ban."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, inputs, manifest, reference, trace

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "ans_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _reference_side_imports(path: Path) -> set:
    """What the reference side of a codec (references/<codec>.py) imports
    beyond the standard library, NumPy and portbench/reference.py: whole
    module names, and "relative" for an import by a relative name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level:
            names.add("relative")
        elif isinstance(node, ast.ImportFrom):
            names |= ({f"portbench.{a.name}" for a in node.names}
                      if node.module == "portbench" else {node.module})
    return {m for m in names if m != "portbench.reference"
            and m.split(".")[0] not in sys.stdlib_module_names | {"numpy"}}


def test_no_jax_and_a_reference_free_of_the_program():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & BANNED, path
    # whole names: the port's name begins with the JAX package's
    assert "ans_tpu_torch" not in BANNED
    assert _imports(ROOT / "portbench/reference.py") <= {
        "__future__", "math", "struct", "dataclasses", "numpy"}
    # the reference side of every other codec
    for path in (ROOT / "portbench/references").glob("*.py"):
        assert not _reference_side_imports(path), path
    for name in ("check.py", "inputs.py", "manifest.py"):
        assert "ans_tpu_torch" not in _imports(ROOT / "portbench" / name)


@pytest.mark.parametrize("line,found", [
    ("import numpy as np\nfrom portbench import reference", set()),
    ("import math, struct\nimport portbench.reference", set()),
    ("from portbench import program, reference", {"portbench.program"}),
    ("import torch", {"torch"}),
    ("from ans_tpu_torch.models import pseudo_adaptive",
     {"ans_tpu_torch.models"}),
    ("from .. import reference", {"relative"})])
def test_the_ban_on_a_codecs_reference_side(tmp_path, line, found):
    path = tmp_path / "codec.py"
    path.write_text(line + "\n")
    assert _reference_side_imports(path) == found


def _uniform_tail(n_head=2000, reps=40):
    """A hot head and a tail of distinct values: the identity coder's tail
    escape admits it (every tail frequency alike)."""
    head = np.repeat(np.arange(1 << 16, (1 << 16) + n_head), reps)
    tail = np.arange(1 << 16)
    x = np.concatenate([head, tail]).astype(np.uint32)
    return np.random.default_rng(4).permutation(x)


def _zipf(seed, n, exponent, universe, **kw):
    return lambda: inputs.zipf(inputs.generator(seed, "cpu"), n, exponent,
                               universe, **kw)


FOLD = dict(universe=1 << 52, shift=1, clip=(1 << 28) - 1)
CASES = {
    "fold2": ("ANSfold-2", _zipf(11, 1 << 16, 1.25, **FOLD), 1024),
    "fold2-tiny": ("ANSfold-2", _zipf(12, 1000, 1.25, **FOLD), 32),
    "ans-grouped": ("ANS", _zipf(13, 1 << 16, 1.0, 1 << 20), 256),
    "ans-escape": ("ANS", _uniform_tail, 1024),
    "ans-small": ("ANS", _zipf(14, 1 << 15, 1.0, 1 << 10), 512),
    "fold7-grouped": ("ANSfold-7", _zipf(15, 1 << 16, 1.0, 1 << 20), 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sections", [0, 3, 4])
def test_reference_writes_the_programs_bytes(case, sections):
    from ans_tpu_torch import models
    from ans_tpu_torch.parallel import BlockCodec
    method, make, lanes = CASES[case]
    x = make()
    ref = reference.encode(method, x, lanes, sections)
    if sections:
        codec = BlockCodec(method, sections, lanes, device="cpu")
        prog = codec.encode(x)
        back = codec.decode(ref.blob)
    else:
        codec = models.get(method, device="cpu", lanes=lanes)
        prog = codec.encode(x)
        back = codec.decode(ref.blob, len(x))
    assert ref.blob == prog
    # the round trip through the reference's blob
    assert np.array_equal(back, x)


@pytest.mark.parametrize("case", ["ans-grouped", "ans-escape", "ans-small",
                                  "fold7-grouped"])
def test_a_shard_under_the_counts_of_every_shard(case):
    """The reference under an array's own counts writes what it writes
    without them; a shard under the counts of both halves writes the
    program's shard (BlockCodec under the summed histogram, the hook of
    its multi-process codec) and not the shard's own container."""
    from ans_tpu_torch.parallel import BlockCodec
    method, make, lanes = CASES[case]
    x = make()
    assert (reference.encode(method, x, lanes, 4, np.bincount(x)).blob
            == reference.encode(method, x, lanes, 4).blob)
    half, counts = x[:len(x) // 2], np.bincount(x)
    ref = reference.encode(method, half, lanes, 4, counts)
    kind, fidelity = reference.parse_method(method)
    hist = (np.bincount(reference.fold_map(x, fidelity)[0]) if kind == "fold"
            else counts)
    prog = BlockCodec(method, 4, lanes, device="cpu").encode(
        half, hist_override=hist)
    assert ref.blob == prog
    assert ref.blob != reference.encode(method, half, lanes, 4).blob


def test_the_escape_case_escapes():
    x = _uniform_tail()
    nfreqs = reference.adjust_freqs(np.bincount(x), False)
    plan = reference.escape_plan(nfreqs)
    assert plan is not None and plan.K + len(plan.var_highs) < len(x)
    assert not reference.model("int", 0, x).grouped


@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_the_control_fails_and_the_reference_passes(name):
    cell = manifest.cell(name)
    got = control.readings(cell, 5, torch.device("cpu"), n=1 << 14)
    assert not check.passed(got)
    assert got["blob_bytes_wrong"] > 0
    config = dict(cell.config, n=1 << 14)
    x = inputs.make(config, 5, "cpu", count=1)[0]
    ref = reference.encode(config["method"], x, config["lanes"],
                           cell.mix.get("sections", 0))
    same = check.blob([(ref.blob, ref.blob)], len(x))
    same.update(check.values([(torch.from_numpy(x.view(np.int32)), x)]))
    assert check.passed(same)


def test_nothing_to_compare_is_not_correct():
    assert not check.passed(check.blob([], 10))
    assert not check.passed(check.values([]))
    assert not check.passed(check.streams([], "cpu"))


def test_inputs_follow_the_seed():
    for name in ("ansfold2-zipf125", "ans-zipf20"):
        config = manifest.cell(f"{name}.read").config
        P = inputs.pool_size(config)
        a = inputs.make(config, (1 << 31) + 5, "cpu", n=5000)
        b = inputs.make(config, (1 << 31) + 5, "cpu", n=5000)
        c = inputs.make(config, (1 << 31) + 6, "cpu", n=5000)
        assert len(a) == len(c) == P >= 2
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
        assert not np.array_equal(a[0], c[0])
        # the pool's arrays differ from each other
        assert not np.array_equal(a[0], a[1])
        assert all(len(v) == 5000 and v.dtype == np.uint32 for v in c)
        assert np.array_equal(inputs.make(config, (1 << 31) + 5, "cpu",
                                          n=5000, count=1)[0], a[0])
        assert len(inputs.make(config, -3, "cpu", n=10)[0]) == 10
        assert len(inputs.make(config, (1 << 64) + 3, "cpu", n=10)[0]) == 10


def test_inputs_draw_their_distribution():
    fold = manifest.cell("ansfold2-zipf125.read").config
    x = inputs.make(fold, 9, "cpu", n=1 << 18, count=1)[0]
    # Zipf(1.25) less 1: P(0) = 1 / zeta(1.25) = 0.2176; about 0.7% of the
    # values lie beyond 2^28 and are clipped
    assert abs(np.mean(x == 0) - 0.2176) < 0.005
    assert 0.004 < np.mean(x == (1 << 28) - 1) < 0.01
    big = manifest.cell("ans-zipf20.read").config
    y = inputs.make(big, 9, "cpu", n=1 << 18, count=1)[0]
    assert y.min() >= 1 and y.max() <= 1 << 20
    # Zipf(1) over 2^20: P(1) = 1 / H(2^20) = 0.0688
    assert abs(np.mean(y == 1) - 0.0688) < 0.003


def test_trace_summary():
    ev = [
        {"cat": "kernel", "name": "k_a", "ts": 10, "dur": 30},
        {"cat": "kernel", "name": "k_b", "ts": 30, "dur": 20},  # overlaps
        {"cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10},
        {"cat": "kernel", "name": "k_a", "ts": 150, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 45,
         "dur": 20},
        {"cat": "cuda_runtime", "name": "inner", "ts": 50, "dur": 2},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 100,
         "dur": 5},
    ]
    s = trace.summarize(ev, 200e-6)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["device_ops"][0] == ["k_a", pytest.approx(40e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # the gaps between device intervals: 50-70 (mid 60, in the sync) and
    # 80-150 (mid 115, between CUDA calls)
    assert gaps == {"cudaDeviceSynchronize": pytest.approx(20e-6),
                    trace.BETWEEN: pytest.approx(70e-6)}
    assert trace.summarize(ev[4:], 1.0) is None
