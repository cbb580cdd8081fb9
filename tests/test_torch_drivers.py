"""The port's experiment drivers (ans_tpu_torch/drivers) against ans_tpu's:
on the 4000-value zipfy.u32 of tests/test_drivers.py each prints
ans_tpu's lines, the time columns aside, and the file writers write
ans_tpu's files.  The port runs with `--device cpu` (each kernel's plain
version); the lane codecs' bytes are held to ans_tpu's elsewhere, so the
printed bpi columns compare exactly."""

import contextlib
import importlib
import io as _io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ans_tpu.utils import io

REPO = str(Path(__file__).resolve().parents[1])

# drivers whose codecs run on the `--device` the port's parser adds
DEVICE_DRIVERS = {"benchmark", "fold_effectiveness", "prelude",
                  "pseudo_adaptive", "table_effectiveness",
                  "table_efficiency"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_drivers.py's input."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)
    v = (rng.zipf(1.3, size=4000) - 1).clip(0, 1 << 20).astype(np.uint32)
    io.write_file_u32(os.path.join(d, "zipfy.u32"), v)
    return str(d)


def _run(package: str, driver: str, argv) -> str:
    """stdout of package.drivers.<driver>.main(argv)."""
    mod = importlib.import_module(f"{package}.drivers.{driver}")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    return buf.getvalue()


def _both(driver: str, argv) -> tuple:
    """(ans_tpu's lines, the port's lines) of one driver run."""
    extra = ["--device", "cpu"] if driver in DEVICE_DRIVERS else []
    return (_run("ans_tpu", driver, argv).splitlines(),
            _run("ans_tpu_torch", driver, [*argv, *extra]).splitlines())


def _benchmark_columns(line: str) -> list:
    """A benchmark line without its ns/int columns (the last two)."""
    return line.split("\t\t")[:-3]


def _prelude_columns(line: str) -> str:
    return re.sub(r" (prelude|encode)_ns=\d+", "", line)


def _numbers_masked(line: str) -> str:
    """A line with each number and its padding replaced by '#'."""
    return re.sub(r" *([0-9.]+(e[+-]?\d+)?|inf)", "#", line)


# driver -> (argv after -i, the line transform that drops times)
CASES = {
    "table_effectiveness": (["--engine", "compat"], None),
    "table_effectiveness-lane": (["--methods", "ANS,ANSmsb,vbyteANS,"
                                  "streamvbyteANS,vbytefse,shuff"], None),
    "benchmark": (["--engine", "compat", "--runs", "1", "--methods",
                   "ANSmsb,ANSfold-2,shuff,arith,optpfor,fse,huffzero,"
                   "vbytefse,streamvbytefse,vbytehuffzero,"
                   "streamvbytehuffzero,vbyte,streamvbyte"],
                  _benchmark_columns),
    "benchmark-lane": (["--runs", "1", "--methods",
                        "ANSfold-2,vbyteANS,vbytefse,shuff,arith"],
                       _benchmark_columns),
    "table_efficiency": (["--engine", "compat", "--runs", "1", "--methods",
                          "vbyte,vbytehuffzero,vbytefse,optpfor,shuff,"
                          "arith,ANS,ANSfold-1,ANSrfold-1"],
                         _numbers_masked),
    "fold_effectiveness": (["--engine", "compat"], None),
    "bucket_skew": ([], None),
    "lower_order_entropy": ([], None),
    "prelude": (["--methods", "ANS,ANSmsb,ANSfold-2,ANSrfold-2,vbyteANS,"
                 "shuff,arith,fse,optpfor"], _prelude_columns),
    "prelude-compat": (["--engine", "compat"], _prelude_columns),
    "pseudo_adaptive": (["--max-i", "3"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_prints_ans_tpus_lines(data_dir, case):
    driver = case.split("-")[0]
    argv, strip = CASES[case]
    ref, port = _both(driver, ["-i", data_dir, *argv])
    assert len(port) == len(ref) > 0
    strip = strip or (lambda line: line)
    for want, got in zip(ref, port):
        assert strip(got) == strip(want)


def test_shuff_driver(data_dir):
    ref, port = _both("shuff", ["-i", data_dir + "/zipfy.u32"])
    assert port == ref and port[0].startswith("n=4000 ")


def test_rescale_freqs(data_dir, monkeypatch):
    """ans_tpu's cut (the first 2000 values).  ans_tpu's driver runs with
    the port's interp coder in place of its own: its pure-Python interp
    over the 2^20 + 1 dense prelude takes ~40 s here, and the port's
    interp is held equal to ans_tpu's (tests/test_torch_host.py);
    everything else the driver computes (the ordering, the blend, the
    cross entropy) is ans_tpu's own."""
    from ans_tpu.drivers import rescale_freqs as ref_mod
    from ans_tpu_torch.drivers import rescale_freqs
    from ans_tpu_torch.reference_model import interp
    v = io.read_file_u32(data_dir + "/zipfy.u32")[:2000]
    monkeypatch.setattr(ref_mod, "interp", interp)
    outs = []
    for mod in (ref_mod, rescale_freqs):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = mod.rescale_study(v, "zipfy")
        outs.append((buf.getvalue(), rows))
    assert outs[1] == outs[0] and len(outs[1][1]) == 31


def test_generate_inputs(tmp_path):
    outs = {}
    for pkg in ("ans_tpu", "ans_tpu_torch"):
        d = tmp_path / pkg
        lines = _run(pkg, "generate_inputs", ["-o", str(d), "-n", "500"])
        outs[pkg] = (lines.replace(str(d), "DIR"),
                     {p.name: p.read_bytes() for p in d.iterdir()})
    assert outs["ans_tpu_torch"] == outs["ans_tpu"]
    assert len(outs["ans_tpu"][1]) == 14


def test_generate_bwtmtf(tmp_path):
    src = tmp_path / "text.txt"
    src.write_bytes(b"the quick brown fox jumps over the lazy dog " * 40
                    + bytes(range(256)))
    outs = {}
    for pkg in ("ans_tpu", "ans_tpu_torch"):
        for words in ([], ["-w"]):
            out = tmp_path / f"{pkg}{len(words)}.u32"
            line = _run(pkg, "generate_bwtmtf",
                        ["-i", str(src), "-o", str(out), *words])
            outs[pkg, len(words)] = (line.replace(str(out), "OUT"),
                                     out.read_bytes())
    for words in (0, 1):
        assert outs["ans_tpu_torch", words] == outs["ans_tpu", words]


def test_generate_rlz(tmp_path):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 30, 2000).astype(np.uint8)
    src = tmp_path / "text.bin"
    src.write_bytes(np.concatenate([base, base[50:400], base[900:1500],
                                    rng.integers(0, 255, 30).astype(
                                        np.uint8)]).tobytes())
    outs = {}
    for pkg in ("ans_tpu", "ans_tpu_torch"):
        prefix = tmp_path / pkg
        line = _run(pkg, "generate_rlz", ["-i", str(src), "-o", str(prefix)])
        outs[pkg] = (line, *(Path(f"{prefix}.{s}.u32").read_bytes()
                             for s in ("lens", "offsets")))
    assert outs["ans_tpu_torch"] == outs["ans_tpu"]
    from ans_tpu_torch.drivers.generate_rlz import (rlz_factorize,
                                                    rlz_reconstruct)
    text = np.frombuffer(src.read_bytes(), np.uint8)
    lens, offs = rlz_factorize(text[200:], text[:200])
    np.testing.assert_array_equal(rlz_reconstruct(lens, offs, text[:200]),
                                  text[200:])


def test_device_flag_defaults_to_cuda():
    """--device (default cuda) wherever a driver builds a codec."""
    from ans_tpu_torch.drivers import _cli
    args = _cli.make_parser("x", methods_arg=True).parse_args(["-i", "f"])
    assert args.device == "cuda"
    assert not hasattr(_cli.make_parser("x").parse_args(["-i", "f"]),
                       "device")
    pa = _cli.make_parser("x", device_arg=True).parse_args(
        ["-i", "f", "--device", "cpu"])
    assert pa.device == "cpu"


def test_runs_as_module(data_dir):
    """python -m ans_tpu_torch.drivers.<name>, with jax and ans_tpu
    unimportable."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['ans_tpu'] = None; "
            "sys.argv = ['table_effectiveness', '-i', sys.argv[1], "
            "'--methods', 'fse,huffzero,vbytehuffzero', '--device', 'cpu']; "
            "runpy.run_module('ans_tpu_torch.drivers.table_effectiveness', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, data_dir], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("\\method") == 3
    assert _run("ans_tpu", "table_effectiveness", [
        "-i", data_dir, "--methods", "fse,huffzero,vbytehuffzero"]) \
        == proc.stdout


def test_runtime_cache_names_the_build_directory(tmp_path):
    """runtime.enable_compilation_cache points the kernel and host-library
    builds at one directory; the host library builds there."""
    from ans_tpu_torch import runtime
    from ans_tpu_torch.csrc import build as kernel_build
    from ans_tpu_torch.native import build as host_build
    saved = kernel_build.BUILD_DIR, host_build.BUILD_DIR
    try:
        path = runtime.enable_compilation_cache(str(tmp_path / "cache"))
        assert kernel_build.BUILD_DIR == host_build.BUILD_DIR == path
        assert host_build.build().parent == path
        assert runtime.enable_compilation_cache() == runtime.DEFAULT_CACHE
        assert host_build.BUILD_DIR == runtime.DEFAULT_CACHE
    finally:
        kernel_build.BUILD_DIR, host_build.BUILD_DIR = saved


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from ans_tpu_torch.utils import profiling
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("ans_tpu_torch.region"):
            torch.arange(1000).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "ans_tpu_torch.region"
               for e in trace["traceEvents"])
