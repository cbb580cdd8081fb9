"""The port's host library (ans_tpu_torch/native, built by g++ at first use)
against the pure-Python bodies it replaces: each hooked function gives
what its plain version gives (the module's `_native` set to None) on
seeded inputs, the single-symbol and the empty input among them; the
build is named by its source and target, survives concurrent builds
and raises without g++, with no fall-back."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ans_tpu_torch import native
from ans_tpu_torch.native import build
from ans_tpu_torch.reference_model import (interp, mappings, model,
                                           rans_compat)

REPO = Path(__file__).resolve().parent.parent


def plain(monkeypatch, *modules):
    """Run the modules' plain versions for the rest of the test."""
    for mod in modules:
        monkeypatch.setattr(mod, "_native", None)


def _freqs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "zipf":
        f = np.bincount(rng.zipf(1.1, 50000) % 30000)
    elif kind == "uniform":
        f = np.bincount(rng.integers(0, 5000, 40000))
    elif kind == "sparse":
        f = np.zeros(1 << 16, np.int64)
        f[rng.choice(1 << 16, 300, replace=False)] = rng.integers(1, 10 ** 6,
                                                                  300)
    elif kind == "single":
        f = np.zeros(43, np.int64)
        f[42] = 1000
    elif kind == "skew":
        f = np.concatenate([[10 ** 6], np.ones(2000, np.int64)])
    return f.astype(np.uint64)


FREQS = ["zipf", "uniform", "sparse", "single", "skew"]


def _twice(fn, monkeypatch, *modules):
    """(fn() with the library, fn() with the plain versions)."""
    got = fn()
    with monkeypatch.context() as m:
        plain(m, *modules)
        want = fn()
    return got, want


def _same_float(a: float, b: float) -> bool:
    return np.float64(a).tobytes() == np.float64(b).tobytes()


@pytest.mark.parametrize("kind", FREQS)
def test_entropies(kind, monkeypatch):
    f = _freqs(kind)
    total = int(f.sum())
    got, want = _twice(lambda: model.entropy_ordered(f, total), monkeypatch,
                       model)
    assert _same_float(got, want)
    nf = model.adjust_freqs(f, len(f) - 1, False)
    got, want = _twice(lambda: model.cross_entropy_ordered(f, nf),
                       monkeypatch, model)
    assert _same_float(got, want)


def test_entropies_of_empty_vectors(monkeypatch):
    empty = np.zeros(0, np.uint64)
    got, want = _twice(lambda: model.entropy_ordered(empty, 0), monkeypatch,
                       model)
    assert got == want == 0.0
    got, want = _twice(lambda: model.cross_entropy_ordered(
        empty, np.zeros(0, np.uint32)), monkeypatch, model)
    assert got == want == 0.0


@pytest.mark.parametrize("kind", FREQS)
@pytest.mark.parametrize("M_shift", [0, 1, 3])
def test_scale_freqs(kind, M_shift, monkeypatch):
    """One rescale pass, in place, with the retry flag: onto the frame
    search's first frame and larger ones."""
    f = _freqs(kind)
    nz = np.flatnonzero(f)
    order = sorted((int(f[i]), int(i)) for i in nz)
    mapping = np.array([s for _, s in order], np.int64)
    M = model.next_power_of_two(len(nz)) << M_shift

    def run():
        S = np.zeros(len(f), np.uint32)
        retry = model.scale_freqs(S, f, mapping, M, len(nz), int(f.sum()))
        return retry, S

    (r1, s1), (r2, s2) = _twice(run, monkeypatch, model)
    assert r1 == r2
    np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("kind", FREQS)
@pytest.mark.parametrize("h_approx,u16,cap", [(1, False, None),
                                              (80, True, None),
                                              (1, True, 1 << 12)])
def test_adjust_freqs_and_prelude(kind, h_approx, u16, cap, monkeypatch):
    f = _freqs(kind)

    def run():
        nf = model.adjust_freqs(f, len(f) - 1, u16, h_approx, cap)
        blob = model.serialize_prelude(nf, int(nf.sum()))
        back, used = model.load_prelude(blob + b"tail")
        return nf, blob, back, used

    got, want = _twice(run, monkeypatch, model, interp)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b


@pytest.mark.parametrize("n,u", [(0, 1), (1, 1), (1, 7), (5, 5), (256, 4352),
                                 (1000, 1 << 20), (3000, 3001),
                                 (20000, 1 << 31)])
def test_interp(n, u, monkeypatch):
    rng = np.random.default_rng(n + u)
    if u <= 1 << 20:
        seq = np.sort(rng.choice(u, size=n, replace=False)).astype(np.uint64)
    else:
        seq = np.unique(rng.integers(0, u, size=2 * n, dtype=np.uint64))[:n]
    assert len(seq) == n
    got, want = _twice(lambda: interp.encode(seq, n, u), monkeypatch, interp)
    assert got == want
    for off in (0, 24):
        buf = b"\x00" * (off // 8) + got
        (v1, w1), (v2, w2) = _twice(lambda: interp.decode(
            buf, n, u, bit_offset=off), monkeypatch, interp)
        assert list(v1) == list(v2) == seq.tolist()
        assert w1 == w2


def _compat_inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    return {"zipf": (rng.zipf(1.2, 20000) % 70000),
            "wide": rng.integers(0, 1 << 32, 5000, dtype=np.uint64) >> (
                rng.integers(0, 32, 5000).astype(np.uint64)),
            "single": np.full(999, 12345),
            "three": np.array([4, 1, 4])}[kind].astype(np.uint32)


@pytest.mark.parametrize("kind", ["zipf", "wide", "single", "three"])
@pytest.mark.parametrize("coder", ["AnsInt", "AnsMsb", "AnsFold-1",
                                   "AnsFold-2", "AnsReorderFold-2",
                                   "AnsSmsb-80"])
def test_compat_coders(kind, coder, monkeypatch):
    """interleaved_encode / interleaved_decode through each coder (plain
    symbols, msb and fold exceptions, the rfold reorder)."""
    x = _compat_inputs(kind)
    if coder in ("AnsInt", "AnsReorderFold-2") and kind == "wide":
        # a plain alphabet (and rfold's value counts) of 2^20 at most
        x = x & np.uint32(0xFFFFF)
    name, _, arg = coder.partition("-")
    codec = getattr(rans_compat, name)(*((int(arg),) if arg else ()))
    got, want = _twice(lambda: codec.encode(x), monkeypatch, rans_compat,
                       model, interp)
    assert got == want
    out, ref = _twice(lambda: codec.decode(got, len(x)), monkeypatch,
                      rans_compat, model, interp)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, x)
    assert out.dtype == ref.dtype


def test_interleaved_engine_on_the_empty_stream(monkeypatch):
    nf = np.array([2, 0, 6], np.uint32)
    empty = np.zeros(0, np.uint32)
    got, want = _twice(lambda: rans_compat.interleaved_encode(empty, nf, 8),
                       monkeypatch, rans_compat)
    assert got == want and len(got) == 32
    out, ref = _twice(lambda: rans_compat.interleaved_decode(got, 0, nf),
                      monkeypatch, rans_compat)
    assert len(out) == len(ref) == 0


def test_interleaved_engine_with_fold_exceptions(monkeypatch):
    rng = np.random.default_rng(3)
    x = (rng.zipf(1.3, 30000) * 4093).astype(np.uint32)
    mapped = mappings.fold_map(x, 2)
    k, b = mappings.fold_exceptions(x, 2)
    nf = model.adjust_freqs(np.bincount(mapped).astype(np.uint64),
                            int(mapped.max()), True)
    M = int(nf.sum())
    got, want = _twice(lambda: rans_compat.interleaved_encode(
        mapped, nf, M, k, b), monkeypatch, rans_compat)
    assert got == want
    high, nb = mappings.fold_unmap_high(np.arange(len(nf), dtype=np.uint32),
                                        2)
    out, ref = _twice(lambda: rans_compat.interleaved_decode(
        got, len(x), nf, high, nb), monkeypatch, rans_compat)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("n", [0, 1, 255, 4096, 100003])
def test_byte_histogram_and_ansbyte(n, monkeypatch):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    data[: n // 2] = 7
    got = native.byte_histogram(data)
    want = native.byte_histogram(data, None)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.uint64 and got.shape == (256,)
    if n:
        codec = rans_compat.AnsByte()
        blob, ref = _twice(lambda: codec.encode(data.tobytes()), monkeypatch,
                           rans_compat, model, interp)
        assert blob == ref
        assert codec.decode(blob, n) == data.tobytes()


def test_modules_reach_the_library_through_native():
    """Every hooked module holds the deferred library, not a copy of it,
    and the deferred object builds nothing until it is used."""
    for mod in (model, interp, rans_compat):
        assert mod._native is native.deferred
    assert isinstance(native.lib(), native.NativeLib)
    assert native.deferred.entropy_ordered.__self__ is native.lib()


def test_binding_covers_every_exported_function():
    src = build.SRC.read_text()
    names = re.findall(r"^(?:double|int32_t|int64_t|void)\s+(\w+)\(", src,
                       re.M)
    assert len(names) == 20 and "ans_interp_decode" in names
    lib = native.lib()._c
    for name in names:
        assert getattr(lib, name).argtypes, name


def test_library_named_by_source_flags_and_target(monkeypatch):
    cxx = build.find_cxx()
    a = build.library_path(cxx)
    assert a.parent == build.BUILD_DIR and a.name.startswith("libansnative-")
    monkeypatch.setattr(build, "CXX_FLAGS", (*build.CXX_FLAGS, "-DX"))
    assert build.library_path(cxx) != a
    monkeypatch.undo()
    monkeypatch.setattr(build, "_target", lambda cxx: "another machine")
    assert build.library_path(cxx) != a


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    """No g++: the first use of the library raises, with no fall-back and
    nothing left in the build directory; so do the entry points."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.lib()
    f = _freqs("zipf")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        model.entropy_ordered(f, int(f.sum()))
    from ans_tpu_torch import container, models
    x = np.arange(100, dtype=np.uint32) % 7
    for method, engine in (("ANSfold-2", "lane"), ("ANS", "compat")):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            container.compress(x, method, engine, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        models.get("pseudo_adaptive", device="cpu").encode(x)
    assert not (tmp_path / "_build").exists()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ans_native.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on ans_native"
                                           ".cpp:\n.*error"):
        build.build()
    assert not list((tmp_path / "_build").iterdir())


def test_concurrent_builds_leave_one_library(tmp_path):
    """Processes that build at once (the tier-1 suite's workers) each load
    a whole library, and only the finished one stays."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        from ans_tpu_torch import native
        from ans_tpu_torch.native import build
        build.BUILD_DIR = Path({str(tmp_path / "_build")!r})
        assert native.lib().entropy_ordered(
            __import__("numpy").array([1, 1], "u8"), 2) == 1.0
        print(build.build_seconds is not None)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert "True" in {o.strip() for o, _ in outs}
    left = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert len(left) == 1 and left[0].startswith("libansnative-") and \
        left[0].endswith(".so"), left
