"""ans_tpu_torch host layers against ans_tpu: the NumPy copies of the
constants, the frame search and the preludes, the interpolative coder,
the byte coder's model, the compat coders, the lane-count policy, the
fmt-2 framing, the lane tables, the grouped slot layout and the
tail-escape plan must equal the reference's exactly, and the package
must import with neither JAX nor ans_tpu."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ans_tpu.models import config as jconfig
from ans_tpu.models import framing as jframing
from ans_tpu.ops import escape as jescape
from ans_tpu.ops import grouped as jgrouped
from ans_tpu.ops import tables as jtables
from ans_tpu.parallel import block_runtime as jblock
import ans_tpu.constants as jconstants
from ans_tpu.reference_model import interp as jinterp
from ans_tpu.reference_model import mappings as jmappings
from ans_tpu.reference_model import model as jmodel
from ans_tpu.reference_model import parity as jparity
from ans_tpu.reference_model import rans_compat as jcompat
from ans_tpu.reference_model import shuff_compat as jshuff
from ans_tpu.reference_model import vbyte as jvbyte
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu.utils.zipf import zipf
import ans_tpu_torch.constants as constants
from ans_tpu_torch.csrc import build
from ans_tpu_torch.models import config, framing
from ans_tpu_torch.ops import escape, grouped, tables
from ans_tpu_torch.parallel import block_runtime
from ans_tpu_torch.reference_model import (byte_model, interp, mappings,
                                           model, parity, rans_compat,
                                           shuff_compat, vbyte)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [0, 1, 31, 12800, 12801, 409600, 10 ** 6,
                               27 * 10 ** 6, 1 << 25, 1 << 30])
def test_default_lane_count(n):
    assert config.default_lane_count(n) == jconfig.default_lane_count(n)


@pytest.mark.parametrize("lanes", [None, 1, 2, 32, 4096, 3, 0, -4, 96])
def test_validate_lanes(lanes):
    try:
        want = jconfig.validate_lanes(lanes)
    except ValueError:
        with pytest.raises(ValueError):
            config.validate_lanes(lanes)
        return
    assert config.validate_lanes(lanes) == want


@pytest.mark.parametrize("seed,cap", [(0, 3 << 20), (1, 4096), (2, 1000),
                                      (3, 50), (4, 1)])
def test_choose_sections(seed, cap):
    """Small caps force many sections (down to the 32-step quantum)."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 3000))
    per_step = rng.integers(0, 700, size=T)
    step_base = np.concatenate(([0], np.cumsum(per_step)[:-1]))
    total = int(per_step.sum())
    t_sec, sec_len = framing.choose_sections(step_base, total, T,
                                             cap_bytes=cap)
    jt, jl = jframing.choose_sections(step_base, total, T, cap_bytes=cap)
    assert t_sec == jt
    np.testing.assert_array_equal(sec_len, jl)
    assert sec_len.sum() == total


def _frames():
    rng = np.random.default_rng(4)
    small = rng.integers(1, 30, 300).astype(np.uint64)
    small[0] += (1 << 13) - int(small.sum())
    sparse = np.zeros(9000, np.uint64)  # longer than 2^13, 100 live
    sparse[rng.choice(9000, 100, replace=False)] = 40
    sparse[np.flatnonzero(sparse)[0]] += (1 << 12) - int(sparse.sum())
    wide = np.ones(9000, np.uint64)  # grouped
    wide[0] += (1 << 14) - 9000
    single = np.zeros(10, np.uint64)
    single[3] = 1 << 10  # one symbol owns the frame
    flat = np.full(1 << 13, 1, np.uint64)  # sigma = 2^13, M = 2^13
    return {"small": small, "sparse": sparse, "wide": wide,
            "single": single, "flat": flat}


@pytest.mark.parametrize("frame", sorted(_frames()))
@pytest.mark.parametrize("S", [32, 64, 128, 256, 384, 512, 4096])
def test_production_engine_predicate(frame, S):
    """production_engine_ok equals ans_tpu's BlockCodec._encode_pallas_ok
    on the same frame (lane counts below, at and past 128, S/128 not a
    power of two, sigma past 2^13 with and without the grouped layout, a
    frame one symbol owns)."""
    nf = _frames()[frame]
    layout = (jgrouped.build_group_layout(nf)
              if jgrouped.use_grouped_layout(nf) else None)
    et = jtables.build_enc_table(nf, layout)
    want = jblock.BlockCodec._encode_pallas_ok(None, et, S, layout)
    assert block_runtime.production_engine_ok(
        nf, S, layout is not None) == want


def _step_bases(rng, T, mean, hot=None):
    per = rng.poisson(mean, size=T)
    if hot is not None:
        per[hot] *= 40  # a run of heavy steps
    return np.concatenate(([0], np.cumsum(per)[:-1])), int(per.sum())


@pytest.mark.parametrize("seed,cap", [(0, 3 << 20), (1, 4000), (2, 700),
                                      (3, 90)])
def test_choose_sections_joint_copy(seed, cap):
    """The copy equals ans_tpu's on crafted step offsets of four streams
    (one of them empty), down to the 32-step quantum."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(40, 700))
    streams = [_step_bases(rng, T, m) for m in (3, 9, 0)]
    streams.append(_step_bases(rng, T, 2, hot=slice(T // 3, T // 3 + 40)))
    bases = [b for b, _ in streams]
    totals = [t for _, t in streams]
    got = framing.choose_sections_joint(bases, totals, T, cap_bytes=cap)
    want = jframing.choose_sections_joint(bases, totals, T, cap_bytes=cap)
    assert got[0] == want[0]
    for a, b, tot in zip(got[1], want[1], totals):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == tot


def test_blocked_container_constants():
    """The ATFB magic and kind ids are wire format."""
    assert block_runtime.MAGIC == jblock.MAGIC
    assert block_runtime.KINDS == jblock.KINDS
    assert block_runtime.VERSION == 2


def test_choose_sections_empty():
    assert framing.choose_sections(np.zeros(0), 0, 0)[0] == \
        jframing.choose_sections(np.zeros(0), 0, 0)[0]


@pytest.mark.parametrize("S,nsec", [(1, 1), (32, 3), (4096, 16)])
def test_pack_parse(S, nsec):
    rng = np.random.default_rng(S)
    states = rng.integers(1 << 23, 1 << 31, size=S).astype(np.uint32)
    stream = rng.integers(0, 256, size=1000).astype(np.uint8)
    sec_len = np.full(nsec, 1000 // nsec, np.int64)
    sec_len[-1] += 1000 - sec_len.sum()
    blob = framing.pack(states, stream, 64, sec_len)
    assert blob == jframing.pack(states, stream, 64, sec_len)
    pre = b"\x07prelude"
    got = framing.parse(pre + blob, len(pre))
    want = jframing.parse(pre + blob, len(pre))
    assert got[0] == want[0] and got[3] == want[3]
    for a, b in zip((got[1], got[2], got[4]), (want[1], want[2], want[4])):
        np.testing.assert_array_equal(a, b)


def _freqs(kind: str, rng) -> np.ndarray:
    """Power-of-two-sum frequency vectors of several shapes."""
    if kind == "single":
        return np.array([0, 0, 1], np.uint64)
    if kind == "three_rounds":
        return np.full(4096, 32, np.uint64)         # M = 2^17
    if kind == "max_frame":
        nf = np.zeros(3000, np.uint64)
        nf[::3] = 1
        nf[0] += (1 << 22) - nf.sum()               # M = 2^22, f = M - 999
        return nf
    sigma = {"small": 5, "zipf": 1546, "sparse": 300}[kind]
    M = 1 << {"small": 4, "zipf": 15, "sparse": 12}[kind]
    nf = np.ones(sigma, np.uint64)
    extra = rng.multinomial(M - sigma, 1.0 / np.arange(1, sigma + 1)
                            / np.sum(1.0 / np.arange(1, sigma + 1)))
    nf += extra.astype(np.uint64)
    if kind == "sparse":
        out = np.zeros(sigma * 5, np.uint64)
        out[rng.choice(sigma * 5, sigma, replace=False)] = nf
        return out
    return nf


KINDS = ["single", "small", "zipf", "sparse", "three_rounds", "max_frame"]


def _assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
        else:
            assert x == y, f


@pytest.mark.parametrize("kind", KINDS)
def test_enc_table(kind):
    nf = _freqs(kind, np.random.default_rng(3))
    _assert_same(tables.build_enc_table(nf), jtables.build_enc_table(nf),
                 ["freq", "base", "magic", "frame_size", "log2m"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fold", [False, True])
def test_search_and_dec_tables(kind, fold):
    nf = _freqs(kind, np.random.default_rng(4))
    syms = np.arange(len(nf), dtype=np.uint32)
    hi = nb = None
    if fold:
        hi, nb = syms * np.uint32(3), syms % np.uint32(4)
    got, want = (tables.build_search_table(nf, hi, nb),
                 jtables.build_search_table(nf, hi, nb))
    _assert_same(got, want, ["depth", "val", "high", "nb", "sigma",
                             "frame_size", "log2m"])
    assert len(got.pivots) == len(want.pivots)
    for a, b in zip(got.pivots, want.pivots):
        np.testing.assert_array_equal(a, b)
    # the search table is the port's whole decode table: it carries what
    # ans_tpu's slot-free DecTable holds (the frame and per-symbol
    # high/nb, here restricted to the present symbols)
    jd = jtables.build_dec_table(nf, hi, nb, slots=False)
    assert (got.frame_size, got.log2m) == (jd.frame_size, jd.log2m)
    nz = np.flatnonzero(jd.nfreqs)
    if fold:
        np.testing.assert_array_equal(got.high, jd.sym_high[nz])
        np.testing.assert_array_equal(got.nb, jd.sym_nb[nz])


def test_table_limits():
    for log2m in range(0, 24):
        assert tables.max_renorm_rounds(log2m) == \
            jtables.max_renorm_rounds(log2m)
    assert tables.A_L == jtables.A_L
    assert grouped.GROUPED_MIN_SIGMA == jgrouped.GROUPED_MIN_SIGMA
    for sigma in (1, 8192, 8193, 20000):
        nf = np.ones(sigma, np.uint64)
        assert grouped.use_grouped_layout(nf) == \
            jgrouped.use_grouped_layout(nf)
    for name in ("ESCAPE_MIN_SIGMA", "K_GRID", "MAX_VARIANTS",
                 "REL_LOSS_BUDGET"):
        assert getattr(escape, name) == getattr(jescape, name), name
    with pytest.raises(ValueError):
        tables.build_enc_table(np.array([3, 2], np.uint64))
    with pytest.raises(ValueError):
        tables.build_enc_table(np.array([1 << 23], np.uint64))


@pytest.mark.parametrize("kind", KINDS)
def test_to_device_accepts_reference_tables(kind):
    """to_device lays out ans_tpu's own tables exactly like the port's."""
    nf = _freqs(kind, np.random.default_rng(5))
    syms = np.arange(len(nf), dtype=np.uint32)
    a = tables.to_device(tables.build_enc_table(nf), "cpu")
    b = tables.to_device(jtables.build_enc_table(nf), "cpu")
    assert torch.equal(a.words, b.words) and a.log2m == b.log2m
    for args in ((), (syms + np.uint32(7), syms % np.uint32(3))):
        a = tables.to_device(tables.build_search_table(nf, *args), "cpu")
        b = tables.to_device(jtables.build_search_table(nf, *args), "cpu")
        for f in ("bases", "high", "nb"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert (a.depth, a.sigma, a.NR, a.NE) == (b.depth, b.sigma, b.NR,
                                                  b.NE)
        # the padded bases are the present symbols' cumulative freqs
        nz = nf[nf > 0].astype(np.int64)
        want = np.concatenate(([0], np.cumsum(nz)))
        np.testing.assert_array_equal(a.bases.numpy()[:len(want) - 1],
                                      want[:-1])
        assert int(a.bases[-1]) == int(nf.sum())
    with pytest.raises(TypeError):
        tables.to_device(object(), "cpu")


def test_imports_without_jax():
    """The port runs where neither JAX nor ans_tpu is present: importing
    every module, chip_smoke.py included, with `jax` and `ans_tpu` blocked
    must work; ANSfold-2, ANS (the grouped layout and the tail escape),
    ANSmsb, ANSrfold-2, vbyteANS and the blocked container round-trip
    there."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["ans_tpu"] = None
        import importlib, pkgutil
        import ans_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ans_tpu_torch.__path__, "ans_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"ans_tpu_torch.models.bytes", "ans_tpu_torch.ops.bytesplit",
                "ans_tpu_torch.reference_model.byte_model",
                "ans_tpu_torch.bench_crossover", "ans_tpu_torch.constants",
                "ans_tpu_torch.profile_idle", "ans_tpu_torch.probe",
                "ans_tpu_torch.parallel",
                "ans_tpu_torch.parallel.block_runtime",
                "ans_tpu_torch.models.pseudo_adaptive",
                "ans_tpu_torch.ops.model_batch",
                "ans_tpu_torch.reference_model.rans_compat",
                "ans_tpu_torch.reference_model.shuff_compat",
                "ans_tpu_torch.reference_model.parity",
                "ans_tpu_torch.native", "ans_tpu_torch.native.build",
                "ans_tpu_torch.native.binding", "ans_tpu_torch.container",
                "ans_tpu_torch.__main__"} <= set(names), names
        import chip_smoke
        import numpy as np
        from ans_tpu_torch import models
        x = (np.arange(3000) % 700).astype(np.uint32) ** 2
        for name in ("ANSfold-2", "vbyteANS", "streamvbyteANS"):
            codec = models.get(name, device="cpu")
            assert (codec.decode(codec.encode(x), len(x)) == x).all(), name
        twice = np.repeat(np.arange(1 << 14), 2).astype(np.uint32)
        wide = np.arange(9000, dtype=np.uint32) * 5
        for name, v in (("ANS", twice), ("ANSsint-80", wide),
                        ("ANSfold-8", wide), ("ANSmsb", x),
                        ("ANSrfold-2", twice)):
            codec = models.get(name, device="cpu")
            assert (codec.decode(codec.encode(v), len(v)) == v).all()
        from ans_tpu_torch.parallel import BlockCodec
        for name in ("ANSfold-2", "ANSrfold-2"):
            block = BlockCodec(name, 3, 32, device="cpu")
            assert (block.decode(block.encode(x)) == x).all()
        for engine in ("compat", "lane"):
            pa = models.get("pseudo_adaptive", device="cpu")
            pa.block_size, pa.engine = 1000, engine
            assert (pa.decode(pa.encode(x)) == x).all()
        from ans_tpu_torch import container
        for name in ("ANS", "ANSfold-2", "ANSrfold-2", "ANSmsb", "shuff"):
            buf = container.compress(x, name, "compat", device="cpu")
            assert (container.decompress(buf, device="cpu") == x).all()
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "ans_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_import_neither_jax_nor_ans_tpu():
    """No file of the port, nor chip_smoke.py, holds an import of `jax` or
    of any `ans_tpu` module."""
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(?:jax|jaxlib|ans_tpu)(?:[.\s]|$)", re.M)
    files = sorted(Path(REPO, "ans_tpu_torch").rglob("*.py"))
    files.append(Path(REPO, "chip_smoke.py"))
    assert len(files) > 25
    for name in ("probe.py", "container.py", "__main__.py",
                 "native/__init__.py", "native/build.py",
                 "native/binding.py", "reference_model/shuff_compat.py",
                 "reference_model/parity.py"):
        assert Path(REPO, "ans_tpu_torch", name) in files, name
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path}: {hits}"
    assert pattern.findall("import jax\n") and pattern.findall(
        "    from ans_tpu.ops import x\n") and pattern.findall(
        "from ans_tpu import models\n")
    assert not pattern.findall("from ans_tpu_torch import models\n")


def test_kernel_sources_include_only_cuda_and_their_own_headers():
    """Every csrc/*.cu of build.KERNELS (the probe's op_probe.cu with
    them) and every *.cuh includes the CUDA runtime, <cstdint> and the
    port's own headers, nothing else: no library supplies a kernel."""
    own = {p.name for p in build.CSRC.glob("*.cuh")}
    assert {"common.cuh", "lockstep.cuh", "lookback.cuh"} <= own
    sources = [build.CSRC / f"{name}.cu" for name in build.KERNELS]
    assert build.CSRC / "op_probe.cu" in sources and len(sources) == 10
    assert sorted(sources) == sorted(build.CSRC.glob("*.cu"))
    for path in sources + sorted(build.CSRC.glob("*.cuh")):
        text = path.read_text()
        includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text,
                              re.M)
        assert includes, path
        assert set(includes) <= own | {"cstdint", "cuda_runtime.h"}, (
            path, includes)


# --------------------------------------------------------------------------
# the copies of ans_tpu.constants and ans_tpu.reference_model
# --------------------------------------------------------------------------

def test_constants_equal_by_value():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert len(names) == 13 and "BYTE_MAX_FRAME_SIZE" in names
    for name in names:
        assert getattr(constants, name) == getattr(jconstants, name), name
    assert [n for n in dir(constants) if n.isupper()] == names
    for f in range(1, 9):
        for fn in ("fold_threshold", "fold_offset_step", "fold_max_sigma"):
            assert getattr(constants, fn)(f) == getattr(jconstants, fn)(f)


HOST_DATASETS = ["zipf12", "zipf_large", "geometric", "uniform_small",
                 "wide", "tiny", "single_sym"]


@pytest.mark.parametrize("dataset", HOST_DATASETS)
@pytest.mark.parametrize("h_approx,u16,cap", [(1, False, None),
                                              (80, True, None),
                                              (1, True, 1 << 12)])
def test_adjust_freqs_and_prelude_copies(datasets, dataset, h_approx, u16,
                                         cap):
    """The frame search (float order decides the frame) and the prelude,
    both ways, on the conftest datasets; `single_sym` is the degenerate
    one-symbol model the originals guard."""
    x = datasets[dataset]
    if int(x.max()) >= 1 << 16:
        # huge raw alphabets go through the fold map, as the codecs do
        x = jmappings.fold_map(x, 2)
    freqs = np.bincount(x).astype(np.uint64)
    want = jmodel.adjust_freqs(freqs, int(x.max()), u16, h_approx, cap)
    got = model.adjust_freqs(freqs, int(x.max()), u16, h_approx, cap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    M = int(want.sum())
    assert model.entropy_ordered(freqs, len(x)) == jmodel.entropy_ordered(
        freqs, len(x))
    if M:
        assert model.cross_entropy_ordered(freqs, got) == \
            jmodel.cross_entropy_ordered(freqs, want)
        blob = model.serialize_prelude(got, M)
        assert blob == jmodel.serialize_prelude(want, M)
        for load in (model.load_prelude, jmodel.load_prelude):
            back, used = load(blob + b"tail")
            np.testing.assert_array_equal(back, want)
            assert used == len(blob)


COMPAT_DATASETS = ["zipf12", "geometric", "uniform_small", "tiny",
                   "single_sym"]


@pytest.mark.parametrize("dataset", COMPAT_DATASETS)
@pytest.mark.parametrize("coder", ["AnsInt", "AnsSint-5", "AnsMsb",
                                   "AnsSmsb-80", "AnsFold-2", "AnsFold-8",
                                   "AnsReorderFold-1", "AnsReorderFold-2",
                                   "AnsByte", "ShuffCompat"])
def test_rans_compat_copies(datasets, dataset, coder):
    """The compat coders (the copy, on the port's host library) write
    ans_tpu's bytes and each decodes the other's; AnsByte codes the low
    bytes of the input."""
    name, _, h = coder.partition("-")
    args = (int(h),) if h else ()
    port_mod, ref_mod = ((shuff_compat, jshuff) if name == "ShuffCompat"
                         else (rans_compat, jcompat))
    port, ref = getattr(port_mod, name)(*args), getattr(ref_mod, name)(*args)
    x = datasets[dataset]
    if name == "AnsByte":
        x = (x & 0xFF).astype(np.uint8).tobytes()
    blob = bytes(port.encode(x))
    assert blob == bytes(ref.encode(x))
    for codec in (port, ref):
        out = codec.decode(blob, len(x))
        if name == "AnsByte":
            assert out == x
        else:
            np.testing.assert_array_equal(out, x)
    assert port.name == ref.name


def test_shuff_compat_copy_helpers():
    """The shuff codec's order-defining helpers equal ans_tpu's: the
    reference's qsort order (ties included) and the code lengths."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 40, 300):
        freq = {int(s): int(f) for s, f in zip(
            rng.permutation(5 * n)[:n], rng.integers(1, 6, n))}
        got, want, fa, fb = list(freq), list(freq), dict(freq), dict(freq)
        shuff_compat._indirect_sort(fa, got, 0, n)
        jshuff._indirect_sort(fb, want, 0, n)
        assert got == want
        shuff_compat._min_redundancy(fa, got, n)
        jshuff._min_redundancy(fb, want, n)
        assert fa == fb
    for name in ("LOG2_L", "L", "LOG2_MAX_SYMBOL", "MAX_SYMBOL", "MASK64"):
        assert getattr(shuff_compat, name) == getattr(jshuff, name)


def test_parity_copy():
    """The parity helpers accept a blob that differs from the reference
    only in the final prelude word and refuse any other difference."""
    assert parity.METHODS == jparity.METHODS
    x = np.arange(5000, dtype=np.uint32) % 333
    for method, codec in (("fold2", rans_compat.AnsFold(2)),
                          ("rfold2", rans_compat.AnsReorderFold(2))):
        blob = codec.encode(x)
        assert parity.prelude_padding_span(method, blob) == \
            jparity.prelude_padding_span(method, blob)
        a, b = parity.prelude_padding_span(method, blob)
        pad = bytearray(blob)
        pad[b - 1] ^= 0x80
        for mod in (parity, jparity):
            mod.assert_blob_parity(method, blob, bytes(pad))
            bad = bytearray(blob)
            bad[-1] ^= 1
            with pytest.raises(AssertionError, match="non-padding"):
                mod.assert_blob_parity(method, blob, bytes(bad))
    data = (x & 0xFF).astype(np.uint8).tobytes()
    blob = rans_compat.AnsByte().encode(data)
    for mod in (parity, jparity):
        mod.assert_byte_blob_parity(blob, blob)
        bad = bytearray(blob)
        bad[-3] ^= 4
        with pytest.raises(AssertionError, match="non-padding"):
            mod.assert_byte_blob_parity(blob, bytes(bad))


def test_native_source_is_ans_tpus():
    """The host library's source is ans_tpu's ans_native.cpp, unchanged."""
    ours = Path(REPO, "ans_tpu_torch", "native", "ans_native.cpp")
    assert ours.read_text() == Path(REPO, "ans_tpu", "native",
                                    "ans_native.cpp").read_text()


def test_rans_compat_helpers():
    """The engine's helpers equal ans_tpu's: the encode order of the four
    states, the encode and decode tables, the fold undo and the histogram;
    a corrupt prelude's frame raises."""
    for n in (0, 1, 5, 8, 13):
        assert list(rans_compat._state_index_iter(n)) == list(
            jcompat._state_index_iter(n))
    nf = np.array([3, 0, 5, 8], np.uint32)
    assert rans_compat._enc_tables(nf) == jcompat._enc_tables(nf)
    for a, b in zip(rans_compat._dec_tables(nf), jcompat._dec_tables(nf)):
        np.testing.assert_array_equal(a, b)
    buf = bytes(range(40))
    high, nb = np.array([100, 200, 300]), np.array([0, 1, 2])
    undo, jundo = (rans_compat._make_fold_undo(buf, high, nb),
                   jcompat._make_fold_undo(buf, high, nb))
    for sym in range(3):
        assert undo(sym, 30) == jundo(sym, 30)
    x = np.array([4, 4, 1, 9], np.uint32)
    np.testing.assert_array_equal(rans_compat._hist(x, 12),
                                  jcompat._hist(x, 12))
    with pytest.raises(ValueError, match="power of two"):
        rans_compat.interleaved_decode(b"\0" * 40, 4, np.array([3, 2]))
    assert rans_compat.NUM_STATES == jcompat.NUM_STATES


def test_model_degenerate_inputs():
    one = np.zeros(43, np.uint64)
    one[42] = 1000
    np.testing.assert_array_equal(model.adjust_freqs(one, 42, False),
                                  jmodel.adjust_freqs(one, 42, False))
    for mod in (model, jmodel):
        with pytest.raises(ValueError, match="all-zero"):
            mod.adjust_freqs(np.zeros(5, np.uint64), 4, False)
    for x in (0, 1, 2, 3, 4096, 4097, (1 << 31) + 5):
        assert model.next_power_of_two(x) == jmodel.next_power_of_two(x)
        assert model.is_power_of_two(x) == jmodel.is_power_of_two(x)


@pytest.mark.parametrize("n,u", [(1, 1), (1, 7), (5, 5), (256, 4352),
                                 (1000, 1 << 20), (3000, 3001)])
def test_interp_copy(n, u):
    rng = np.random.default_rng(n + u)
    seq = np.sort(rng.choice(u, size=n, replace=False)).astype(np.uint64)
    blob = interp.encode(seq, n, u)
    assert blob == jinterp.encode(seq, n, u)
    for mod in (interp, jinterp):
        vals, words = mod.decode(b"\x00\x00\x00" + blob, n, u, bit_offset=24)
        assert list(vals) == seq.tolist()
        assert words == jinterp.decode(blob, n, u)[1]


@pytest.mark.parametrize("x", [0, 1, 127, 128, 16383, 16384, (1 << 28) - 1,
                               1 << 28, (1 << 32) - 1])
def test_vbyte_header_copy(x):
    blob = vbyte.encode_u32(x)
    assert blob == jvbyte.encode_u32(x)
    assert vbyte.decode_u32(b"\x80" + blob, 1) == jvbyte.decode_u32(
        b"\x80" + blob, 1) == (x, 1 + len(blob))


@pytest.mark.parametrize("fidelity", range(1, 9))
def test_fold_unmap_copy(fidelity):
    syms = np.arange(constants.fold_max_sigma(fidelity), dtype=np.uint32)
    for a, b in zip(mappings.fold_unmap_high(syms, fidelity),
                    jmappings.fold_unmap_high(syms, fidelity)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


_U32_EDGES = np.array([0, 1, 255, 256, 257, 511, 512, 513, (1 << 16) - 1,
                       1 << 16, (1 << 16) + 1, (1 << 24) - 1, 1 << 24,
                       (1 << 24) + 1, (1 << 31) - 1, 1 << 31,
                       (1 << 32) - 1], dtype=np.uint32)


def _u32_sample():
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 32, size=20000, dtype=np.uint64) >> (
        rng.integers(0, 32, size=20000).astype(np.uint64))
    return np.concatenate([_U32_EDGES, x.astype(np.uint32)])


def test_msb_copies():
    """msb_map over every bucket's edges, msb_exception_bytes and
    msb_unmap_high over all 1280 buckets."""
    x = _u32_sample()
    np.testing.assert_array_equal(mappings.msb_map(x), jmappings.msb_map(x))
    b = np.arange(constants.MSB_MAX_SIGMA, dtype=np.uint32)
    for name in ("msb_exception_bytes", "msb_unmap_high"):
        got, want = getattr(mappings, name)(b), getattr(jmappings, name)(b)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("fidelity", range(1, 9))
def test_fold_map_copies(fidelity):
    x = _u32_sample()
    for name in ("fold_exception_count", "fold_map"):
        got = getattr(mappings, name)(x, fidelity)
        want = getattr(jmappings, name)(x, fidelity)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(mappings.fold_exceptions(x, fidelity),
                         jmappings.fold_exceptions(x, fidelity)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("fidelity", [1, 2, 5])
@pytest.mark.parametrize("kind", ["zipf", "few", "ties", "one"])
def test_craft_reorder_copies(fidelity, kind):
    """The rfold reorder (wire: the header and the remap), taken and not
    taken, with tied counts (ordered by value)."""
    rng = np.random.default_rng(fidelity)
    x = {"zipf": (rng.zipf(1.2, 30000) % 50000),
         "few": rng.integers(0, 200, 5000),
         "ties": np.repeat(rng.permutation(3000), 3),
         "one": np.full(10, 7)}[kind].astype(np.uint32)
    got, want = mappings.craft_reorder(x, fidelity), jmappings.craft_reorder(
        x, fidelity)
    np.testing.assert_array_equal(got[0], want[0])
    assert bytes(got[1]) == bytes(want[1])
    counts = np.bincount(x)
    a, b = (mappings.craft_reorder_from_counts(counts, fidelity),
            jmappings.craft_reorder_from_counts(counts, fidelity))
    assert (a[0] is None) == (b[0] is None) and bytes(a[1]) == bytes(b[1])
    if a[0] is not None:
        np.testing.assert_array_equal(a[0], b[0])


def _byte_hists():
    rng = np.random.default_rng(12)
    one = np.zeros(256, np.uint64)
    one[7] = 12345
    sparse = np.zeros(256, np.uint64)
    sparse[rng.choice(256, 37, replace=False)] = rng.integers(1, 10 ** 6, 37)
    return {"one": one, "sparse": sparse,
            "flat": np.full(256, 3, np.uint64),
            "zipf": (10 ** 7 / np.arange(1, 257) ** 1.3).astype(np.uint64),
            "skew": np.concatenate([[1 << 40], np.ones(255)]).astype(
                np.uint64),
            "vbyte": np.bincount(np.frombuffer(
                b"".join(jvbyte.encode_u32(int(v)) for v in
                         rng.zipf(1.2, 4000) % (1 << 30)), np.uint8),
                minlength=256).astype(np.uint64)}


@pytest.mark.parametrize("kind", sorted(_byte_hists()))
def test_byte_model_copy(kind):
    """The 256-symbol normaliser and the raw interp prelude over universe
    4096 + 256, both ways."""
    hist = _byte_hists()[kind]
    want = jcompat.byte_adjust_freqs(hist)
    got = byte_model.byte_adjust_freqs(hist)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    M = int(got.sum())
    assert M <= constants.BYTE_MAX_FRAME_SIZE and M & (M - 1) == 0
    prelude, nf = byte_model.byte_prelude_encode(hist)
    jprelude, jnf = jcompat.byte_prelude_encode(hist)
    assert prelude == jprelude == byte_model.byte_prelude_serialize(want)
    np.testing.assert_array_equal(nf, jnf)
    for decode in (byte_model.byte_prelude_decode,
                   jcompat.byte_prelude_decode):
        back, off = decode(prelude + b"stream")
        np.testing.assert_array_equal(back, want)
        assert off == len(prelude) and back.dtype == np.int64


def test_idle_share_counts_overlap_once():
    """The idle share's busy time is the union of the device intervals
    inside each call's span: overlapping and out-of-span work is not
    counted twice or at all."""
    from ans_tpu_torch import profile_idle
    assert profile_idle.union_length([(0, 4), (2, 6), (8, 9), (8.5, 9)]) \
        == 7
    ev = [{"cat": "user_annotation", "name": "dec", "ts": 100, "dur": 50},
          {"cat": "user_annotation", "name": "dec", "ts": 200, "dur": 50},
          {"cat": "kernel", "name": "k3", "ts": 95, "dur": 15},
          {"cat": "kernel", "name": "k3", "ts": 105, "dur": 10},
          {"cat": "gpu_memcpy", "name": "copy", "ts": 210, "dur": 30},
          {"cat": "kernel", "name": "late", "ts": 300, "dur": 9},
          {"cat": "cpu_op", "name": "host", "ts": 100, "dur": 50}]
    r = profile_idle.idle_share(ev, "dec")
    assert r["calls"] == 2 and r["wall_us"] == 50
    assert r["busy_us"] == (15 + 30) / 2
    assert r["idle_share"] == 1 - 45 / 100
    assert r["ops_us"] == {"k3": 12.5, "copy": 15.0}
    with pytest.raises(RuntimeError, match="no device work"):
        profile_idle.idle_share(ev, "enc")


def test_idle_share_splits_host_time():
    """The host's time in a span: the outermost torch operations and CUDA
    calls by name (a call inside an operation is not counted again), and
    the rest; calls outside the span are left out."""
    from ans_tpu_torch import profile_idle
    ev = [{"cat": "user_annotation", "name": "enc", "ts": 0, "dur": 100},
          {"cat": "kernel", "name": "k1", "ts": 10, "dur": 40},
          {"cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 20},
          {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 12,
           "dur": 15},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40,
           "dur": 5},
          {"cat": "cpu_op", "name": "aten::zeros", "ts": 60, "dur": 10},
          {"cat": "cpu_op", "name": "aten::empty", "ts": 62, "dur": 3},
          {"cat": "cpu_op", "name": "aten::item", "ts": 95, "dur": 10}]
    h = profile_idle.idle_share(ev, "enc")["host_us"]
    assert h["calls"] == {"aten::copy_": 20, "aten::zeros": 10,
                          "cudaLaunchKernel": 5}
    assert h["in_calls"] == 35 and h["outside_calls"] == 65


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the first use of a kernel raises a clear error, with no
    fallback and nothing left in the build directory."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})
    for name in build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_all()
    assert not (tmp_path / "_build").exists()
    assert all((build.CSRC / f"{name}.cu").exists() for name in build.KERNELS)


def test_build_names_library_by_source():
    """The library path changes with the kernel's source hash, so an
    edited kernel is rebuilt rather than loaded stale."""
    a = build._library_path("decode_search")
    assert a.parent == build.BUILD_DIR and a.name.startswith(
        "libdecode_search-")
    assert build._library_path("place") != a


# --------------------------------------------------------------------------
# the grouped layout and the tail escape
# --------------------------------------------------------------------------

def _large_freqs(kind: str) -> np.ndarray:
    """Frequency vectors for the layout and escape copies: adversarial
    (the most distinct frequencies a frame allows), uniform, zipf, the
    2^13 / 2^13+1 boundary, sparse with gaps, a mixed-frequency tail the
    escape declines and a byte-aligned uniform tail it takes."""
    if kind == "adversarial":
        f = np.arange(1, 90, dtype=np.uint64)
        return np.append(f, (1 << 12) - int(f.sum())).astype(np.uint64)
    if kind == "uniform":
        return np.ones(1 << 14, np.uint64)
    if kind in ("boundary", "boundary+1"):
        nf = np.ones((1 << 13) + (kind == "boundary+1"), np.uint64)
        nf[0] += (1 << 14) - int(nf.sum())
        return nf
    if kind == "zipf":
        x = zipf(np.random.default_rng(0), 200000, 1 << 20)
    elif kind == "sparse":
        x = np.random.default_rng(1).integers(0, 1 << 18, size=30000) * 3
    elif kind == "mixed_tail":
        x = np.concatenate([np.arange(12000), np.arange(0, 12000, 2),
                            np.random.default_rng(8).integers(0, 500, 9000)])
    else:  # "twice"
        x = np.repeat(np.arange(1 << 14), 2)
    x = x.astype(np.uint32)
    freqs = np.bincount(x).astype(np.uint64)
    return adjust_freqs(freqs, int(x.max()), False, 1)


LARGE_KINDS = ["adversarial", "uniform", "boundary", "boundary+1", "zipf",
               "sparse", "mixed_tail", "twice"]


@pytest.mark.parametrize("kind", LARGE_KINDS)
def test_group_layout(kind):
    nf = _large_freqs(kind)
    got, want = grouped.build_group_layout(nf), jgrouped.build_group_layout(nf)
    _assert_same(got, want, ["perm", "rank_of", "g_f", "g_rank0", "g_slot0",
                             "g_magic", "slot_depth", "rank_depth", "sigma",
                             "frame_size", "log2m", "num_groups"])
    for a, b in ((got.slot_pivots, want.slot_pivots),
                 (got.rank_pivots, want.rank_pivots)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert grouped.use_grouped_layout(nf) == jgrouped.use_grouped_layout(nf)


@pytest.mark.parametrize("kind", LARGE_KINDS + ["small"])
def test_escape_plan(kind):
    nf = _large_freqs(kind) if kind != "small" else np.ones(100, np.uint64)
    got, want = escape.plan_from_freqs(nf), jescape.plan_from_freqs(nf)
    assert (got is None) == (want is None)
    if kind == "twice":
        assert got is not None  # a byte-aligned uniform tail escapes
    if kind in ("mixed_tail", "small", "boundary"):
        assert got is None
    if got is None:
        return
    _assert_same(got, want, ["K", "nb", "var_highs", "frame_freqs",
                             "sym_high", "sym_nb", "rank_of", "loss_bits",
                             "sigma", "num_variants"])
    values = np.flatnonzero(nf).astype(np.uint32)
    for a, b in zip(got.map_values(values), want.map_values(values)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["adversarial", "zipf", "sparse"])
def test_grouped_device_tables(kind):
    """The grouped device layouts hold the layout's own arrays: group rows
    [f, magic, slot0, rank0], the pivot levels laid out like the search
    bases, the per-rank output table; ans_tpu's layout lays out alike."""
    nf = _large_freqs(kind)
    lay = grouped.build_group_layout(nf)
    NG = lay.num_groups
    for src in (lay, jgrouped.build_group_layout(nf)):
        enc = tables.grouped_enc_to_device(src, "cpu", rank_of=True)
        rows = enc.groups.numpy().view(np.uint32)
        np.testing.assert_array_equal(
            rows, np.stack([lay.g_f, lay.g_magic, lay.g_slot0, lay.g_rank0],
                           axis=1))
        assert enc.bases.numel() == (1 << lay.rank_depth) + 1
        np.testing.assert_array_equal(enc.bases.numpy()[:NG], lay.g_rank0)
        assert (enc.bases.numpy()[NG:] == lay.sigma).all()
        np.testing.assert_array_equal(enc.rank_of.numpy(), lay.rank_of)
    ids = np.arange(len(nf), dtype=np.uint32)
    for high, nb in ((None, None), (ids * np.uint32(7), ids % np.uint32(4))):
        gt = tables.build_grouped_table(nf, high, nb)
        dec = tables.to_device(gt, "cpu")
        np.testing.assert_array_equal(dec.bases.numpy()[:NG], lay.g_slot0)
        assert (dec.bases.numpy()[NG:] == lay.frame_size).all()
        if high is None:
            identity = (lay.perm == np.arange(lay.sigma)).all()
            want = [] if identity else lay.perm
            assert dec.NE == 0 and dec.nb.numel() == 0
        else:
            want = high[lay.perm]
            assert dec.NE == 3 and dec.nb.dtype == torch.uint8
            np.testing.assert_array_equal(dec.nb.numpy(), nb[lay.perm])
        np.testing.assert_array_equal(dec.table.numpy().view(np.uint32),
                                      want)
        assert dec.NR == tables.max_renorm_rounds(lay.log2m)
