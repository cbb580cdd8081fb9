"""The host codecs of the port against ans_tpu: shuff (lane engine), arith,
optpfor, fse, huffzero, their vbyte / streamvbyte composites and
entropy_only write ans_tpu's bytes and decode exactly; the host library's
tANS, shuff, arith and mtf loops equal their plain bodies (`_native`
None), Huffman ties included; the codecs report ans_tpu's stats; corrupt
wires raise; the recorded blobs of tests/fixtures/lane/host.json
reproduce.  All comparisons are exact.

ans_tpu's host codecs run their pure-Python bodies here (its native
library is not built), so the inputs held against ans_tpu are cut as
ans_tpu's own tests cut them; the port's library is held to its own
plain bodies on the larger ones."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from ans_tpu import models as ref_models
from ans_tpu.models import shuff as ref_shuff
from ans_tpu.utils import bwt as ref_bwt
from ans_tpu.utils.stats import recording as ref_recording
from ans_tpu_torch import models, native
from ans_tpu_torch.models import arith, bytes as pbytes, shuff, tans
from ans_tpu_torch.reference_model import vbyte
from ans_tpu_torch.reference_model.byte_model import byte_adjust_freqs
from ans_tpu_torch.utils import bwt
from ans_tpu_torch.utils.stats import recording

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"

# the names this slice registered (ans_tpu/models/__init__.py:22-44)
HOST_NAMES = ["shuff", "optpfor", "OptPFor", "arith", "fse", "huffzero",
              "huff0", "vbytefse", "streamvbytefse", "vbytehuffzero",
              "streamvbytehuffzero", "entropy_only", "entropy"]
COMPOSITES = ["vbytefse", "streamvbytefse", "vbytehuffzero",
              "streamvbytehuffzero"]

# (name, dataset, cut) as ans_tpu's tests/test_baseline_codecs.py cuts
# them: the splitters (optpfor) on whole datasets, the entropy coders on
# zipf12[:8000], the composites on zipf12[:6000] and wide[:4000]; the
# dense-alphabet coders (shuff, arith: a histogram over 0..max) never see
# `wide`, whose values reach 2^28
CASES = (
    [("optpfor", d, None) for d in ("zipf12", "wide", "tiny", "geometric",
                                    "single_sym")]
    + [(n, d, c) for n in ("shuff", "arith", "fse", "huffzero")
       for d, c in (("zipf12", 8000), ("tiny", None), ("geometric", 8000),
                    ("single_sym", None))]
    + [(n, d, c) for n in ("fse", "huffzero")
       for d, c in (("wide", 4000),)]
    + [(n, d, c) for n in COMPOSITES
       for d, c in (("zipf12", 6000), ("wide", 4000), ("tiny", None),
                    ("single_sym", None))]
    + [("entropy_only", d, None) for d in ("zipf12", "wide", "tiny")]
    + [("OptPFor", "zipf12", None), ("huff0", "zipf12", 8000),
       ("entropy", "geometric", None)])


_REF = {}


def _ref_blob(name, data, cut, x):
    """ans_tpu's blob of x (datasets[data][:cut]), once per (name, data,
    cut): the port's engines are held to the same one."""
    key = (name, data, cut)
    if key not in _REF:
        _REF[key] = ref_models.get(name).encode(x)
    return _REF[key]


def test_registry_equals_ans_tpus():
    """Both engines name what ans_tpu's name; the host codecs ignore the
    device, shuff is the LUT codec under lane and the reference's wire
    under compat."""
    for engine in ("lane", "compat"):
        assert models.available(engine) == ref_models.available(engine)
    assert not hasattr(models, "_UNPORTED")
    assert isinstance(models.get("shuff", device="cpu"), shuff.Shuff)
    from ans_tpu_torch.reference_model.shuff_compat import ShuffCompat
    assert isinstance(models.get("shuff", engine="compat", device="cpu"),
                      ShuffCompat)
    for name in HOST_NAMES:
        for engine in ("lane", "compat"):
            codec = models.get(name, engine=engine, device="cpu")
            ref = ref_models.get(name, engine)
            assert codec.name == ref.name, name
    with pytest.raises(KeyError, match="unknown method 'no-such'; known: "):
        models.get("no-such", device="cpu")


# under compat, shuff is ShuffCompat (tests/test_torch_compat.py)
@pytest.mark.parametrize("name,data,cut,engine", [
    (*case, engine) for engine in ("lane", "compat") for case in CASES
    if (engine, case[0]) != ("compat", "shuff")])
def test_blob_identical_and_decodes(datasets, name, data, cut, engine):
    x = datasets[data][:cut]
    codec = models.get(name, engine=engine, device="cpu")
    blob = codec.encode(x)
    assert blob == _ref_blob(name, data, cut, x)
    if name.startswith("entropy"):
        with pytest.raises(RuntimeError):
            codec.decode(blob, len(x))
        return
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


@pytest.mark.parametrize("name", ["shuff", "arith"])
def test_single_and_skewed(name):
    """ans_tpu's test_shuff_single_and_skewed inputs."""
    skew = np.r_[np.zeros(10000), np.arange(40)].astype(np.uint32)
    for x in (np.full(300, 9, np.uint32), skew):
        blob = models.get(name, device="cpu").encode(x)
        assert blob == ref_models.get(name).encode(x)
        np.testing.assert_array_equal(
            models.get(name, device="cpu").decode(blob, len(x)), x)


@pytest.mark.parametrize("name", ["vbytehuffzero", "huffzero"])
def test_byte_huffman_blocks(name):
    """Several 128 KiB ByteShuff blocks, huffzero's first one stored
    (random bytes do not compress): the wire is ans_tpu's."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.integers(0, 1 << 32, 40000, dtype=np.uint32),
                        (rng.zipf(1.3, 60000) % 300).astype(np.uint32)])
    port = models.get(name, device="cpu")
    blob = port.encode(x)
    assert blob == ref_models.get(name).encode(x)
    assert len(blob) > 2 * pbytes.ByteShuff.BLOCK // 2
    if name == "huffzero":
        assert blob[:4] == (0xFFFFFFFF).to_bytes(4, "little")
    np.testing.assert_array_equal(port.decode(blob, len(x)), x)


def test_composite_copies_the_stream_once(monkeypatch):
    """A host-entropy composite hands its entropy stage the whole split
    stream in one piece and its split stage the whole decoded stream."""
    calls = []
    orig_enc, orig_dec = pbytes._HostBytes.encode_tensor, \
        pbytes._HostBytes.decode_tensor

    def enc(self, stream):
        calls.append(("enc", int(stream.numel())))
        return orig_enc(self, stream)

    def dec(self, buf, n):
        out = orig_dec(self, buf, n)
        calls.append(("dec", int(out.numel())))
        return out

    monkeypatch.setattr(pbytes._HostBytes, "encode_tensor", enc)
    monkeypatch.setattr(pbytes._HostBytes, "decode_tensor", dec)
    x = np.arange(300000, dtype=np.uint32) * 7
    codec = models.get("vbytehuffzero", device="cpu")
    blob = codec.encode(x)
    nb = int.from_bytes(blob[:4], "little")
    assert nb > 2 * pbytes.ByteShuff.BLOCK
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
    assert calls == [("enc", nb), ("dec", nb)]


# --------------------------------------------------------------------------
# the host library against the plain bodies
# --------------------------------------------------------------------------

@pytest.fixture
def plain(monkeypatch):
    """Run the host codecs on their plain bodies."""
    def go():
        for mod in (tans, shuff, arith, bwt):
            monkeypatch.setattr(mod, "_native", None)
    return go


def _zipf(n, seed, a=1.3, clip=1 << 20):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, n) - 1).clip(0, clip).astype(np.uint32)


LIB_INPUTS = {
    "zipf": lambda: _zipf(1 << 16, 1),
    "uniform16": lambda: np.random.default_rng(2).integers(
        0, 1 << 16, 1 << 15, dtype=np.uint32),
    "geometric": lambda: (np.random.default_rng(3).geometric(
        0.05, 1 << 15) - 1).astype(np.uint32),
    "single": lambda: np.full(777, 5, np.uint32),
    "one": lambda: np.array([123456], np.uint32),
}


@pytest.mark.parametrize("kind", sorted(LIB_INPUTS))
@pytest.mark.parametrize("name", ["shuff", "arith", "fse", "vbytefse",
                                  "huffzero"])
def test_library_equals_plain(plain, name, kind):
    """Each codec's blob on the library equals its blob on the plain
    bodies, and each decodes the other's."""
    x = LIB_INPUTS[kind]()
    codec = models.get(name, device="cpu")
    lib_blob = codec.encode(x)
    lib_out = codec.decode(lib_blob, len(x))
    plain()
    assert codec.encode(x) == lib_blob
    np.testing.assert_array_equal(codec.decode(lib_blob, len(x)), x)
    np.testing.assert_array_equal(lib_out, x)


def _tie_hists():
    """Histograms heavy in Huffman ties: equal counts, counts that merge
    into equal sums, powers of two, and 300 draws of zipf, uniform and
    geometric data."""
    rng = np.random.default_rng(11)
    hists = [np.full(1000, 5), np.full(257, 1), np.repeat([1, 2, 4, 8], 64),
             np.array([1, 1, 2, 2, 4, 4, 8, 8, 16, 16, 32, 32] * 20),
             np.array([3, 3, 3, 6, 6, 12, 12, 12] * 40),
             2 ** np.arange(40), np.array([1, 1]), np.array([7, 1, 7, 1])]
    for i in range(300):
        n = int(rng.integers(50, 5000))
        kind = i % 3
        if kind == 0:
            v = rng.zipf(1.2 + rng.random(), n) % 2000
        elif kind == 1:
            v = rng.integers(0, int(rng.integers(2, 3000)), n)
        else:
            v = rng.geometric(0.02 + 0.5 * rng.random(), n)
        c = np.bincount(v)
        hists.append(c[c > 0])
    return [np.asarray(h, np.uint64) for h in hists]


def test_huff_code_lengths_ties(plain):
    """The library's two-queue merge after the stable argsort gives the
    heap body's lengths, and ans_tpu's (its heap body here), on
    tie-heavy histograms: Huffman tie-breaking is wire format."""
    hists = _tie_hists()
    lib = [shuff.code_lengths(h) for h in hists]
    limited = [shuff.limited_code_lengths(h, cap=12) for h in hists]
    plain()
    for h, want, lim in zip(hists, lib, limited):
        got = shuff.code_lengths(h)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref_shuff.code_lengths(h), want)
        np.testing.assert_array_equal(
            shuff.limited_code_lengths(h, cap=12), lim)
        np.testing.assert_array_equal(
            ref_shuff.limited_code_lengths(h, cap=12), lim)


TANS_CASES = {
    "uniform": lambda r: r.integers(0, 256, 4000, dtype=np.uint8),
    "zipf": lambda r: (r.zipf(1.3, 1 << 17) % 256).astype(np.uint8),
    "skewed4": lambda r: r.integers(0, 4, 30000, dtype=np.uint8),
    "single": lambda r: np.zeros(500, np.uint8),
    "one-elem": lambda r: np.array([7], np.uint8),
    "two-sym-extreme": lambda r: np.where(
        r.random(10000) < 0.999, 0, 255).astype(np.uint8),
}


@pytest.mark.parametrize("case", sorted(TANS_CASES))
def test_tans_library_equals_plain(case):
    """The library's tans_encode / tans_decode against the plain loops
    (ans_tpu's tests/test_tans.py cases, zipf at 2^17 bytes)."""
    data = TANS_CASES[case](np.random.default_rng(3))
    t = tans.build_tables(byte_adjust_freqs(
        np.bincount(data, minlength=256).astype(np.uint64)))
    want = tans._encode_py(data, t)
    got = native.lib().tans_encode(data, t)
    assert got == want
    out = native.lib().tans_decode(got[2], got[1], got[0], len(data), t)
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(
        tans._decode_py(got[2], got[1], got[0], len(data), t), data)


@pytest.mark.parametrize("sigma,n", [(1, 10), (256, 1 << 17),
                                     (5000, 1 << 15)])
def test_mtf_library_equals_plain(plain, sigma, n):
    """utils.bwt.mtf on the library against its plain loop and ans_tpu's;
    mtf_inverse takes the ranks back."""
    rng = np.random.default_rng(sigma)
    x = (rng.zipf(1.2, n) % sigma).astype(np.uint32)
    lib = bwt.mtf(x)
    plain()
    np.testing.assert_array_equal(bwt.mtf(x), lib)
    np.testing.assert_array_equal(ref_bwt.mtf(x[:4096]), lib[:4096])
    np.testing.assert_array_equal(bwt.mtf_inverse(lib, int(x.max()) + 1), x)
    with pytest.raises(ValueError, match="out of range"):
        bwt.mtf(x, sigma=int(x.max()))


# --------------------------------------------------------------------------
# stats, corrupt wires, recorded blobs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ANS", "ANSfold-2", "ANSrfold-2",
                                  "vbyteANS", "shuff", "arith", "fse",
                                  "optpfor"])
def test_record_stats_equal_ans_tpus(datasets, name):
    """utils.stats' prelude / stream byte split of each encode equals
    ans_tpu's (the times are each package's own)."""
    x = datasets["zipf12"][:8000]
    with recording() as st:
        blob = models.get(name, device="cpu").encode(x)
    with ref_recording() as ref:
        assert ref_models.get(name).encode(x) == blob
    assert (st.prelude_bytes, st.encode_bytes) == (ref.prelude_bytes,
                                                  ref.encode_bytes)
    if name != "arith":  # arith's recursive prelude records its own
        assert st.prelude_bytes + st.encode_bytes == len(blob) - (
            4 if name == "vbyteANS" else 0)
    assert st.encode_time_ns > 0


def _corrupt_shuff():
    vals = (np.random.default_rng(3).zipf(1.3, 5000) - 1).clip(
        0, 1 << 20).astype(np.uint32)
    blob = shuff.Shuff().encode(vals)
    _, p1 = vbyte.decode_u32(blob, 0)
    _, p2 = vbyte.decode_u32(blob, p1)
    _, p3 = vbyte.decode_u32(blob, p2)
    return vals, {"forged max_len": (blob[:p2] + bytes(vbyte.encode_u32(60))
                                     + blob[p3:], "corrupt shuff"),
                  "truncated": (blob[:-10], "corrupt shuff")}


def _corrupt_arith():
    vals = (np.random.default_rng(5).zipf(1.4, 5000) - 1).clip(
        0, 1 << 20).astype(np.uint32)
    blob = arith.Arith().encode(vals)
    _, p1 = vbyte.decode_u32(blob, 0)
    _, p2 = vbyte.decode_u32(blob, p1)
    forged = bytearray(blob)
    forged[p2] = 40  # total_log2 out of range
    wrong = bytearray(blob)
    wrong[p2] = 17 if blob[p2] != 17 else 18  # frequencies off the total
    return vals, {"total_log2": (bytes(forged), "corrupt arith"),
                  "frequency sum": (bytes(wrong), "corrupt arith")}


def _corrupt_tans():
    data = (np.random.default_rng(6).zipf(1.3, 5000) % 256).astype(np.uint8)
    blob = tans.ByteTans().encode(data.tobytes())
    return data, {"truncated": (blob[:-40], "corrupt tans")}


@pytest.mark.parametrize("backend", ["library", "plain"])
@pytest.mark.parametrize("coder,case", [
    ("shuff", "forged max_len"), ("shuff", "truncated"),
    ("arith", "total_log2"), ("arith", "frequency sum"),
    ("tans", "truncated")])
def test_corrupt_wire_raises(plain, backend, coder, case):
    """ans_tpu's corrupt-wire cases (tests/test_baseline_codecs.py:91-169,
    and a tANS payload shorter than its bit count) raise ValueError on
    both backends."""
    vals, cases = {"shuff": _corrupt_shuff, "arith": _corrupt_arith,
                   "tans": _corrupt_tans}[coder]()
    buf, match = cases[case]
    codec = {"shuff": shuff.Shuff, "arith": arith.Arith,
             "tans": tans.ByteTans}[coder]()
    if backend == "plain":
        plain()
    with pytest.raises(ValueError, match=match):
        codec.decode(buf, len(vals))


HOST_RECORD = json.loads((LANE_FIXTURES / "host.json").read_text())


@pytest.mark.parametrize("rec", HOST_RECORD, ids=[r["blob"]
                                                  for r in HOST_RECORD])
def test_recorded_blobs(rec):
    """ans_tpu's small blobs of the byte splitters, host codecs and
    host-entropy composites: the port writes them and decodes them."""
    x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
    blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
    assert hashlib.sha256(blob).hexdigest() == rec["sha256"]
    codec = models.get(rec["method"], device="cpu")
    assert codec.encode(x) == blob
    if rec["method"] != "entropy_only":
        np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
