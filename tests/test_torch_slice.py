"""The ported slices as a whole, on the CPU: ans_tpu_torch's ANSfold, ANS
and ANSsint codecs write the same bytes as ans_tpu's on every route
(pivot search, the frequency-grouped layout, the tail escape), each
decodes the other's blobs, the prepared API reproduces encode() and
takes ans_tpu's engine, the committed golden fixtures round-trip, and
what is not ported refuses clearly."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from ans_tpu import models as ref_models
from ans_tpu.models import engine as ref_engine
from ans_tpu.models.ans import AnsFold as RefAnsFold
from ans_tpu.models.ans import AnsInt as RefAnsInt
from ans_tpu.models.ans import AnsMsb as RefAnsMsb
from ans_tpu.models.ans import AnsReorderFold as RefAnsReorderFold
from ans_tpu.models.ans import AnsSint as RefAnsSint
from ans_tpu.models.ans import AnsSmsb as RefAnsSmsb
from ans_tpu.ops import escape as ref_escape
from ans_tpu.reference_model.model import load_prelude
from ans_tpu.utils.zipf import zipf as ref_zipf
from ans_tpu_torch import inputs, models
from ans_tpu_torch.models import engine
from ans_tpu_torch.models.ans import AnsFold, AnsInt
from ans_tpu_torch.ops import decode, encode, place, tables

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"
MANIFEST = json.loads((LANE_FIXTURES / "manifest.json").read_text())
ZIPF20 = json.loads((LANE_FIXTURES / "fullwidth_zipf20.json").read_text())


@pytest.mark.parametrize("fidelity", [1, 2, 4])
@pytest.mark.parametrize("lanes", [None, 128, 4096])
@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "wide"])
def test_blob_identical_and_cross_decode(datasets, name, fidelity, lanes):
    x = datasets[name]
    ref = RefAnsFold(fidelity, lanes=lanes)
    port = AnsFold(fidelity, lanes=lanes, device="cpu")
    blob = port.encode(x)
    ref_blob = ref.encode(x)
    assert blob == ref_blob
    np.testing.assert_array_equal(port.decode(ref_blob, len(x)), x)
    np.testing.assert_array_equal(ref.decode(blob, len(x)), x)


@pytest.mark.parametrize("name", ["tiny", "single_sym", "geometric"])
def test_edge_datasets(datasets, name):
    x = datasets[name]
    codec = models.get("ANSfold-2", device="cpu")
    blob = codec.encode(x)
    assert blob == RefAnsFold(2).encode(x)
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


@pytest.mark.parametrize("lanes", [32, 128])
def test_prepared_api_identity(datasets, lanes):
    x = datasets["zipf_large"]
    blob = AnsFold(2, lanes=lanes, device="cpu").encode(x)
    pe = models.prepare_encoder("ANSfold-2", x, lanes=lanes, device="cpu")
    assert pe.prelude + pe.to_bytes(*pe()) == blob
    assert pe.prelude + pe.to_bytes(*pe()) == blob  # repeatable
    pd = models.prepare_decoder("ANSfold-2", blob, len(x), device="cpu")
    np.testing.assert_array_equal(pd.to_host(pd()), x)
    assert pd().shape == (pd.T, lanes)


@pytest.mark.parametrize("rec", MANIFEST, ids=[r["blob"] for r in MANIFEST])
def test_golden_fixture(rec):
    """Blobs written by ans_tpu (tests/fixtures/lane/make_fixtures.py)
    decode exactly and re-encode to the same bytes."""
    x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
    blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
    assert len(x) == rec["n"]
    codec = models.get(rec["method"], lanes=rec["lanes"], device="cpu")
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
    assert codec.encode(x) == blob
    table, _ = codec._dec_table(blob)
    assert isinstance(table, tables.GroupedTable) == rec["grouped"]


def test_full_width_record():
    """The full-width record names one reference blob per numpy input
    stream, all of the main path's shape."""
    rec = json.loads((LANE_FIXTURES / "fullwidth.json").read_text())
    assert rec["n"] == 1 << 25 and rec["lanes"] == 4096
    assert rec["inputs"]
    for e in rec["inputs"]:
        assert (e["M"], e["t_sec"], e["sections"]) == (1 << 15, 512, 16)


@pytest.mark.parametrize("rec", ZIPF20["inputs"],
                         ids=lambda e: f"{e['input']}-{e['method']}")
def test_grouped_full_width_record(rec):
    """The grouped path's full-width records: ANSfold-7 on zipf20 is a
    grouped frame, ANS on zipf20 takes the tail escape onto the pivot
    search, ANS on dense22 is a grouped frame the escape declines; ANSmsb
    and ANSrfold-2 on zipf20 (phase 9 of chip_smoke.py) are value-order
    frames."""
    assert rec["lanes"] == 4096 and ZIPF20["lanes"] == 4096
    want = {("zipf20", "ANSfold-7"): (True, 1 << 17),
            ("zipf20", "ANS"): (False, 1 << 22),
            ("dense22", "ANS"): (True, 1 << 19),
            ("zipf20", "ANSmsb"): (False, 1 << 12),
            ("zipf20", "ANSrfold-2"): (False, 1 << 13)}
    assert (rec["grouped"], rec["M"]) == want[rec["input"], rec["method"]]


def test_card_inputs_are_the_reference_inputs():
    """The card scripts draw the grouped path's inputs with the port's
    copy of ans_tpu/utils/zipf.py (ans_tpu_torch.inputs): the copy draws
    the same values, and its dense22 is the recorded stream."""
    for N, q in ((1 << 20, 1.0), (1 << 16, 1.5), (100, 2.0)):
        np.testing.assert_array_equal(
            inputs.zipf_sample(np.random.default_rng(3), 50000, N, q),
            ref_zipf(np.random.default_rng(3), 50000, N, q))
    dense = inputs.dense_input(1 << 22)
    sha = hashlib.sha256(dense.tobytes()).hexdigest()
    assert sha in {e["input_sha256"] for e in ZIPF20["inputs"]
                   if e["input"] == "dense22"}


def test_registry():
    """Every name of ans_tpu's registry (the host codecs since they were
    ported)."""
    assert models.available() == sorted(
        ["ANS", "ANSmsb"] + [f"ANSfold-{f}" for f in range(1, 9)]
        + [f"ANSrfold-{f}" for f in range(1, 9)]
        + [f"ANSsint-{h}" for h in (1, 5, 10, 20, 40, 80, 160, 320)]
        + [f"ANSsmsb-{h}" for h in (1, 5, 10, 20, 40, 80, 160, 320)]
        + ["vbyte", "streamvbyte", "vbyteANS", "streamvbyteANS",
           "pseudo_adaptive", "optpfor", "OptPFor", "shuff", "arith", "fse",
           "huffzero", "huff0", "vbytefse", "streamvbytefse",
           "vbytehuffzero", "streamvbytehuffzero", "entropy_only",
           "entropy"]) == ref_models.available()
    codec = models.get("ANSfold-3", device="cpu")
    assert codec.fidelity == 3 and codec.name == "ANSfold-3"
    assert models.get("ANSfold-3", lanes=64, device="cpu").lanes == 64
    with pytest.raises(TypeError):
        models.get("ANSfold-2")  # the device is never implicit


@pytest.mark.parametrize("name,h", [("ANS", 1), ("ANSsint-80", 80)])
def test_registry_int_methods(name, h):
    """ANS and ANSsint-h are AnsInt with ans_tpu's H_approx knob."""
    codec = models.get(name, lanes=128, device="cpu")
    assert isinstance(codec, AnsInt) and codec.name == name
    assert (codec.h_approx, codec.lanes) == (h, 128)
    ref = RefAnsInt(lanes=128) if h == 1 else RefAnsSint(h, lanes=128)
    assert (codec.name, codec.h_approx) == (ref.name, ref.h_approx)


@pytest.mark.parametrize("name,ref", [
    ("ANSmsb", lambda: RefAnsMsb()), ("ANSsmsb-5", lambda: RefAnsSmsb(5)),
    ("ANSsmsb-320", lambda: RefAnsSmsb(320)),
    ("ANSrfold-2", lambda: RefAnsReorderFold(2)),
    ("ANSrfold-8", lambda: RefAnsReorderFold(8))])
def test_registry_msb_and_rfold_methods(name, ref):
    """ANSmsb, ANSsmsb-h and ANSrfold-f (they stood in
    test_unported_names_raise until ported): name, h_approx and fidelity
    equal to ans_tpu's codec of the name."""
    codec = models.get(name, lanes=64, device="cpu")
    want = ref()
    assert (codec.name, codec.h_approx, codec.lanes) == (
        want.name, want.h_approx, 64)
    assert getattr(codec, "fidelity", None) == getattr(want, "fidelity",
                                                       None)


@pytest.mark.parametrize("name", ["vbytefse", "streamvbytehuffzero", "shuff",
                                  "optpfor", "no-such-method"])
def test_unported_names_raise(name):
    """A name outside ans_tpu's registry raises KeyError listing the known
    ones, as ans_tpu's does; the host codecs that stood here until they
    were ported (after vbyte, streamvbyteANS, the msb and rfold methods
    and pseudo_adaptive) now build, and the prepared lane API refuses them
    as not lane-format."""
    if name in ref_models.available():
        assert models.get(name, device="cpu").name == ref_models.get(
            name).name
        with pytest.raises(KeyError, match="not a lane-format"):
            models.prepare_decoder(name, b"", 1, device="cpu")
        return
    with pytest.raises(KeyError, match="unknown method 'no-such-method'; "
                                       "known: .*'vbytefse'"):
        models.get(name, device="cpu")
    with pytest.raises(KeyError, match="unknown method"):
        models.prepare_decoder(name, b"", 1, device="cpu")


def test_deepest_search_alphabet():
    """ANSfold-8 with ~7.5k live symbols: the largest alphabets the pivot
    search takes (depth 13), byte-identical and cross-decoded."""
    x = np.random.default_rng(2).integers(0, 8150, size=20000).astype(
        np.uint32)
    port, ref = AnsFold(8, device="cpu"), RefAnsFold(8)
    blob = port.encode(x)
    assert blob == ref.encode(x)
    table, _ = port._dec_table(blob)
    assert table.depth == 13
    np.testing.assert_array_equal(port.decode(blob, len(x)), x)
    np.testing.assert_array_equal(ref.decode(blob, len(x)), x)


def _grouped_input():
    """ANSfold-8 over ~14k distinct values below its fold threshold: more
    than 2^13 live symbols select the grouped slot layout."""
    return np.random.default_rng(1).integers(0, 1 << 15, size=20000).astype(
        np.uint32)


def test_grouped_encode_raises():
    """(Named for what the grouped layout did before K5/K6 were ported.)
    The grouped frame now encodes, one-shot and prepared, to ans_tpu's
    bytes."""
    x = _grouped_input()
    blob = AnsFold(8, device="cpu").encode(x)
    assert blob == RefAnsFold(8).encode(x)
    pe = models.prepare_encoder("ANSfold-8", x, lanes=32, device="cpu")
    assert pe.prelude + pe.to_bytes(*pe()) == blob


def test_grouped_decode_raises():
    """(Named for what the grouped layout did before K5/K6 were ported.)
    ans_tpu's grouped blob now decodes, on the grouped engine."""
    x = _grouped_input()
    blob = RefAnsFold(8).encode(x)
    codec = AnsFold(8, device="cpu")
    assert isinstance(codec._dec_table(blob)[0], tables.GroupedTable)
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


def test_search_engine_limit():
    """sigma = 2^13 is the pivot search's; one more symbol is grouped."""
    for sigma, kind in ((1 << 13, tables.SearchTable),
                        ((1 << 13) + 1, tables.GroupedTable)):
        nf = np.ones(sigma, np.uint64)
        nf[0] += (1 << 14) - sigma
        t = tables.build_dec_table(nf)
        assert isinstance(t, kind)
    assert t.layout.sigma == (1 << 13) + 1


def _twice16k():
    """Each of 0..2^14-1 twice: ANS takes the tail escape (K = 1024)."""
    return np.random.default_rng(6).permutation(
        np.repeat(np.arange(1 << 14), 2)).astype(np.uint32)


def _dense():
    """0..11999 (evens twice) + Zipf(1.5) draws: the escape declines."""
    head = np.concatenate([np.arange(12000), np.arange(0, 12000, 2)])
    tail = ref_zipf(np.random.default_rng(5), 12000, 12000, 1.5) - 1
    return np.concatenate([head, tail]).astype(np.uint32)


def _fold5_wide():
    """Every fold-5 symbol of all three exception widths: ~12k live."""
    rng = np.random.default_rng(2)
    parts = [np.arange(4096), np.arange(4096, 1 << 20, 256),
             np.arange(1 << 20, 1 << 28, 1 << 16)]
    x = np.concatenate([p + rng.integers(0, 256, size=len(p))
                        for p in parts])
    return rng.permutation(np.concatenate([x, x])).astype(np.uint32)


INT_INPUTS = {"escape": _twice16k, "grouped": _dense,
              "small": lambda: (np.random.default_rng(4).zipf(1.3, 20000)
                                % 3000).astype(np.uint32)}


@pytest.mark.parametrize("name", ["ANS", "ANSsint-80"])
@pytest.mark.parametrize("kind", sorted(INT_INPUTS))
def test_int_methods_blob_identical_and_cross_decode(name, kind):
    x = INT_INPUTS[kind]()
    h = 1 if name == "ANS" else 80
    ref = RefAnsInt() if h == 1 else RefAnsSint(h)
    port = models.get(name, device="cpu")
    blob = port.encode(x)
    assert blob == ref.encode(x)
    np.testing.assert_array_equal(port.decode(blob, len(x)), x)
    np.testing.assert_array_equal(ref.decode(blob, len(x)), x)
    nfreqs, _ = load_prelude(blob)
    plan = ref_escape.plan_from_freqs(nfreqs)
    table, _ = port._dec_table(blob)
    if (name, kind) == ("ANS", "escape"):
        assert plan is not None and isinstance(table, tables.SearchTable)
    if (name, kind) == ("ANS", "grouped"):
        assert plan is None and isinstance(table, tables.GroupedTable)
    if kind == "small":
        assert plan is None and isinstance(table, tables.SearchTable)


FOLD_INPUTS = {5: _fold5_wide, 7: lambda: ref_zipf(
    np.random.default_rng(3), 40000, 1 << 20), 8: _grouped_input}


@pytest.mark.parametrize("fidelity", sorted(FOLD_INPUTS))
def test_wide_fold_blob_identical_and_cross_decode(fidelity):
    """ANSfold-5/7/8 on inputs whose mapped alphabet is grouped."""
    x = FOLD_INPUTS[fidelity]()
    port, ref = AnsFold(fidelity, lanes=128, device="cpu"), RefAnsFold(
        fidelity, lanes=128)
    blob = port.encode(x)
    assert blob == ref.encode(x)
    assert isinstance(port._dec_table(blob)[0], tables.GroupedTable)
    np.testing.assert_array_equal(port.decode(blob, len(x)), x)
    np.testing.assert_array_equal(ref.decode(blob, len(x)), x)


@pytest.mark.parametrize("name,make", [
    ("ANS", _twice16k), ("ANS", _dense), ("ANSsint-80", _dense),
    ("ANSfold-8", _grouped_input)])
def test_prepared_api_and_engine(monkeypatch, name, make):
    """The prepared encoder reproduces encode(), and the prepared decoder
    takes the engine of the port's own rule; the engine ans_tpu's choice
    gives the same table (grouped or search: the layout decides both) is
    always eligible and decodes alike when forced."""
    x = make()
    blob = models.get(name, lanes=128, device="cpu").encode(x)
    pe = models.prepare_encoder(name, x, lanes=128, device="cpu")
    assert pe.prelude + pe.to_bytes(*pe()) == blob
    pd = models.prepare_decoder(name, blob, len(x), device="cpu")
    np.testing.assert_array_equal(pd.to_host(pd()), x)
    monkeypatch.setenv("ANS_TPU_INTERPRET", "1")  # the Pallas engines' gate
    from ans_tpu import models as ref_models
    dt, _ = ref_models.get(name)._dec_table(blob)
    want = ref_engine.choose_decode_engine(dt, 128)
    assert want in ("grouped", "search")
    table, _ = models.get(name, device="cpu")._dec_table(blob)
    assert engine.eligible_engines(table)[0] == want
    assert pd.engine == engine.choose_decode_engine(table, 128)
    forced = models.prepare_decoder(name, blob, len(x), device="cpu",
                                    engine=want)
    assert forced.engine == want
    np.testing.assert_array_equal(forced.to_host(forced()), x)


def test_cpu_path_launches_no_kernel(datasets):
    """CPU tensors take the plain versions: no counter moves."""
    x = datasets["zipf12"]
    counts = (encode.launches, encode.grouped_launches, place.launches,
              decode.launches, decode.grouped_launches)
    for name, values in (("ANSfold-2", x), ("ANSfold-8", _grouped_input())):
        codec = models.get(name, device="cpu")
        codec.decode(codec.encode(values), len(values))
        pe = models.prepare_encoder(name, values, lanes=32, device="cpu")
        pe()
    assert (encode.launches, encode.grouped_launches, place.launches,
            decode.launches, decode.grouped_launches) == counts \
        == (0, 0, 0, 0, 0)


def test_rejects_bad_input():
    codec = models.get("ANSfold-2", device="cpu")
    with pytest.raises(ValueError):
        codec.encode(np.zeros(0, np.uint32))
    with pytest.raises(ValueError):
        AnsFold(9, device="cpu")
    with pytest.raises(ValueError):
        AnsFold(2, lanes=48, device="cpu")
    blob = bytearray(codec.encode(np.arange(1000, dtype=np.uint32)))
    with pytest.raises(ValueError):
        codec.decode(bytes(blob[:-10]), 1000)  # truncated stream
