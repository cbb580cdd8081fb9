"""The ported slice as a whole, on the CPU: ans_tpu_torch's ANSfold codecs
write the same bytes as ans_tpu's, each decodes the other's blobs, the
prepared API reproduces encode(), the committed golden fixtures
round-trip, and what is not ported refuses clearly."""

import json
from pathlib import Path

import numpy as np
import pytest

from ans_tpu.models.ans import AnsFold as RefAnsFold
from ans_tpu_torch import models
from ans_tpu_torch.models.ans import AnsFold
from ans_tpu_torch.ops import decode, encode, place, tables

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"
MANIFEST = json.loads((LANE_FIXTURES / "manifest.json").read_text())


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
    if rec["lanes"] is None:
        codec = models.get(rec["method"], device="cpu")
    else:
        codec = AnsFold(int(rec["method"].split("-")[1]), lanes=rec["lanes"],
                        device="cpu")
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
    assert codec.encode(x) == blob


def test_full_width_record():
    """The full-width record names one reference blob per numpy input
    stream, all of the main path's shape."""
    rec = json.loads((LANE_FIXTURES / "fullwidth.json").read_text())
    assert rec["n"] == 1 << 25 and rec["lanes"] == 4096
    assert rec["inputs"]
    for e in rec["inputs"]:
        assert (e["M"], e["t_sec"], e["sections"]) == (1 << 15, 512, 16)


def test_registry():
    assert models.available() == [f"ANSfold-{f}" for f in range(1, 9)]
    codec = models.get("ANSfold-3", device="cpu")
    assert codec.fidelity == 3 and codec.name == "ANSfold-3"
    with pytest.raises(TypeError):
        models.get("ANSfold-2")  # the device is never implicit


@pytest.mark.parametrize("name", ["ANS", "ANSmsb", "ANSrfold-2",
                                  "ANSsint-80", "ANSsmsb-5", "vbyte",
                                  "streamvbyteANS", "shuff",
                                  "pseudo_adaptive", "no-such-method"])
def test_unported_names_raise(name):
    with pytest.raises(KeyError, match="ROADMAP"):
        models.get(name, device="cpu")
    with pytest.raises(KeyError, match="ROADMAP"):
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
    with pytest.raises(NotImplementedError, match="K5/K6"):
        AnsFold(8, device="cpu").encode(_grouped_input())
    with pytest.raises(NotImplementedError):
        models.prepare_encoder("ANSfold-8", _grouped_input(), lanes=128,
                               device="cpu")


def test_grouped_decode_raises():
    x = _grouped_input()
    blob = RefAnsFold(8).encode(x)
    with pytest.raises(NotImplementedError, match="grouped"):
        AnsFold(8, device="cpu").decode(blob, len(x))


def test_search_engine_limit():
    """sigma = 2^13 is the pivot search's; one more symbol is grouped."""
    tables.require_ungrouped(np.ones(1 << 13, np.uint64))
    with pytest.raises(NotImplementedError, match="grouped"):
        tables.require_ungrouped(np.ones((1 << 13) + 1, np.uint64))


def test_cpu_path_launches_no_kernel(datasets):
    """CPU tensors take the plain versions: no counter moves."""
    x = datasets["zipf12"]
    counts = (encode.launches, place.launches, decode.launches)
    codec = models.get("ANSfold-2", device="cpu")
    codec.decode(codec.encode(x), len(x))
    pe = models.prepare_encoder("ANSfold-2", x, lanes=32, device="cpu")
    pe()
    assert (encode.launches, place.launches, decode.launches) == counts \
        == (0, 0, 0)


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
