"""The byte path of the port against ans_tpu: vbyte, streamvbyte, AnsByte,
vbyteANS and streamvbyteANS write ans_tpu's bytes, each side decodes the
other's blobs, and every decode engine a frame admits gives the same
values.  All comparisons are exact."""

import numpy as np
import pytest

from ans_tpu import models as ref_models
from ans_tpu.models import config as ref_config
from ans_tpu.models.bytes import AnsByte as RefAnsByte
from ans_tpu_torch import models
from ans_tpu_torch.models import engine, framing
from ans_tpu_torch.models.bytes import (AnsByte, StreamVbyte, StreamVbyteAns,
                                        Vbyte, VbyteAns)
from ans_tpu_torch.ops import bytesplit, decode, encode, place
from ans_tpu_torch.reference_model.byte_model import byte_prelude_decode

BYTE_METHODS = ["vbyte", "streamvbyte", "vbyteANS", "streamvbyteANS"]
DATASETS = ["zipf12", "zipf_large", "geometric", "uniform_small", "wide",
            "tiny", "single_sym"]


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    m = rng.random(n)
    return np.where(m < .5, x & 0x7F,
                    np.where(m < .8, x & 0xFFFF, x)).astype(np.uint32)


def _check(name, x):
    port, ref = models.get(name, device="cpu"), ref_models.get(name)
    blob = port.encode(x)
    assert blob == ref.encode(x)
    np.testing.assert_array_equal(port.decode(blob, len(x)), x)
    np.testing.assert_array_equal(np.asarray(ref.decode(blob, len(x))), x)
    return blob


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("name", BYTE_METHODS)
def test_blob_identical_and_cross_decode(datasets, name, dataset):
    _check(name, datasets[dataset])


@pytest.mark.parametrize("n", [1, 2, 5, 4097])
@pytest.mark.parametrize("name", BYTE_METHODS)
def test_blob_identical_on_mixed_lengths(name, n):
    """Every byte length, n not a multiple of 4, n = 1."""
    _check(name, _mixed(n, n))


@pytest.mark.parametrize("name", BYTE_METHODS)
def test_extreme_values(name):
    x = np.array([0, 127, 128, (1 << 28) - 1, 1 << 28, (1 << 31) - 1,
                  1 << 31, (1 << 32) - 1, 255, 256, 65535, 65536,
                  (1 << 24) - 1, 1 << 24] * 3, dtype=np.uint32)
    _check(name, x)


def test_composite_wire_layout(datasets):
    """u32 count of split bytes, then the AnsByte blob: byte prelude, then
    the fmt-2 stream at the default lane count of the split stream."""
    x = datasets["zipf_large"]
    split = models.get("vbyte", device="cpu").encode(x)
    blob = models.get("vbyteANS", device="cpu").encode(x)
    assert int.from_bytes(blob[:4], "little") == len(split)
    assert blob[4:] == AnsByte(device="cpu").encode(split)
    nfreqs, off = byte_prelude_decode(blob[4:])
    assert len(nfreqs) == 256 and int(nfreqs.sum()) <= 4096
    S = framing.parse(blob[4:], off)[0]
    assert S == ref_config.default_lane_count(len(split))


def test_default_lanes_follow_the_split_stream():
    """210000 two-byte values: 32 lanes by the element count, 64 by the
    420000 split bytes; the wire says 64, as ans_tpu's does."""
    x = np.random.default_rng(3).integers(128, 1 << 14, size=210000).astype(
        np.uint32)
    assert ref_config.default_lane_count(len(x)) == 32
    blob = models.get("vbyteANS", device="cpu").encode(x)
    assert blob == ref_models.get("vbyteANS").encode(x)
    _, off = byte_prelude_decode(blob[4:])
    assert framing.parse(blob[4:], off)[0] == 64


def _byte_strings():
    rng = np.random.default_rng(11)
    return {
        "text": bytes((rng.zipf(1.4, size=30000) % 97 + 32).astype(np.uint8)),
        "all256": bytes(rng.permutation(np.arange(256).repeat(40)).astype(
            np.uint8)),
        "one_distinct": b"\x07" * 5000,
        "one_byte": b"\xff",
        "two": bytes(rng.integers(0, 2, size=3001).astype(np.uint8) * 200),
    }


@pytest.mark.parametrize("kind", sorted(_byte_strings()))
@pytest.mark.parametrize("lanes", [None, 32, 256])
def test_ansbyte_blob_identical_and_cross_decode(kind, lanes):
    data = _byte_strings()[kind]
    port, ref = AnsByte(lanes, device="cpu"), RefAnsByte(lanes)
    blob = port.encode(data)
    assert blob == ref.encode(data)
    assert port.decode(blob, len(data)) == data
    assert ref.decode(blob, len(data)) == data
    for eng in ("search", "direct"):
        pd = port.prepare_decoder(blob, len(data), eng)
        assert pd.engine == eng
        assert pd.to_host(pd()).astype(np.uint8).tobytes() == data


def test_empty_input_raises_everywhere():
    empty = np.zeros(0, np.uint32)
    for codec in (Vbyte(device="cpu"), StreamVbyte(device="cpu"),
                  VbyteAns(device="cpu"), StreamVbyteAns(device="cpu")):
        with pytest.raises(ValueError, match="empty"):
            codec.encode(empty)
    with pytest.raises(ValueError, match="empty"):
        AnsByte(device="cpu").encode(b"")
    with pytest.raises(ValueError, match="power of two"):
        AnsByte(48, device="cpu")


def test_registry_names_and_devices():
    assert set(BYTE_METHODS) <= set(models.available())
    for name, cls in (("vbyte", Vbyte), ("streamvbyte", StreamVbyte)):
        codec = models.get(name, device="cpu")
        assert type(codec) is cls and codec.name == name
        assert codec.name == ref_models.get(name).name
    for name in ("vbyteANS", "streamvbyteANS"):
        codec = models.get(name, lanes=64, device="cpu")
        assert codec.name == name == ref_models.get(name).name
        assert codec.entropy.lanes == 64
        assert str(codec.device) == "cpu"
    with pytest.raises(TypeError):
        models.get("vbyteANS")  # the device is never implicit
    # AnsByte has no registry name, as in ans_tpu
    for reg in (models, ref_models):
        with pytest.raises(KeyError):
            reg.get("ansbyte", **({"device": "cpu"} if reg is models else {}))


@pytest.mark.parametrize("name", ["fse", "huffzero", "huff0", "vbytefse",
                                  "streamvbytefse", "vbytehuffzero",
                                  "streamvbytehuffzero", "entropy",
                                  "entropy_only", "arith", "optpfor"])
def test_host_codecs_still_unported(name):
    """The host tANS / shuff composites, which waited here for the
    host-codec slice: ported, each writes ans_tpu's bytes of a small zipf
    input and decodes them (tests/test_torch_host_codecs.py holds them on
    the conftest datasets)."""
    assert name in ref_models.available()
    x = (np.random.default_rng(8).zipf(1.3, 3000) % 5000).astype(np.uint32)
    codec = models.get(name, device="cpu")
    blob = codec.encode(x)
    assert blob == ref_models.get(name).encode(x)
    if not name.startswith("entropy"):
        np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


@pytest.mark.parametrize("name", BYTE_METHODS)
def test_byte_methods_have_no_prepared_lane_api(name):
    """prepare_decoder / prepare_encoder are for the lane-format ANS
    methods, in the port as in ans_tpu."""
    with pytest.raises(KeyError, match="not a lane-format"):
        models.prepare_decoder(name, b"", 1, device="cpu")
    with pytest.raises(KeyError, match="not a lane-format"):
        models.prepare_encoder(name, np.ones(4, np.uint32), device="cpu")
    with pytest.raises(KeyError, match="not a lane-format"):
        ref_models.prepare_decoder(name, b"", 1)


def _grouped_small():
    """~9000 live values of frequency 1 or 2: ANS codes a grouped frame
    (the escape declines the mixed tail) small enough for K4's tables."""
    rng = np.random.default_rng(2)
    ids = rng.permutation(9000)
    return rng.permutation(np.concatenate([ids, ids[:7384]])).astype(
        np.uint32)


ENGINE_CASES = {
    "ANSfold-2": lambda: _mixed(20000, 1),
    "ANSfold-8": lambda: np.random.default_rng(1).integers(
        0, 1 << 15, size=20000).astype(np.uint32),
    "ANS": lambda: (np.random.default_rng(4).zipf(1.3, 20000) % 3000).astype(
        np.uint32),
    "ANSsint-80": _grouped_small,
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_every_eligible_engine_decodes_alike(name):
    """prepare_decoder(..., engine=...) under each engine the frame admits
    gives the input back; the default is the rule's choice; an engine the
    frame does not admit raises."""
    x = ENGINE_CASES[name]()
    blob = models.get(name, lanes=128, device="cpu").encode(x)
    assert blob == ref_models.get(name).__class__.encode(
        _ref_with_lanes(name, 128), x)
    table, _ = models.get(name, device="cpu")._dec_table(blob)
    eligible = engine.eligible_engines(table)
    for eng in engine.ENGINES:
        if eng not in eligible:
            with pytest.raises(ValueError, match="not eligible"):
                models.prepare_decoder(name, blob, len(x), device="cpu",
                                       engine=eng)
            continue
        pd = models.prepare_decoder(name, blob, len(x), device="cpu",
                                    engine=eng)
        assert pd.engine == eng
        np.testing.assert_array_equal(pd.to_host(pd()), x)
    pd = models.prepare_decoder(name, blob, len(x), device="cpu")
    assert pd.engine == engine.choose_decode_engine(table, 128)
    assert pd.engine in eligible


def _ref_with_lanes(name, lanes):
    codec = ref_models.get(name)
    codec.lanes = lanes
    return codec


def test_engine_cases_cover_every_engine():
    seen = set()
    for name, make in ENGINE_CASES.items():
        codec = models.get(name, lanes=128, device="cpu")
        table, _ = codec._dec_table(codec.encode(make()))
        seen.add(engine.eligible_engines(table))
    assert seen == {("search", "direct"), ("grouped",),
                    ("grouped", "direct")}


def test_cpu_byte_path_launches_no_kernel(datasets):
    x = datasets["zipf12"]
    counts = (encode.launches, place.launches, decode.launches,
              decode.direct_launches, bytesplit.encode_launches,
              bytesplit.svb_decode_launches, bytesplit.vbyte_decode_launches)
    for name in BYTE_METHODS:
        codec = models.get(name, device="cpu")
        codec.decode(codec.encode(x), len(x))
    assert counts == (
        encode.launches, place.launches, decode.launches,
        decode.direct_launches, bytesplit.encode_launches,
        bytesplit.svb_decode_launches, bytesplit.vbyte_decode_launches)
