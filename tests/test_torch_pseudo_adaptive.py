"""The pseudo-adaptive container (ATFP) of ans_tpu_torch on the CPU:
PseudoAdaptive writes ans_tpu's container byte for byte (kinds int and
msb; the lane engine, its blocks batches of streams with a model each,
and the compat engine on the host; block sizes 128, 4096 and 2^16), each
side decodes the other's, any instance decodes any container; blocks that
reach every route of the lane engine (the tail escape onto the grouped
layout, K6/K5; onto value order, K1/K3; msb, K1/K4), single-symbol blocks,
a ragged last block and a last block of another lane count; and each
batched plain version of K1, K3, K4, K5 and K6 over streams with a model
each equals its one-stream calls, in batches that mix frames of different
log2m."""

import functools
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from ans_tpu.models.pseudo_adaptive import PseudoAdaptive as RefPseudo
from ans_tpu.utils.zipf import zipf as ref_zipf
from ans_tpu_torch import models
from ans_tpu_torch.inputs import dense_input
from ans_tpu_torch.models import ans as lane, engine
from ans_tpu_torch.models.pseudo_adaptive import (MAGIC, PseudoAdaptive,
                                                  _encode_batches)
from ans_tpu_torch.ops import (decode, encode, lane_codec, model_batch,
                               place, tables)

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"


@functools.lru_cache(maxsize=None)
def _input(name: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if name == "drifting":  # tests/test_pseudo_adaptive.py's
        return np.concatenate([rng.integers(i * 1000, i * 1000 + 50,
                                            size=4000)
                               for i in range(8)]).astype(np.uint32)
    if name == "grouped":  # > 2^13 ranks: the escape onto the grouped layout
        return ref_zipf(np.random.default_rng(0), 1 << 16, 1 << 20)
    if name == "value":  # the escape onto value order, M = 2^17: K3
        return ref_zipf(np.random.default_rng(42), 1 << 17, 1 << 28,
                        1.25) - 1
    if name == "singles":  # single-symbol blocks, a ragged last block
        v = np.repeat(np.arange(5, dtype=np.uint32) * 7, 4096)
        tail = rng.integers(0, 300, size=4096 + 1000).astype(np.uint32)
        return np.concatenate([v[:4096 * 3], tail, v[:4096]])
    if name == "wide_last":  # S = 64 blocks, then a 32-lane last one
        return rng.integers(0, 700, size=409601 + 3000).astype(np.uint32)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _ref_blob(name, bs, kind, lanes, eng):
    return RefPseudo(bs, kind, lanes, eng).encode(_input(name))


CASES = [
    # input, block size, kind, lanes, engine
    ("drifting", 128, "int", 32, "auto"),
    ("drifting", 128, "msb", 32, "auto"),
    ("drifting", 4096, "int", 32, "auto"),
    ("drifting", 4096, "int", 32, "lane"),
    ("drifting", 4096, "msb", 32, "lane"),
    ("drifting", 1 << 16, "int", 32, "auto"),
    ("drifting", 1 << 16, "msb", 32, "auto"),
    ("drifting", 1 << 16, "msb", 32, "compat"),
    ("grouped", 1 << 16, "int", 32, "auto"),
    ("value", 1 << 17, "int", None, "auto"),
    ("singles", 4096, "int", 32, "lane"),
    ("singles", 4096, "msb", None, "lane"),
    ("wide_last", 409601, "msb", None, "auto"),
]


@pytest.mark.parametrize("name,bs,kind,lanes,eng", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_container_equals_ans_tpu(name, bs, kind, lanes, eng):
    """The container equals ans_tpu's; each side decodes the other's, and a
    default instance decodes it (kind and engine come from the header);
    on the small inputs' lane containers the prepared encoder and decoder
    write and read the same."""
    x = _input(name)
    want = _ref_blob(name, bs, kind, lanes, eng)
    codec = PseudoAdaptive(bs, kind, lanes, eng, device="cpu")
    blob = codec.encode(x)
    assert blob == want
    np.testing.assert_array_equal(codec.decode(want, len(x)), x)
    np.testing.assert_array_equal(PseudoAdaptive(device="cpu").decode(want),
                                  x)
    np.testing.assert_array_equal(RefPseudo().decode(blob, len(x)), x)
    if blob[6] == 1 and name in ("drifting", "singles"):  # lane engine
        pe = codec.prepare_encoder(x)
        assert pe.to_bytes(pe()) == blob
        pd = codec.prepare_decoder(blob)
        np.testing.assert_array_equal(pd.to_host(pd()), x)


def _routes(name, bs, kind, lanes):
    """The decode engines and scan tables of a lane container's batches."""
    codec = PseudoAdaptive(bs, kind, lanes, "lane", device="cpu")
    x = _input(name)
    _, blocks = codec._stage(x)
    scans = {type(b.table).__name__ for b in blocks}
    pd = codec.prepare_decoder(_ref_blob(name, bs, kind, lanes, "auto"))
    return scans, set(pd.engines), pd, blocks


@pytest.mark.parametrize("name,bs,kind,lanes,scan,dec", [
    ("grouped", 1 << 16, "int", 32, "GroupedEncDevice", "grouped"),
    ("value", 1 << 17, "int", None, "EncDevice", "search"),
    ("drifting", 1 << 16, "msb", 32, "EncDevice", "direct"),
])
def test_blocks_reach_their_routes(name, bs, kind, lanes, scan, dec):
    """The cases reach what they are named for: > 2^13 ranks take the
    tail escape onto the grouped layout (K6, K5), zipf(1.25) ranks of a
    2^17 block the escape onto value order past K4's tables (K1, K3), msb
    the value order and K4."""
    scans, engines, _, _ = _routes(name, bs, kind, lanes)
    assert scans == {scan} and engines == {dec}


def test_lane_counts_of_the_last_block():
    """lanes=None: 409601-value blocks take 64 lanes, the 3000-value last
    block 32; they are two scan batches and two decode batches."""
    codec = PseudoAdaptive(409601, "msb", device="cpu")
    _, blocks = codec._stage(_input("wide_last"))
    assert [b.S for b in blocks] == [64, 32]
    assert len(_encode_batches(blocks, "cpu")) == 2
    pd = codec.prepare_decoder(_ref_blob("wide_last", 409601, "msb", None,
                                         "auto"))
    assert sorted(b["decoder"].S for b in pd.batches) == [32, 64]


def test_batches_mix_frames_of_different_log2m():
    """The scan batch and the decode batch of drifting's seven full
    4096-value msb blocks hold frames of different log2m and decode
    exactly; the ragged last block (fewer steps) is a decode batch of its
    own."""
    codec = PseudoAdaptive(4096, "msb", 32, "lane", device="cpu")
    _, blocks = codec._stage(_input("drifting"))
    (batch,) = _encode_batches(blocks, "cpu")
    assert len(set(batch.table.column("log2m").tolist())) > 1
    blob = _ref_blob("drifting", 4096, "msb", 32, "lane")
    pd = codec.prepare_decoder(blob)
    assert sorted(len(b["decoder"].n_sec) for b in pd.batches) == [1, 7]
    full = max(pd.batches, key=lambda b: len(b["decoder"].n_sec))
    assert len(set(full["decoder"].table.column("log2m").tolist())) > 1
    np.testing.assert_array_equal(pd.to_host(pd()), _input("drifting"))


def test_single_symbol_blocks_are_a_fill():
    """Single-symbol blocks store sigma = 1 and the symbol (ans_tpu's
    shortcut) and decode by a fill, full and ragged."""
    v = np.repeat(np.arange(16, dtype=np.uint32), 128)
    v = np.concatenate([v, np.full(50, 9, np.uint32)])
    for eng in ("compat", "lane"):
        codec = PseudoAdaptive(128, "int", 32, eng, device="cpu")
        blob = codec.encode(v)
        assert blob == RefPseudo(128, "int", 32, eng).encode(v)
        assert len(blob) < 16 + 17 * 8
        np.testing.assert_array_equal(codec.decode(blob), v)


def test_version_1_container():
    """A ver 1 header has no engine byte: the auto rule over the stored
    block size gives it, as ans_tpu reads it."""
    x = _input("drifting")
    for bs in (4096, 1 << 16):
        blob = bytearray(_ref_blob("drifting", bs, "int", 32, "auto"))
        blob[4], blob[6] = 1, 0
        np.testing.assert_array_equal(
            PseudoAdaptive(device="cpu").decode(bytes(blob)), x)
        np.testing.assert_array_equal(RefPseudo().decode(bytes(blob)), x)


def test_header_and_errors():
    x = _input("drifting")[:5000]
    blob = PseudoAdaptive(1024, "msb", device="cpu").encode(x)
    assert struct.unpack_from("<IBBBBII", blob) == (MAGIC, 2, 1, 0, 0, 5000,
                                                    1024)
    with pytest.raises(ValueError, match="not an ATFP"):
        PseudoAdaptive(device="cpu").decode(b"\0" * 16)
    with pytest.raises(ValueError):
        PseudoAdaptive(device="cpu").encode(np.zeros(0, np.uint32))
    with pytest.raises(ValueError, match="kind"):
        PseudoAdaptive(kind="fold", device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        PseudoAdaptive(lanes=48, device="cpu")
    with pytest.raises(ValueError, match="host"):
        PseudoAdaptive(1024, device="cpu").prepare_decoder(blob)
    with pytest.raises(ValueError, match="host"):
        PseudoAdaptive(1024, device="cpu").prepare_encoder(x)


def test_registry_builds_the_default_instance():
    """models.get("pseudo_adaptive") is ans_tpu's default instance; its
    name is no longer among the unported ones."""
    codec = models.get("pseudo_adaptive", device="cpu")
    ref = RefPseudo()
    assert isinstance(codec, PseudoAdaptive)
    assert (codec.block_size, codec.kind, codec.lanes, codec.engine,
            codec.name) == (ref.block_size, ref.kind, ref.lanes, ref.engine,
                            ref.name)
    assert "pseudo_adaptive" in models.available()
    with pytest.raises(KeyError, match="not a lane-format"):
        models.prepare_decoder("pseudo_adaptive", b"", 1, device="cpu")


def test_golden_containers():
    """The committed containers written by ans_tpu (make_fixtures.py,
    pseudo.json) re-encode to the same bytes and decode exactly."""
    recs = json.loads((LANE_FIXTURES / "pseudo.json").read_text())
    assert {r["engine"] for r in recs} >= {"auto", "lane"}
    for rec in recs:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        codec = PseudoAdaptive(rec["block_size"], rec["kind"], rec["lanes"],
                               rec["engine"], device="cpu")
        assert codec.encode(x) == blob
        np.testing.assert_array_equal(codec.decode(blob), x)


# --------------------------------------------------------------------------
# the batched plain versions over streams with a model each: a batch is its
# streams one after the other, each under its own table
# --------------------------------------------------------------------------

def _ranks(v):
    return np.searchsorted(np.unique(v), v).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _streams(route: str):
    """Streams of one scan table kind and their models, of unequal length
    and frames of different log2m: a list of (n, host decode table, scan
    table, syms, nb, excw)."""
    z125 = ref_zipf(np.random.default_rng(42), 1 << 16, 1 << 28, 1.25) - 1
    if route == "value":
        inputs = [(lane.AnsInt, _ranks(z125[:1 << 13])),  # log2m 13
                  (lane.AnsInt, _ranks(z125)),            # escape, 16
                  (lane.AnsMsb, z125[:5000])]             # msb, 12
    else:
        inputs = [(lane.AnsInt, _ranks(_input("grouped"))),  # escape, 16
                  (lane.AnsInt, np.random.default_rng(1).integers(
                      0, 9000, size=1 << 15).astype(np.uint32)),  # raw, 15
                  (lane.AnsInt, dense_input(1 << 14))]     # raw, 14
    out = []
    for cls, v in inputs:
        codec = cls(lanes=32, device="cpu")
        mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(v)
        table, rank_of = lane.scan_table(ffreqs, raw, "cpu")
        out.append((len(v), codec._table(pfreqs), table,
                    lane.to_ranks(mapped, rank_of), k, low))
    return out


def _stage(streams, S=32):
    T = max(lane_codec.lane_steps(s[0], S) for s in streams)
    staged = []
    for i in (3, 4, 5):
        t = torch.zeros((len(streams), T * S), dtype=torch.int32)
        for d, s in enumerate(streams):
            t[d, :s[0]] = s[i]
        staged.append(t.reshape(len(streams), T, S))
    n = torch.tensor([s[0] for s in streams], dtype=torch.int64)
    return staged, n, T


@pytest.mark.parametrize("route", ["value", "grouped"])
def test_batched_scan_is_its_streams(route):
    """K1's (value order) and K6's (grouped) batched plain versions over a
    ModelBatch equal the one-stream plain version under each stream's own
    table; the batch mixes frames of different log2m (K6's also streams
    fed ranks and symbol ids)."""
    streams = _streams(route)
    (m, nb, ex), n, T = _stage(streams)
    batch = model_batch.stack([s[2] for s in streams])
    assert len(set(batch.column("log2m").tolist())) == len(streams)
    one = (lane_codec.encode_scan_grouped_plain if route == "grouped"
           else lane_codec.encode_scan_plain)
    scan = (encode.encode_scan_grouped_batch if route == "grouped"
            else encode.encode_scan_batch)
    packed, states = scan(m, n, batch)
    for d, s in enumerate(streams):
        p1, s1 = one(m[d], s[0], s[2])
        assert torch.equal(packed[d], p1) and torch.equal(states[d], s1)
    if route == "grouped":
        assert set(batch.column("rank_of_off").tolist()) & {-1}
        assert batch.column("rank_of_len").max() > 0


@pytest.mark.parametrize("route,engine_name", [
    ("value", "search"), ("value", "direct"), ("grouped", "grouped"),
    ("grouped", "direct")])
def test_batched_decode_is_its_streams(route, engine_name):
    """K3's, K4's and K5's batched plain versions over a ModelBatch (the
    streams' frames of different log2m, exception rounds and, for K5,
    per-rank tables or none) equal the one-stream plain versions, and
    decode each stream to its input."""
    # K4 takes the frames whose per-slot tables fit (the grouped route's
    # two slot-ordered ones)
    streams = [s for s in _streams(route)
               if engine_name != "direct" or tables.direct_fits(s[1])]
    assert len(streams) >= 2
    (m, nb, ex), n, T = _stage(streams)
    batch = model_batch.stack([s[2] for s in streams])
    scan = (encode.encode_scan_grouped_batch if route == "grouped"
            else encode.encode_scan_batch)
    packed, states = scan(m, n, batch)
    stream, offsets, _ = place.place_batch(packed, nb, ex, n)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, T]])
    devs = [engine.dec_device_table(s[1], engine_name, "cpu")
            for s in streams]
    dec = model_batch.stack(devs)
    assert len(set(dec.column("log2m").tolist())) == len(streams)
    kernel, one = {
        "search": (decode.decode_search_batch, lane_codec.decode_search_plain),
        "direct": (decode.decode_direct_batch, lane_codec.decode_direct_plain),
        "grouped": (decode.decode_grouped_batch,
                    lane_codec.decode_grouped_plain)}[engine_name]
    out = kernel(stream, stream_off, states, n, dec, T)
    for d, s in enumerate(streams):
        part = stream[int(stream_off[d]):int(stream_off[d + 1])]
        assert torch.equal(out[d], one(part, states[d], devs[d], s[0], T))
        want = engine.PreparedDecoder(
            part.numpy(), states[d].numpy().view(np.uint32), s[1], s[0],
            S=32, T=lane_codec.lane_steps(s[0], 32), sec_len=[part.numel()],
            device="cpu", engine=engine_name)
        np.testing.assert_array_equal(
            out[d].reshape(-1)[:s[0]].numpy(),
            want().reshape(-1)[:s[0]].numpy())


def test_model_batch_layout():
    """A stacked batch lays each distinct table out once, one row a
    stream; the shared batch of one table is one row with every offset 0,
    read with stride 0; a batch refuses a launch of another size."""
    streams = _streams("value")
    a, b = streams[0][2], streams[1][2]
    batch = model_batch.stack([a, b, a])
    assert batch.tensors["words"].shape[0] == (a.words.shape[0]
                                               + b.words.shape[0])
    assert batch.column("words_off").tolist() == [0, a.words.shape[0], 0]
    assert batch.stride == 4 and not batch.shared
    for d, t in enumerate((a, b, a)):
        assert torch.equal(batch.table(d).words, t.words)
        assert batch.table(d).log2m == t.log2m
    one = model_batch.of(a)
    assert one is model_batch.shared(a) and one.shared and one.stride == 0
    assert one.rows.tolist() == [[0, a.words.shape[0], a.frame_size,
                                  a.log2m]]
    with pytest.raises(ValueError, match="models for a batch"):
        batch.check("encode_scan", 2)
    grouped = model_batch.stack([s[2] for s in _streams("grouped")])
    assert grouped.column("rank_of_off").tolist()[1:] == [-1, -1]
    assert grouped.table(1).rank_of is None
