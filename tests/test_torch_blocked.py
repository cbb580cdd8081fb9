"""The blocked container (ATFB) of ans_tpu_torch.parallel on the CPU:
BlockCodec writes ans_tpu's container byte for byte (its portable engine
at S = 32, its production engine in interpret mode at S = 128, as
tests/test_parallel.py runs it) for the kinds int (raw and tail escape),
msb, fold (value order and grouped) and rfold, at D = 1, 2 and 8 sections
with a ragged tail and empty sections, and decodes both engines'
containers; the copies of the section cut that depends on the engine
(choose_sections_joint, the production engine's predicate: in
test_torch_host.py) cut as ans_tpu's; each batched plain version equals
its one-stream calls."""

import functools
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from ans_tpu.models import framing as jframing
from ans_tpu.parallel import BlockCodec as RefBlockCodec, make_mesh
from ans_tpu.parallel import block_runtime as jblock
from ans_tpu.utils.zipf import zipf as ref_zipf
from ans_tpu_torch.models import ans as lane, framing
from ans_tpu_torch.ops import decode, encode, place, tables
from ans_tpu_torch.parallel import (KINDS, MAGIC, BlockCodec,
                                    describe_container)

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"


@functools.lru_cache(maxsize=None)
def _input(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    data = (rng.zipf(1.3, size=40000) - 1).clip(0, 1 << 27).astype(
        np.uint32)
    return {
        "data": data[:8 * 2499 + 3],               # ragged at D = 8
        "three": data[:3],                         # D = 8: five empty
        "small": (data[:20000] % 4096).astype(np.uint32),  # ANS raw
        "twice": np.random.default_rng(6).permutation(np.repeat(
            np.arange(1 << 14), 2)).astype(np.uint32),  # ANS escape
        "z20": ref_zipf(np.random.default_rng(3), 40000, 1 << 20),  # fold-7
        "mod5k": (data[:20000] % 5000).astype(np.uint32),  # rfold taken
        "few": np.random.default_rng(2).integers(0, 300, 9000).astype(
            np.uint32),                            # rfold not taken
    }[name]


@functools.lru_cache(maxsize=None)
def _ref_blob(method, name, D, S, engine):
    codec = RefBlockCodec(method, make_mesh(D), lanes=S, engine=engine,
                          interpret=True)
    return codec.encode(_input(name))


CASES = [
    # method, input, D, S, ans_tpu engine
    ("ANSfold-2", "data", 8, 32, "xla"),
    ("ANSfold-2", "three", 8, 32, "xla"),
    ("ANSfold-2", "data", 1, 32, "xla"),
    ("ANSmsb", "data", 8, 32, "xla"),
    ("ANSmsb", "data", 2, 32, "xla"),
    ("ANS", "small", 2, 32, "xla"),
    ("ANS", "twice", 2, 32, "xla"),
    ("ANSfold-7", "z20", 2, 32, "xla"),
    ("ANSrfold-2", "mod5k", 8, 32, "xla"),
    ("ANSrfold-2", "few", 1, 32, "xla"),
    ("ANSfold-2", "data", 2, 128, "pallas"),
    ("ANSmsb", "data", 8, 128, "pallas"),
]


@pytest.mark.parametrize("method,name,D,S,engine", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_container_equals_ans_tpu(method, name, D, S, engine):
    """The container equals ans_tpu's engine's, and each side decodes the
    other's; the prepared encoder writes the same container."""
    x = _input(name)
    want = _ref_blob(method, name, D, S, engine)
    codec = BlockCodec(method, D, S, device="cpu")
    blob = codec.encode(x)
    assert blob == want
    np.testing.assert_array_equal(codec.decode(want, len(x)), x)
    np.testing.assert_array_equal(codec.decode(want), x)
    pe = codec.prepare_encoder(x)
    assert pe.to_bytes(*pe()) == blob
    assert describe_container(blob) == (method, len(x), D)


def test_layouts_of_the_cases():
    """The cases reach what they are named for: ANS on `twice` takes the
    tail escape, fold-7 on z20 the grouped layout, rfold on mod5k the
    reorder and on `few` not."""
    from ans_tpu_torch.ops import escape
    from ans_tpu_torch.reference_model.model import load_prelude

    def prelude(blob, skip=0):
        (plen,) = struct.unpack_from("<I", blob, 16 + skip)
        return load_prelude(blob[20 + skip:20 + skip + plen + 8])[0]

    nf = prelude(_ref_blob("ANS", "twice", 2, 32, "xla"))
    assert escape.plan_from_freqs(nf) is not None
    nf = prelude(_ref_blob("ANSfold-7", "z20", 2, 32, "xla"))
    assert isinstance(lane.AnsFold(7, device="cpu")._table(nf),
                      tables.GroupedTable)
    for name, taken in (("mod5k", True), ("few", False)):
        blob = _ref_blob("ANSrfold-2", name, 8 if taken else 1, 32, "xla")
        assert struct.unpack_from("<I", blob, 16)[0] == int(taken)


def test_header_and_constants():
    """MAGIC, KINDS and the header of ans_tpu's writer (version 2, kind,
    fidelity, h_approx, n, D); describe_container inverts the method."""
    assert MAGIC == jblock.MAGIC and KINDS == jblock.KINDS
    x = _input("data")[:1000] % 1000  # a small alphabet for ANS
    for method in ("ANS", "ANSsint-5", "ANSmsb", "ANSsmsb-80", "ANSfold-3",
                   "ANSrfold-2"):
        blob = BlockCodec(method, 2, 32, device="cpu").encode(x)
        assert describe_container(blob) == jblock.describe_container(blob) \
            == (method, 1000, 2)
        magic, ver, kind, fid, h, n, D = struct.unpack_from("<IBBBBII",
                                                            blob)
        assert (magic, ver, n, D) == (MAGIC, 2, 1000, 2)
    with pytest.raises(ValueError, match="not an ATFB"):
        describe_container(b"\0" * 16)


def test_decode_refuses_wrong_n_and_method():
    x = _input("data")
    codec = BlockCodec("ANSfold-2", 8, 32, device="cpu")
    blob = _ref_blob("ANSfold-2", "data", 8, 32, "xla")
    with pytest.raises(ValueError, match="not prefix-decodable"):
        codec.decode(blob, len(x) - 1)
    with pytest.raises(ValueError, match="does not match"):
        BlockCodec("ANSfold-3", 8, device="cpu").decode(blob)
    with pytest.raises(ValueError, match="sections"):
        BlockCodec("ANSfold-2", 0, device="cpu")
    with pytest.raises(ValueError):
        codec.encode(np.zeros(0, np.uint32))


def test_golden_container():
    """The committed container written by ans_tpu (make_fixtures.py,
    blocked.json) re-encodes to the same bytes and decodes exactly."""
    recs = json.loads((LANE_FIXTURES / "blocked.json").read_text())
    assert recs
    for rec in recs:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        codec = BlockCodec(rec["method"], rec["sections"], rec["lanes"],
                           device="cpu")
        assert codec.encode(x) == blob
        np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


# --------------------------------------------------------------------------
# the section cut: which engine ans_tpu runs decides it (the copies of
# choose_sections_joint and of the engine's predicate: test_torch_host.py)
# --------------------------------------------------------------------------

def _step_bases(rng, T, mean, hot=None):
    per = rng.poisson(mean, size=T)
    if hot is not None:
        per[hot] *= 40  # a run of heavy steps
    return np.concatenate(([0], np.cumsum(per)[:-1])), int(per.sum())


def test_joint_cut_differs_from_the_per_section_cut():
    """Where one stream's bytes crowd together, the joint cut of all
    streams differs from a calm stream's own cut: the two engines' bytes
    differ, and the writer must take the production engine's."""
    rng = np.random.default_rng(5)
    T = 512
    calm, calm_total = _step_bases(rng, T, 2)
    busy, busy_total = _step_bases(rng, T, 2, hot=slice(100, 164))
    cap = 2000
    t_joint, lens = framing.choose_sections_joint(
        [calm, busy], [calm_total, busy_total], T, cap_bytes=cap)
    t_own, own = framing.choose_sections(calm, calm_total, T, cap_bytes=cap)
    assert t_joint < t_own and len(lens[0]) > len(own)
    assert (t_joint, len(lens[0])) == (jframing.choose_sections_joint(
        [calm, busy], [calm_total, busy_total], T, cap_bytes=cap)[0],
        len(own) * t_own // t_joint)


# --------------------------------------------------------------------------
# the batched plain versions: a batch is its streams one after the other
# --------------------------------------------------------------------------

def _batch(kind, D=3, T=12, S=32):
    rng = np.random.default_rng(9)
    n = np.array([T * S, 0, 5 * S + 7][:D], np.int64)
    if kind == "grouped":
        x = rng.integers(0, 1 << 15, size=40000).astype(np.uint32)
        codec = lane.AnsFold(7, device="cpu")
    else:
        x = (rng.zipf(1.3, size=40000) - 1).astype(np.uint32)
        codec = lane.AnsFold(2, device="cpu")
    mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(x)
    enc, _ = lane._stage(mapped, k, low, len(x), ffreqs, raw, S)
    starts = np.concatenate(([0], np.cumsum(n)))
    staged = []
    for t in (mapped, k, low):
        out = torch.zeros((D, T * S), dtype=torch.int32)
        for d in range(D):
            out[d, :n[d]] = t[starts[d]:starts[d + 1]]
        staged.append(out.reshape(D, T, S))
    values = [x[starts[d]:starts[d + 1]] for d in range(D)]
    return enc, codec._table(pfreqs), staged, torch.from_numpy(n), T, values


@pytest.mark.parametrize("kind", ["fold", "grouped"])
def test_batched_scan_and_place_are_their_streams(kind):
    enc, _, (m, nb, ex), n, T, _ = _batch(kind)
    scan = (encode.encode_scan_grouped if kind == "grouped"
            else encode.encode_scan)
    scan_batch = (encode.encode_scan_grouped_batch if kind == "grouped"
                  else encode.encode_scan_batch)
    packed, states = scan_batch(m, n, enc)
    stream, offsets, ends = place.place_batch(packed, nb, ex, n)
    at = 0
    for d, nd in enumerate(n.tolist()):
        p1, s1 = scan(m[d], nd, enc)
        assert torch.equal(packed[d], p1) and torch.equal(states[d], s1)
        st1, base1, tot1 = place.place(p1, nb[d], ex[d], nd)
        assert torch.equal(stream[at:at + tot1], st1)
        assert torch.equal(offsets[d, :T], at + base1)
        at += tot1
        assert int(offsets[d, T]) == int(ends[d]) == at
    assert stream.numel() == at


@pytest.mark.parametrize("engine_name", ["search", "direct", "grouped"])
def test_batched_decode_is_its_streams(engine_name):
    enc, dec, (m, nb, ex), n, T, values = _batch(
        "grouped" if engine_name == "grouped" else "fold")
    scan_batch = (encode.encode_scan_grouped_batch
                  if engine_name == "grouped" else encode.encode_scan_batch)
    packed, states = scan_batch(m, n, enc)
    stream, offsets, _ = place.place_batch(packed, nb, ex, n)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, T]])
    tab = tables.to_device(tables.materialize_slots(dec)
                           if engine_name == "direct" else dec, "cpu")
    one, batch = {"search": (decode.decode_search,
                             decode.decode_search_batch),
                  "direct": (decode.decode_direct,
                             decode.decode_direct_batch),
                  "grouped": (decode.decode_grouped,
                              decode.decode_grouped_batch)}[engine_name]
    out = batch(stream, stream_off, states, n, tab, T)
    assert out.shape == (len(n), T, states.shape[1])
    for d, nd in enumerate(n.tolist()):
        if nd:
            s = stream[int(stream_off[d]):int(stream_off[d + 1])]
            assert torch.equal(out[d], one(s, states[d], tab, nd, T))
        np.testing.assert_array_equal(
            out[d].reshape(-1)[:nd].numpy().view(np.uint32), values[d])


def test_batched_plain_versions_count_no_launch():
    """CPU tensors take the plain versions: a blocked encode and decode
    move no launch counter."""
    counts = (encode.launches, encode.grouped_launches, place.launches,
              decode.launches, decode.direct_launches,
              decode.grouped_launches)
    codec = BlockCodec("ANSfold-2", 4, 32, device="cpu")
    x = _input("data")[:5000]
    np.testing.assert_array_equal(codec.decode(codec.encode(x)), x)
    assert (encode.launches, encode.grouped_launches, place.launches,
            decode.launches, decode.direct_launches,
            decode.grouped_launches) == counts


def test_module_functions():
    """encode_blocked / decode_blocked are the codec's encode and decode."""
    from ans_tpu_torch.parallel import decode_blocked, encode_blocked
    x = _input("data")[:4000]
    blob = encode_blocked(x, "ANSmsb", 3, 32, device="cpu")
    assert blob == BlockCodec("ANSmsb", 3, 32, device="cpu").encode(x)
    np.testing.assert_array_equal(
        decode_blocked(blob, len(x), "ANSmsb", device="cpu"), x)
