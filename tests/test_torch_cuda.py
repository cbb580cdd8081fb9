"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip.  On the
card, run them without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py covers the main paths at full width; these cover the edges:
lane counts from 1 to 2^14 (one to sixteen lanes per decode thread),
for K1 ragged scans, rows past n, absent symbols and tables in and out of
shared memory, for K2 its step offsets on up to 2^17 steps, steps that
write no byte and the same bytes on repeated runs, an encode path that
calls no plain round totals, three renorm rounds, three exception bytes,
corrupt streams, and for the grouped kernels K5/K6 one-group frames,
~2^12 groups, per-rank tables too large for shared memory and
out-of-range ranks; for the direct kernel K4
tables past 48 KB, both slot orders and frames that do not fit; for the
two instances of K3, K4 and K5 (the stream staged in a shared-memory ring,
or read from device memory) every lane count, streams shorter than one
16-byte granule, payloads at odd addresses, truncated streams and a frame
that leaves the ring no room; for K6 scans that end inside a tile of
steps, inside a row of lanes and inside a block of lanes; for the byte
splitters K7-K9 every element
length, ragged sizes and corrupt streams, and for the single passes K7,
K8 and K9 sizes at chunk multiples +-1, elements across chunk boundaries
(K8: every length at a chunk's last element, a partial last control
byte), streams at every odd address, a look-back past one window,
repeated calls and (K8) streams one byte short; for the step probe every
chain against its plain version; for the batched K1-K6 batches of 1 to
133 streams of unequal length with an empty one, at 32 to 16384 lanes,
both decode instances and K2's chain across the streams, the batch of
one against the one-stream wrappers, and BlockCodec on the card against
the CPU's container; for K1 and K3-K6 batches of streams with a model
each (frames of log2m 12 to 17, renorm rounds 2 and 3, exception bytes
or none, K6 fed symbol ids and ranks, K5 with and without a per-rank
table) at 32 and 4096 lanes, and PseudoAdaptive on the card against the
CPU's container, one launch a kernel a batch.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ans_tpu_torch import probe
from ans_tpu_torch.models import engine
from ans_tpu_torch.models.ans import AnsFold, AnsInt, _stage, _stage_ts
from ans_tpu_torch.ops import (bytesplit, decode, encode, grouped, lane_codec,
                               place, tables)
from ans_tpu_torch.ops.mappings import fold_map_hist
from ans_tpu_torch.reference_model import mappings as map_np
from ans_tpu_torch.reference_model.model import adjust_freqs

LANE_FIXTURES = Path(__file__).parent / "fixtures" / "lane"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _values(n, seed, wide=False):
    rng = np.random.default_rng(seed)
    x = (rng.zipf(1.3, size=n) - 1).clip(0, 1 << 27)
    if wide:
        big = rng.integers(1 << 25, 1 << 32, size=n, dtype=np.uint64)
        x = np.where(rng.random(n) < 0.2, big, x)
    return x.astype(np.uint32)


def _fold_tables(x, fidelity, device):
    """Staged (T, S)-ready inputs and both device tables for fold-f."""
    mapped, k, low, hist = fold_map_hist(
        torch.from_numpy(x.view(np.int32)).to(device), fidelity=fidelity,
        length=1 << (fidelity + 9))
    freqs = hist.cpu().numpy().astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(np.flatnonzero(freqs)[-1]), True, 1)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    st = tables.build_search_table(nfreqs,
                                   *map_np.fold_unmap_high(syms, fidelity))
    return (mapped, k, low, tables.to_device(tables.build_enc_table(nfreqs),
                                             device),
            tables.to_device(st, device))


def _encode_all(mapped, k, low, enc, n, S):
    """K1 and K2 against their plain versions: (stream, states, T)."""
    T = lane_codec.lane_steps(n, S)
    m_ts, nb_ts, ex_ts = _stage_ts(mapped, k, low, n, S, T)
    packed, states = encode.encode_scan(m_ts, n, enc)
    pp, ps = lane_codec.encode_scan_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    stream, step_base, total = place.place(packed, nb_ts, ex_ts, n)
    ws, wb, wt = lane_codec.place_plain(packed, nb_ts, ex_ts, n)
    assert torch.equal(stream, ws) and torch.equal(step_base, wb)
    assert total == wt
    return stream, states, T


def _run_all(mapped, k, low, enc, dec, n, S):
    """Kernels and plain versions on the same device tensors."""
    stream, states, T = _encode_all(mapped, k, low, enc, n, S)
    out = decode.decode_search(stream, states, dec, n, T)
    assert torch.equal(out, lane_codec.decode_search_plain(stream, states,
                                                           dec, n, T))
    return out, stream, states, T


@pytest.mark.parametrize("S", [1, 32, 128, 2048, 8192, 16384])
@pytest.mark.parametrize("wide", [False, True])
def test_kernels_match_plain(cuda, S, wide):
    n = 20 * S + 7 if S > 1 else 500
    x = _values(n, S, wide)
    mapped, k, low, enc, dec = _fold_tables(x, 2, cuda)
    counts = (encode.launches, place.launches, decode.launches)
    out, *_ = _run_all(mapped, k, low, enc, dec, n, S)
    assert (encode.launches, place.launches, decode.launches) == tuple(
        c + 1 for c in counts)
    np.testing.assert_array_equal(
        out.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)


def test_three_renorm_rounds(cuda):
    """M = 2^17 (log2m > 16): three renorm rounds, split tables."""
    n, S = 30000, 256
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4096, size=n).astype(np.uint32)
    nfreqs = np.full(4096, 32, np.uint64)
    enc = tables.to_device(tables.build_enc_table(nfreqs), cuda)
    st = tables.build_search_table(nfreqs)
    dec = tables.to_device(st, cuda)
    assert dec.NR == 3
    xt = torch.from_numpy(x.view(np.int32)).to(cuda)
    zero = torch.zeros_like(xt)
    out, *_ = _run_all(xt, zero, zero, enc, dec, n, S)
    np.testing.assert_array_equal(
        out.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)


def test_deepest_search_alphabet(cuda):
    """Fold-8 with ~8k live symbols: depth 13, and K3's shared tables pass
    48 KB, so the kernel runs on opted-in dynamic shared memory."""
    n, S = 60000, 256
    x = np.random.default_rng(4).integers(0, 8150, size=n).astype(np.uint32)
    mapped, k, low, enc, dec = _fold_tables(x, 8, cuda)
    assert dec.depth == 13
    assert 4 * ((1 << dec.depth) + 1 + 2 * dec.sigma) > 48 * 1024
    out, *_ = _run_all(mapped, k, low, enc, dec, n, S)
    np.testing.assert_array_equal(
        out.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)


def test_corrupt_stream_raises(cuda):
    n, S = 40000, 1024
    x = _values(n, 5)
    mapped, k, low, enc, dec = _fold_tables(x, 2, cuda)
    _, stream, states, T = _run_all(mapped, k, low, enc, dec, n, S)
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_search(stream[: stream.numel() // 2].clone(), states,
                             dec, n, T)


def test_wrapper_refuses_mixed_devices(cuda):
    x = _values(1000, 1)
    mapped, k, low, enc, dec = _fold_tables(x, 2, cuda)
    T = lane_codec.lane_steps(1000, 32)
    m_ts, _, _ = _stage_ts(mapped, k, low, 1000, 32, T)
    with pytest.raises(ValueError):
        encode.encode_scan(m_ts.cpu(), 1000, enc)


@pytest.mark.parametrize("rec", json.loads(
    (LANE_FIXTURES / "manifest.json").read_text()), ids=lambda r: r["blob"])
def test_golden_fixture_on_card(cuda, rec):
    from ans_tpu_torch import models
    x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
    blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
    codec = models.get(rec["method"], lanes=rec["lanes"], device=cuda)
    assert codec.encode(x) == blob
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


# --------------------------------------------------------------------------
# the value-indexed scan K1 (encode_scan) and the placement K2 (place)
# --------------------------------------------------------------------------

def _value_table(sigma, seed, absent=0.0):
    """An encode table over sigma symbols (a share `absent` of them with
    frequency 0) and symbols drawn from it."""
    rng = np.random.default_rng(seed)
    nf = rng.integers(1, 40, size=sigma).astype(np.uint64)
    nf[rng.random(sigma) < absent] = 0
    nf[0] = max(int(nf[0]), 1)
    M = 1 << int(np.ceil(np.log2(nf.sum())))
    nf[0] += M - int(nf.sum())
    return nf


@pytest.mark.parametrize("sigma,absent", [(300, 0.0), (8192, 0.0),
                                          (1546, 0.3), (20000, 0.5)])
@pytest.mark.parametrize("S", [1, 32, 4096, 16384])
def test_scan_matches_plain(cuda, S, sigma, absent):
    """K1 at every lane count on ragged T (n ends mid-row and mid-tile),
    with the table in shared memory (sigma up to 8192) or read through
    __ldg (20000 rows), symbols of frequency 0 among the inputs (they
    code as frequency 1), and symbols outside the table past n (never
    read)."""
    nf = _value_table(sigma, S + sigma, absent)
    enc = tables.to_device(tables.build_enc_table(nf), cuda)
    T = {1: 1000, 32: 77, 4096: 45, 16384: 33}[S]
    n = (T - 1) * S + max(1, S // 3)
    rng = np.random.default_rng(S)
    syms = rng.integers(0, sigma, size=T * S).astype(np.int32)
    syms[n:] = sigma + 7
    m_ts = torch.from_numpy(syms.reshape(T, S)).to(cuda)
    count = encode.launches
    packed, states = encode.encode_scan(m_ts, n, enc)
    assert encode.launches == count + 1
    pp, ps = lane_codec.encode_scan_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    assert absent == 0 or (nf[syms[:n]] == 0).any()


@pytest.mark.parametrize("S,T,n", [(32, 40, 20 * 32 + 5), (4096, 70, 4096),
                                   (100, 33, 1), (1, 64, 3)])
def test_scan_rows_past_n(cuda, S, T, n):
    """K1 on a staging with more steps than n needs: every row past n is a
    pad (no bytes, the state kept), whole tiles of them included."""
    enc = tables.to_device(tables.build_enc_table(_value_table(512, T)),
                           cuda)
    syms = np.random.default_rng(T).integers(0, 512, size=T * S)
    m_ts = torch.from_numpy(syms.astype(np.int32).reshape(T, S)).to(cuda)
    packed, states = encode.encode_scan(m_ts, n, enc)
    pp, ps = lane_codec.encode_scan_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)


@pytest.mark.parametrize("S", [1, 4096])
def test_scan_symbol_outside_the_table_raises(cuda, S):
    enc = tables.to_device(tables.build_enc_table(_value_table(64, 1)), cuda)
    T = 50
    syms = np.zeros(T * S, np.int32)
    syms[(T * S) // 2] = 64
    m_ts = torch.from_numpy(syms.reshape(T, S)).to(cuda)
    with pytest.raises(ValueError, match="outside the table"):
        encode.encode_scan(m_ts, T * S, enc)
    encode.encode_scan(m_ts, (T * S) // 2, enc)  # past n: not read


def _place_inputs(T, S, seed, ne=3, busy=0.3):
    """(packed, nb, excw) on the card: most steps write no byte, a few
    lanes of the others renormalise or carry up to `ne` exception bytes."""
    rng = np.random.default_rng(seed)
    on = rng.random(T) < busy
    rc = np.where(on[:, None] & (rng.random((T, S)) < 0.3),
                  rng.integers(1, 4, size=(T, S)), 0)
    nb = np.where(on[:, None] & (rng.random((T, S)) < 0.3),
                  rng.integers(0, ne + 1, size=(T, S)), 0)
    packed = rng.integers(0, 1 << 24, size=(T, S)) | (rc << 24)
    low = rng.integers(0, 1 << 24, size=(T, S))
    return tuple(torch.from_numpy(a.astype(np.int32)).to("cuda")
                 for a in (packed, nb, low))


def _place_checked(packed, nb, excw, n):
    count = place.launches
    stream, step_base, total = place.place(packed, nb, excw, n)
    assert place.launches == count + 1
    ws, wb, wt = lane_codec.place_plain(packed, nb, excw, n)
    assert total == wt and torch.equal(step_base, wb)
    assert torch.equal(stream, ws)
    return stream, step_base, total


@pytest.mark.parametrize("S,T,busy", [
    (1, 1 << 16, 0.3), (1, (1 << 17) + 3, 1.0), (32, 5000, 0.3),
    (100, 300, 0.5), (2048, 33, 0.3), (4096, 40, 1.0), (16384, 9, 0.5),
    (256, 2000, 0.0)])
def test_place_matches_plain(cuda, S, T, busy):
    """K2 against its plain version, step offsets and length included: more
    steps than blocks in flight (S = 1: 2^16 and 2^17 steps), chunks of
    several steps a block (S < 1024), steps that write no byte, an input
    that writes none, and n ending mid-row."""
    packed, nb, excw = _place_inputs(T, S, S + T, busy=busy)
    n = (T - 1) * S + max(1, S // 3)
    _, step_base, total = _place_checked(packed, nb, excw, n)
    assert (total == 0) == (busy == 0)
    sizes = torch.diff(step_base, append=step_base.new_tensor([total]))
    assert busy == 1.0 or bool((sizes == 0).any())


@pytest.mark.parametrize("S,T", [(1, 1 << 16), (4096, 8192)])
def test_place_same_bytes_every_run(cuda, S, T):
    """The look-back changes only the order in which blocks learn their
    offsets: five runs write the same bytes, at S = 1 with 2^16 steps and
    at the main path's full width."""
    packed, nb, excw = _place_inputs(T, S, 7, busy=1.0)
    n = T * S
    want, step_base, total = _place_checked(packed, nb, excw, n)
    digest = hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest()
    for _ in range(5):
        stream, sb, got = place.place(packed, nb, excw, n, total)
        assert got == total and torch.equal(sb, step_base)
        assert hashlib.sha256(
            stream.cpu().numpy().tobytes()).hexdigest() == digest


def test_place_refuses_a_wrong_total(cuda):
    packed, nb, excw = _place_inputs(100, 64, 3, busy=1.0)
    _, _, total = place.place(packed, nb, excw, 6400)
    for wrong in (total - 1, total + 1):
        with pytest.raises(ValueError, match="section plan"):
            place.place(packed, nb, excw, 6400, wrong)
    with pytest.raises(ValueError, match="lanes"):
        z = torch.zeros((2, place.MAX_LANES * 2), dtype=torch.int32,
                        device=cuda)
        place.place(z, z, z, z.numel())


@pytest.mark.parametrize("name", ["ANSfold-2", "ANSfold-8"])
def test_prepared_encoder_calls_no_encode_totals(cuda, name, monkeypatch):
    """On the card the encode path is the scan and K2 alone: the plain
    round totals are never called, by the one-shot encode, the prepared
    encoder's set-up or its calls."""
    from ans_tpu_torch import models
    x = (_values(50000, 3) if name == "ANSfold-2" else
         np.random.default_rng(1).integers(0, 1 << 15, size=50000).astype(
             np.uint32))
    want = models.get(name, lanes=256, device="cpu").encode(x)

    def refuse(*args, **kw):
        raise AssertionError("encode_totals was called on the card")
    monkeypatch.setattr(lane_codec, "encode_totals", refuse)
    assert models.get(name, lanes=256, device=cuda).encode(x) == want
    counts = (encode.launches + encode.grouped_launches, place.launches)
    pe = models.prepare_encoder(name, x, lanes=256, device=cuda)
    assert pe.prelude + pe.to_bytes(*pe()) == want
    assert (encode.launches + encode.grouped_launches,
            place.launches) == (counts[0] + 2, counts[1] + 2)


# --------------------------------------------------------------------------
# the grouped kernels: K6 (encode_scan_grouped) and K5 (decode_grouped)
# --------------------------------------------------------------------------

def _grouped_run(m_ts, nb_ts, ex_ts, n, enc, dec):
    """K6, K2 and K5 (in the instance its wrapper picks, and on global
    loads) against their plain versions on the same tensors."""
    T = m_ts.shape[0]
    counts = (encode.grouped_launches, decode.grouped_launches)
    packed, states = encode.encode_scan_grouped(m_ts, n, enc)
    pp, ps = lane_codec.encode_scan_grouped_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    stream, step_base, total = place.place(packed, nb_ts, ex_ts, n)
    ws, wb, wt = lane_codec.place_plain(packed, nb_ts, ex_ts, n)
    assert torch.equal(stream, ws) and torch.equal(step_base, wb)
    out = decode.decode_grouped(stream, states, dec, n, T)
    assert torch.equal(out, lane_codec.decode_grouped_plain(stream, states,
                                                            dec, n, T))
    assert torch.equal(out, decode.decode_grouped(stream, states, dec, n, T,
                                                  instance="global"))
    assert (encode.grouped_launches, decode.grouped_launches) == (
        counts[0] + 1, counts[1] + 2)
    return out.cpu().numpy().view(np.uint32).reshape(-1)[:n], stream, states


def _codec_run(codec, x, S, cuda):
    """A codec's own staging and tables (encode as encode() does, decode
    with the table the prelude gives)."""
    mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(x)
    enc, staged = _stage(mapped, k, low, len(x), ffreqs, raw, S)
    assert isinstance(enc, tables.GroupedEncDevice)
    table, _ = codec._dec_table(codec.encode(x))
    dec = tables.to_device(table, cuda)
    return _grouped_run(*staged, len(x), enc, dec), dec


def _dense_values(n, seed):
    """Every value of 0..11999 present, tail frequencies mixed so that the
    tail escape declines (ANS stays on the grouped layout)."""
    rng = np.random.default_rng(seed)
    head = np.concatenate([np.arange(12000), np.arange(0, 12000, 2)])
    tail = (rng.zipf(1.5, size=max(n - len(head), 0)) - 1).clip(0, 11999)
    return np.concatenate([head, tail])[:n].astype(np.uint32)


@pytest.mark.parametrize("S", [1, 32, 4096, 16384])
def test_grouped_fold_matches_plain(cuda, S):
    """ANSfold-8 over ~14k live symbols: K6 with the in-kernel symbol ->
    rank map, K5 with high/nb tables in shared memory."""
    n = max(20000, 20 * S + 7)
    x = np.random.default_rng(S).integers(0, 1 << 15, size=n).astype(
        np.uint32)
    (out, *_), dec = _codec_run(AnsFold(8, device=cuda), x, S, cuda)
    assert dec.table.numel() == dec.sigma
    np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("S", [32, 4096, 16384])
def test_grouped_values_match_plain(cuda, S):
    """ANS on a dense alphabet the escape declines: K6 on ranks, K5 with
    a value table."""
    x = _dense_values(max(48000, 20 * S + 7), S)
    codec = AnsInt(device=cuda)
    (out, *_), dec = _codec_run(codec, x, S, cuda)
    assert dec.NE == 0 and dec.table.numel() == dec.sigma
    np.testing.assert_array_equal(out, x)


def _frame_run(nfreqs, S, cuda, n=30000, seed=0, exceptions=False):
    """A hand-built grouped frame: values drawn from nfreqs; K6 on
    ranks; K5 with the value table (or high = sym << 8 and one exception
    byte, the low byte)."""
    rng = np.random.default_rng(seed)
    nf = np.asarray(nfreqs, dtype=np.uint64)
    syms = rng.choice(len(nf), size=n, p=nf / nf.sum()).astype(np.uint32)
    lay = grouped.build_group_layout(nf)
    enc = tables.grouped_enc_to_device(lay, cuda, rank_of=False)
    ranks = torch.from_numpy(lay.rank_of[syms].view(np.int32)).to(cuda)
    T = lane_codec.lane_steps(n, S)
    high = nb = None
    if exceptions:
        low = rng.integers(0, 256, size=n).astype(np.uint32)
        x = (syms << np.uint32(8)) | low
        ids = np.arange(len(nf), dtype=np.uint32)
        high, nb = ids << np.uint32(8), np.ones(len(nf), np.uint32)
        k = torch.ones_like(ranks)
        lw = torch.from_numpy(low.view(np.int32)).to(cuda)
    else:
        x = syms
        k = lw = torch.zeros_like(ranks)
    dec = tables.to_device(tables.build_grouped_table(nf, high, nb), cuda)
    staged = _stage_ts(ranks, k, lw, n, S, T)
    out, stream, states = _grouped_run(*staged, n, enc, dec)
    np.testing.assert_array_equal(out, x)
    return lay, dec, stream, states, T, enc


@pytest.mark.parametrize("S", [32, 4096])
def test_grouped_one_group(cuda, S):
    """Every live symbol has one frequency: NG = 1, no search levels, and
    the rank is the value (K5 without a table)."""
    lay, dec, *_ = _frame_run(np.ones(1 << 14, np.uint64), S, cuda)
    assert lay.num_groups == 1 and dec.depth == 0
    assert dec.table.numel() == 0


def test_grouped_sixteen_lanes_a_thread_with_exceptions(cuda):
    """S = 16384 with exception rounds: the 16-lane instance of K5 on
    five byte rounds a step."""
    f = np.ones(9000, np.int64)
    f[:7384] = 2
    nf = np.random.default_rng(7).permutation(f).astype(np.uint64)
    _frame_run(nf, 16384, cuda, n=20 * 16384 + 7, exceptions=True)


def _many_groups_freqs(seed=3):
    """2892 distinct frequencies plus 8192 symbols of frequency 1, summing
    to 2^22: NG near its sqrt(2M) bound, K6's tables past 48 KB."""
    k = 2892
    f = np.concatenate([np.arange(1, k + 1), np.ones(8192, np.int64)])
    f[k - 1] += (1 << 22) - int(f.sum())
    return np.random.default_rng(seed).permutation(f).astype(np.uint64)


def test_grouped_many_groups(cuda):
    nf = _many_groups_freqs()
    lay, dec, *_ = _frame_run(nf, 4096, cuda, n=60000)
    assert lay.num_groups == 2892 and lay.log2m == 22
    assert 16 * lay.num_groups + 4 * ((1 << lay.rank_depth) + 1) > 48 * 1024


@pytest.mark.parametrize("exceptions", [False, True])
def test_grouped_table_in_global_memory(cuda, exceptions):
    """sigma = 60000: the per-rank table (240 KB, or 300 KB with nb)
    does not fit in shared memory and is read from global memory."""
    f = np.ones(60000, np.int64)
    f[:5536] = 2
    nf = np.random.default_rng(4).permutation(f).astype(np.uint64)
    assert int(nf.sum()) == 1 << 16
    _, dec, *_ = _frame_run(nf, 4096, cuda, n=80000, exceptions=exceptions)
    assert 4 * dec.sigma > 220 * 1024 and dec.NE == int(exceptions)


def test_grouped_corrupt_stream_and_rank_raise(cuda):
    nf = _many_groups_freqs()
    lay, dec, stream, states, T, enc = _frame_run(nf, 1024, cuda)
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_grouped(stream[: stream.numel() // 2].clone(), states,
                              dec, 30000, T)
    bad = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    bad[1, 5] = lay.sigma
    with pytest.raises(ValueError, match="outside"):
        encode.encode_scan_grouped(bad, 64, enc)
    byval = tables.grouped_enc_to_device(lay, cuda, rank_of=True)
    bad[1, 5] = len(lay.rank_of)
    with pytest.raises(ValueError, match="outside"):
        encode.encode_scan_grouped(bad, 64, byval)


@pytest.mark.parametrize("S", [1, 32, 4096, 16384])
@pytest.mark.parametrize("instance", ["ring", "global"])
def test_grouped_instances_match_plain(cuda, S, instance):
    """K5 through each instance on ANSfold-8 over more than 2^13 live
    symbols, with exception rounds (wide values: NE = 3) wherever the ring
    can hold six rounds beside the tables; where it cannot, forcing it
    raises and the ring is held on the renorm rounds alone."""
    n = max(20000, 20 * S + 7)
    rng = np.random.default_rng(S + 3)
    small = rng.integers(0, 12000, size=n).astype(np.uint32)
    big = rng.integers(1 << 25, 1 << 32, size=n, dtype=np.uint64)
    x = np.where(rng.random(n) < 0.2, big, small).astype(np.uint32)
    T = lane_codec.lane_steps(n, S)
    (out, stream, states), dec = _codec_run(AnsFold(8, device=cuda), x, S,
                                            cuda)
    assert dec.NE == 3
    fits = decode.choose_instance(
        "decode_grouped", decode.grouped_shared_tables(dec)[1], S,
        dec.NR + dec.NE)[0] == "ring"
    assert fits or S > 32  # a ring of 1 KB fits beside any tables
    if instance == "ring" and not fits:
        with pytest.raises(ValueError, match="does not fit"):
            decode.decode_grouped(stream, states, dec, n, T, instance="ring")
        x = small
        (out, stream, states), dec = _codec_run(AnsFold(8, device=cuda), x,
                                                S, cuda)
        assert dec.NE == 0
    np.testing.assert_array_equal(out, x)
    before = decode.instance_launches["decode_grouped"][instance]
    got = decode.decode_grouped(stream, states, dec, n, T, instance=instance)
    assert decode.instance_launches["decode_grouped"][instance] == before + 1
    assert torch.equal(got, lane_codec.decode_grouped_plain(stream, states,
                                                            dec, n, T))


def _small_grouped_freqs(seed=6):
    """9000 symbols of frequency 1 or 2 in no order, M = 2^14."""
    f = np.ones(9000, np.int64)
    f[:7384] = 2
    return np.random.default_rng(seed).permutation(f).astype(np.uint64)


@pytest.mark.parametrize("instance", ["ring", "global"])
def test_grouped_short_and_odd_streams(cuda, instance):
    """K5 on a stream shorter than one 16-byte granule, on payloads that
    start at every odd byte offset inside a granule, and on streams whose
    last bytes are missing."""
    nf = _small_grouped_freqs()
    _, dec, stream, states, T, _ = _frame_run(nf, 1, cuda, n=6)
    assert 0 < stream.numel() < 16
    want = lane_codec.decode_grouped_plain(stream, states, dec, 6, T)
    for lead in (0, 1, 15):
        at = torch.cat([torch.full((lead,), 0xAB, dtype=torch.uint8,
                                   device=cuda), stream])[lead:]
        assert torch.equal(decode.decode_grouped(at, states, dec, 6, T,
                                                 instance=instance), want)
    n, S = 40007, 1024
    _, dec, stream, states, T, _ = _frame_run(nf, S, cuda, n=n,
                                              exceptions=True)
    want = lane_codec.decode_grouped_plain(stream, states, dec, n, T)
    for lead in range(1, 16):
        pad = torch.full((lead,), 0xCD, dtype=torch.uint8, device=cuda)
        at = torch.cat([pad, stream, pad])[lead:lead + stream.numel()]
        assert at.data_ptr() % 16 == lead
        assert torch.equal(decode.decode_grouped(
            at, states, dec, n, T, instance=instance), want), lead
    for cut in (1, 7, 16, 33):  # the last steps' bytes are missing
        with pytest.raises(ValueError, match="corrupt"):
            decode.decode_grouped(stream[: stream.numel() - cut], states,
                                  dec, n, T, instance=instance)


@pytest.mark.parametrize("instance", ["ring", "global"])
def test_grouped_truncated_and_corrupt_streams(cuda, instance):
    """Half a stream raises; flipped bytes and foreign states decode to
    what the plain version decodes from them, or raise where it raises."""
    n, S = 40000, 1024
    _, dec, stream, states, T, _ = _frame_run(_small_grouped_freqs(), S,
                                              cuda, n=n, exceptions=True)
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_grouped(stream[: stream.numel() // 2].clone(), states,
                              dec, n, T, instance=instance)
    rng = np.random.default_rng(1)
    flipped = stream.clone()
    at = torch.from_numpy(rng.integers(0, stream.numel(), 64)).to(cuda)
    flipped[at] ^= 0x5A
    bad_states = states.clone()
    bad_states[::3] = 1 << 23  # every third lane reads too much
    for src, sts in ((flipped, states), (stream, bad_states)):
        try:
            want = lane_codec.decode_grouped_plain(src, sts, dec, n, T)
        except ValueError:
            with pytest.raises(ValueError, match="corrupt"):
                decode.decode_grouped(src, sts, dec, n, T, instance=instance)
        else:
            assert torch.equal(decode.decode_grouped(
                src, sts, dec, n, T, instance=instance), want)


def test_grouped_table_that_leaves_the_ring_no_room(cuda):
    """sigma = 40000 with one exception byte: 201 KB of tables fit the
    block, the ring beside them does not, so the wrapper takes K5's
    instance on global loads with its per-rank table in shared memory;
    forcing the ring raises."""
    f = np.ones(40000, np.int64)
    f[:25536] = 2
    nf = np.random.default_rng(8).permutation(f).astype(np.uint64)
    assert int(nf.sum()) == 1 << 16
    before = dict(decode.instance_launches["decode_grouped"])
    _, dec, stream, states, T, _ = _frame_run(nf, 4096, cuda, n=80000,
                                              exceptions=True)
    assert decode.grouped_shared_tables(dec)[0]
    assert decode.instance_launches["decode_grouped"] == {
        "ring": before["ring"], "global": before["global"] + 2}
    with pytest.raises(ValueError, match="does not fit"):
        decode.decode_grouped(stream, states, dec, 80000, T, instance="ring")


@pytest.mark.parametrize("by_symbol", [False, True])
@pytest.mark.parametrize("S,T", [
    (1, 5), (1, 70), (32, 31), (32, 33), (100, 64), (100, 7), (4096, 1),
    (4096, 40), (16384, 33)])
def test_grouped_scan_ragged_shapes(cuda, S, T, by_symbol):
    """K6 on scans that end inside a tile of 32 steps (or have fewer
    steps than one tile), inside a row of lanes (n ends mid-row) and
    inside a block of 32 lanes (S = 1, 100), fed ranks or symbol ids."""
    nf = _many_groups_freqs()
    lay = grouped.build_group_layout(nf)
    enc = tables.grouped_enc_to_device(lay, cuda, rank_of=by_symbol)
    n = (T - 1) * S + max(1, S // 3)
    rng = np.random.default_rng(S * 131 + T)
    syms = rng.choice(len(nf), size=T * S, p=nf / nf.sum()).astype(np.uint32)
    vals = syms if by_symbol else lay.rank_of[syms]
    # what lies past n is not read: put symbols outside the tables there
    vals = vals.astype(np.int32)
    vals[n:] = len(nf) + 5
    m_ts = torch.from_numpy(vals.reshape(T, S)).to(cuda)
    count = encode.grouped_launches
    packed, states = encode.encode_scan_grouped(m_ts, n, enc)
    assert encode.grouped_launches == count + 1
    pp, ps = lane_codec.encode_scan_grouped_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)


@pytest.mark.parametrize("S,T,n", [(32, 40, 20 * 32 + 5), (4096, 70, 4096),
                                   (100, 33, 1)])
def test_grouped_scan_rows_past_n(cuda, S, T, n):
    """K6 on a staging with more steps than n needs: every row past n is a
    pad (no bytes, the state kept), whole tiles of them included."""
    nf = _small_grouped_freqs()
    lay = grouped.build_group_layout(nf)
    enc = tables.grouped_enc_to_device(lay, cuda, rank_of=False)
    rng = np.random.default_rng(T)
    ranks = rng.integers(0, lay.sigma, size=T * S).astype(np.int32)
    m_ts = torch.from_numpy(ranks.reshape(T, S)).to(cuda)
    packed, states = encode.encode_scan_grouped(m_ts, n, enc)
    pp, ps = lane_codec.encode_scan_grouped_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)


# --------------------------------------------------------------------------
# the direct kernel K4 (decode_direct)
# --------------------------------------------------------------------------

def _direct(table, cuda):
    return tables.to_device(tables.materialize_slots(table), cuda)


def _fold_host_table(x, fidelity):
    mapped, k, low, hist = fold_map_hist(
        torch.from_numpy(x.view(np.int32)), fidelity=fidelity,
        length=1 << (fidelity + 9))
    freqs = hist.numpy().astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(np.flatnonzero(freqs)[-1]), True, 1)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    return tables.build_search_table(
        nfreqs, *map_np.fold_unmap_high(syms, fidelity))


@pytest.mark.parametrize("S", [1, 32, 4096, 16384])
@pytest.mark.parametrize("wide", [False, True])
def test_direct_matches_plain_and_search(cuda, S, wide):
    n = 20 * S + 7 if S > 1 else 500
    x = _values(n, S + 1, wide)
    mapped, k, low, enc, dec = _fold_tables(x, 2, cuda)
    stream, states, T = _encode_all(mapped, k, low, enc, n, S)
    dd = _direct(_fold_host_table(x, 2), cuda)
    count = decode.direct_launches
    got = decode.decode_direct(stream, states, dd, n, T)
    assert decode.direct_launches == count + 1
    assert torch.equal(got, lane_codec.decode_direct_plain(stream, states,
                                                           dd, n, T))
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)
    assert torch.equal(got, decode.decode_search(stream, states, dec, n, T))


def test_direct_tables_past_48k(cuda):
    """Fold-8 with ~8k live symbols: 16 bytes a symbol and 2 a slot pass
    48 KB, so K4 runs on opted-in dynamic shared memory."""
    n, S = 60000, 256
    x = np.random.default_rng(4).integers(0, 8150, size=n).astype(np.uint32)
    mapped, k, low, enc, dec = _fold_tables(x, 8, cuda)
    out, stream, states, T = _run_all(mapped, k, low, enc, dec, n, S)
    host = _fold_host_table(x, 8)
    assert 48 * 1024 < tables.direct_table_bytes(host) \
        <= tables.DIRECT_TABLE_BYTES
    dd = _direct(host, cuda)
    got = decode.decode_direct(stream, states, dd, n, T)
    assert torch.equal(got, lane_codec.decode_direct_plain(stream, states,
                                                           dd, n, T))
    assert torch.equal(got, out)
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_direct(stream[: stream.numel() // 2].clone(), states,
                             dd, n, T)


@pytest.mark.parametrize("exceptions", [False, True])
def test_direct_reads_grouped_slot_order(cuda, exceptions):
    """A frequency-grouped frame small enough for K4 (9000 symbols,
    M = 2^14): the per-slot table follows the rank order, and K4 decodes
    what K5 decodes."""
    f = np.ones(9000, np.int64)
    f[:7384] = 2
    nf = np.random.default_rng(6).permutation(f).astype(np.uint64)
    assert int(nf.sum()) == 1 << 14
    lay, dec, stream, states, T, _ = _frame_run(nf, 4096, cuda, n=50000,
                                                exceptions=exceptions)
    ids = np.arange(len(nf), dtype=np.uint32)
    hi_nb = ((ids << np.uint32(8), np.ones(len(nf), np.uint32))
             if exceptions else (None, None))
    gt = tables.build_grouped_table(nf, *hi_nb)
    assert tables.direct_fits(gt)
    dd = _direct(gt, cuda)
    got = decode.decode_direct(stream, states, dd, 50000, T)
    assert torch.equal(got, lane_codec.decode_direct_plain(stream, states,
                                                           dd, 50000, T))
    assert torch.equal(got, decode.decode_grouped(stream, states, dec, 50000,
                                                  T))


def test_direct_refuses_frames_that_do_not_fit(cuda):
    """M = 2^17: 256 KB of slot indices alone; the rule never picks
    "direct", forcing it raises, and so does the wrapper."""
    nf = np.full(4096, 32, np.uint64)
    st = tables.build_search_table(nf)
    assert not tables.direct_fits(st)
    assert engine.choose_decode_engine(st, 4096) == "search"
    payload, states = np.zeros(8, np.uint8), np.full(32, 1 << 23, np.uint32)
    with pytest.raises(ValueError, match="not eligible"):
        engine.PreparedDecoder(payload, states, st, 64, S=32, T=2,
                               sec_len=[8], device=cuda, engine="direct")
    with pytest.raises(ValueError, match="shared memory"):
        decode.decode_direct(
            torch.zeros(8, dtype=torch.uint8, device=cuda),
            torch.full((32,), 1 << 23, dtype=torch.int32, device=cuda),
            _direct(st, cuda), 64, 2)


# --------------------------------------------------------------------------
# the two instances of the lockstep step of K3 and K4 (csrc/lockstep.cuh)
# --------------------------------------------------------------------------

def _both_decoders(x, S, cuda):
    """(stream, states, T, [(name, wrapper, plain, table), ...]) for K3
    and K4 on ANSfold-2 of x."""
    n = len(x)
    mapped, k, low, enc, dec = _fold_tables(x, 2, cuda)
    stream, states, T = _encode_all(mapped, k, low, enc, n, S)
    dd = _direct(_fold_host_table(x, 2), cuda)
    return stream, states, T, [
        ("decode_search", decode.decode_search,
         lane_codec.decode_search_plain, dec),
        ("decode_direct", decode.decode_direct,
         lane_codec.decode_direct_plain, dd)]


@pytest.mark.parametrize("S", [1, 32, 4096, 16384])
@pytest.mark.parametrize("instance", ["ring", "global"])
def test_lockstep_instances_match_plain(cuda, S, instance):
    """K3 and K4 through each instance, with exception rounds (wide
    values: NE = 3), against their plain versions."""
    n = 20 * S + 7 if S > 1 else 500
    x = _values(n, S + 2, wide=True)
    stream, states, T, decoders = _both_decoders(x, S, cuda)
    if instance == "ring" and S == 16384:
        # five rounds of 16384 lanes: two steps (160 KB) do not fit a ring
        for name, fn, plain, table in decoders:
            assert table.NE == 3
            with pytest.raises(ValueError, match="does not fit"):
                fn(stream, states, table, n, T, instance="ring")
        # two renorm rounds alone (64 KB, a 128 KB ring) do
        x = _values(n, S + 2) % 200
        stream, states, T, decoders = _both_decoders(x, S, cuda)
    for name, fn, plain, table in decoders:
        assert table.NE == (0 if instance == "ring" and S == 16384 else 3)
        before = decode.instance_launches[name][instance]
        got = fn(stream, states, table, n, T, instance=instance)
        assert decode.instance_launches[name][instance] == before + 1
        assert torch.equal(got, plain(stream, states, table, n, T)), name
        np.testing.assert_array_equal(
            got.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)


@pytest.mark.parametrize("instance", ["ring", "global"])
def test_lockstep_short_and_odd_streams(cuda, instance):
    """A stream shorter than one 16-byte granule; payloads that start at
    every byte offset inside a granule (a slice of a larger tensor, as
    the byte composites pass); stream lengths that are no multiple of
    16."""
    x = _values(9, 3)
    stream, states, T, decoders = _both_decoders(x, 1, cuda)
    assert 0 < stream.numel() < 16
    for name, fn, plain, table in decoders:
        for lead in (0, 1, 15):
            at = torch.cat([torch.full((lead,), 0xAB, dtype=torch.uint8,
                                       device=cuda), stream])[lead:]
            got = fn(at, states, table, 9, T, instance=instance)
            assert torch.equal(got, plain(stream, states, table, 9, T))
    n, S = 40007, 1024
    x = _values(n, 8, wide=True)
    stream, states, T, decoders = _both_decoders(x, S, cuda)
    for name, fn, plain, table in decoders:
        want = plain(stream, states, table, n, T)
        for lead in (1, 2, 3, 5, 8, 13, 15):
            pad = torch.full((lead,), 0xCD, dtype=torch.uint8, device=cuda)
            at = torch.cat([pad, stream, pad])[lead:lead + stream.numel()]
            assert at.data_ptr() % 16 == lead
            assert torch.equal(fn(at, states, table, n, T,
                                  instance=instance), want), (name, lead)
        for cut in (1, 7, 16, 33):  # the last steps' bytes are missing
            with pytest.raises(ValueError, match="corrupt"):
                fn(stream[: stream.numel() - cut], states, table, n, T,
                   instance=instance)


@pytest.mark.parametrize("instance", ["ring", "global"])
def test_lockstep_truncated_and_corrupt_streams(cuda, instance):
    """Half a stream raises; flipped bytes decode to what the plain
    version decodes from them, or raise where it raises."""
    n, S = 40000, 1024
    x = _values(n, 5, wide=True)
    stream, states, T, decoders = _both_decoders(x, S, cuda)
    rng = np.random.default_rng(1)
    flipped = stream.clone()
    at = torch.from_numpy(rng.integers(0, stream.numel(), 64)).to(cuda)
    flipped[at] ^= 0x5A
    for name, fn, plain, table in decoders:
        with pytest.raises(ValueError, match="corrupt"):
            fn(stream[: stream.numel() // 2].clone(), states, table, n, T,
               instance=instance)
        try:
            want = plain(flipped, states, table, n, T)
        except ValueError:
            with pytest.raises(ValueError, match="corrupt"):
                fn(flipped, states, table, n, T, instance=instance)
        else:
            assert torch.equal(fn(flipped, states, table, n, T,
                                  instance=instance), want), name
        bad_states = states.clone()
        bad_states[::3] = 1 << 23  # every third lane reads too much
        try:
            want = plain(stream, bad_states, table, n, T)
        except ValueError:
            with pytest.raises(ValueError, match="corrupt"):
                fn(stream, bad_states, table, n, T, instance=instance)
        else:
            assert torch.equal(fn(stream, bad_states, table, n, T,
                                  instance=instance), want), name


def test_direct_frame_that_fills_the_block(cuda):
    """M = 2^16 with 5500 live symbols: 219 KB of tables leave the ring
    no room, so the wrapper takes the instance on global loads; forcing
    the ring raises."""
    rng = np.random.default_rng(12)
    sigma, n, S = 5500, 90000, 4096
    nf = np.ones(sigma, np.int64)
    nf += rng.multinomial((1 << 16) - sigma, np.full(sigma, 1 / sigma))
    nf = nf.astype(np.uint64)
    x = rng.choice(sigma, size=n, p=nf / nf.sum()).astype(np.uint32)
    xt = torch.from_numpy(x.view(np.int32)).to(cuda)
    zero = torch.zeros_like(xt)
    enc = tables.to_device(tables.build_enc_table(nf), cuda)
    st = tables.build_search_table(nf)
    stream, states, T = _encode_all(xt, zero, zero, enc, n, S)
    assert tables.direct_fits(st)
    dd = _direct(st, cuda)
    assert decode.choose_instance(
        "decode_direct", tables.direct_table_bytes(st), S,
        dd.NR + dd.NE) == ("global", 0)
    before = dict(decode.instance_launches["decode_direct"])
    got = decode.decode_direct(stream, states, dd, n, T)
    assert decode.instance_launches["decode_direct"] == {
        "ring": before["ring"], "global": before["global"] + 1}
    assert torch.equal(got, lane_codec.decode_direct_plain(stream, states,
                                                           dd, n, T))
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32).reshape(-1)[:n], x)
    with pytest.raises(ValueError, match="does not fit"):
        decode.decode_direct(stream, states, dd, n, T, instance="ring")
    # K3's tables on the same frame are small: it takes the ring
    dec = tables.to_device(st, cuda)
    before = decode.instance_launches["decode_search"]["ring"]
    assert torch.equal(decode.decode_search(stream, states, dec, n, T), got)
    assert decode.instance_launches["decode_search"]["ring"] == before + 1


# --------------------------------------------------------------------------
# the step probe (csrc/op_probe.cu)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("threads", [32, 1024])
@pytest.mark.parametrize("name", sorted(probe.CHAINS))
def test_probe_chain_matches_plain(cuda, name, threads):
    """Every chain's final values equal the plain chain's, exactly."""
    inp = probe.make_inputs(cuda, 1 << 20)
    x = probe.make_x(name, threads, cuda)
    count = probe.launches
    got, clocks = probe.run_kernel(name, x, 2, inp)
    assert probe.launches == count + 1 and clocks > 0
    assert torch.equal(got, probe.run_plain(name, x, 2, inp))
    assert torch.equal(probe.run(name, x, 2, inp), got)


# --------------------------------------------------------------------------
# the byte splitters: K7 (encode), K8 (streamvbyte decode), K9 (vbyte decode)
# --------------------------------------------------------------------------

def _mixed(n, seed):
    """Values of every byte length, 2^28 and 2^31 and above included."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    m = rng.random(n)
    x = np.where(m < .4, x & 0x7F, np.where(m < .6, x & 0x3FFF, np.where(
        m < .75, x & 0xFFFFFF, x))).astype(np.uint32)
    edge = np.array([0, 127, 128, (1 << 14) - 1, 1 << 14, (1 << 21) - 1,
                     1 << 21, (1 << 28) - 1, 1 << 28, 1 << 31, (1 << 32) - 1,
                     255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24],
                    dtype=np.uint32)
    x[: min(n, len(edge))] = edge[:n]
    return x


@pytest.mark.parametrize("n", [1, 3, 100, 1024, 5000, 70001, (1 << 20) + 3])
def test_bytesplit_kernels_match_plain(cuda, n):
    x = torch.from_numpy(_mixed(n, n).view(np.int32)).to(cuda)
    counts = (bytesplit.encode_launches, bytesplit.vbyte_decode_launches,
              bytesplit.svb_decode_launches)
    vb = bytesplit.vbyte_encode(x)
    assert torch.equal(vb, bytesplit.vbyte_encode_plain(x))
    ctrl, data = bytesplit.svb_encode(x)
    pc, pdata = bytesplit.svb_encode_plain(x)
    assert torch.equal(ctrl, pc) and torch.equal(data, pdata)
    got = bytesplit.vbyte_decode(vb, n)
    assert torch.equal(got, bytesplit.vbyte_decode_plain(vb, n))
    assert torch.equal(got, x)
    got = bytesplit.svb_decode(ctrl, data, n)
    assert torch.equal(got, bytesplit.svb_decode_plain(ctrl, data, n))
    assert torch.equal(got, x)
    assert (bytesplit.encode_launches, bytesplit.vbyte_decode_launches,
            bytesplit.svb_decode_launches) == (counts[0] + 2, counts[1] + 1,
                                               counts[2] + 1)
    # a joined stream as the codecs hand it over: the data bytes start at
    # an odd address
    joined = torch.cat([ctrl, data])
    nc = -(-n // 4)
    assert torch.equal(bytesplit.svb_decode(joined[:nc], joined[nc:], n), x)
    # fewer elements than the stream holds: the rest is ignored
    if n > 3:
        assert torch.equal(bytesplit.vbyte_decode(vb, n - 3), x[: n - 3])


def test_bytesplit_corrupt_streams_raise(cuda):
    n = 5000
    x = torch.from_numpy(_mixed(n, 7).view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)
    with pytest.raises(ValueError, match="holds"):
        bytesplit.vbyte_decode(vb[:-1].clone(), n)
    with pytest.raises(ValueError, match="holds"):
        bytesplit.vbyte_decode(vb, n + 1)
    bad = torch.cat([vb[:100], torch.full((5,), 0x80, dtype=torch.uint8,
                                          device=cuda), vb[100:]])
    with pytest.raises(ValueError, match="longer than 5"):
        bytesplit.vbyte_decode(bad, n)
    ctrl, data = bytesplit.svb_encode(x)
    with pytest.raises(ValueError, match="corrupt"):
        bytesplit.svb_decode(ctrl, data[:-1].clone(), n)
    with pytest.raises(ValueError, match="corrupt"):
        bytesplit.svb_decode(ctrl[:-1].clone(), data, n)
    with pytest.raises(ValueError, match="empty"):
        bytesplit.vbyte_encode(x[:0])


@pytest.mark.parametrize("name", ["vbyte", "streamvbyte", "vbyteANS",
                                  "streamvbyteANS"])
def test_byte_codecs_on_card_equal_cpu(cuda, name):
    """The card's blobs equal the CPU path's (which the CPU tests hold
    equal to ans_tpu's), both decode both, and the composites' decoder
    takes the rule's engine."""
    from ans_tpu_torch import models
    x = _mixed(70001, 11)
    on_card = models.get(name, device=cuda)
    on_cpu = models.get(name, device="cpu")
    blob = on_card.encode(x)
    assert blob == on_cpu.encode(x)
    np.testing.assert_array_equal(on_card.decode(blob, len(x)), x)
    np.testing.assert_array_equal(on_cpu.decode(blob, len(x)), x)


# K7 and K9 as chained scans with decoupled look-back: chunks of
# bytesplit.ENCODE_CHUNK elements for K7 and DECODE_CHUNK stream bytes for
# K9, cut at 16-byte boundaries of the address space

def _at(stream: torch.Tensor, mis: int) -> torch.Tensor:
    """A copy of the stream whose first byte lies `mis` bytes past a 16-byte
    boundary."""
    pad = torch.zeros(mis + stream.numel() + 16, dtype=torch.uint8,
                      device=stream.device)
    skip = (mis - pad.data_ptr()) % 16
    out = pad[skip: skip + stream.numel()]
    out.copy_(stream)
    assert out.data_ptr() % 16 == mis
    return out


def _vb_decode_counted(data, n):
    before = bytesplit.vbyte_decode_launches
    try:
        return bytesplit.vbyte_decode(data, n)
    finally:
        assert bytesplit.vbyte_decode_launches == before + 1


C = bytesplit.ENCODE_CHUNK
D = bytesplit.DECODE_CHUNK


@pytest.mark.parametrize("n", [C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1,
                               3 * C + 5])
def test_bytesplit_encode_at_chunk_edges(cuda, n):
    """K7, both formats, at chunk multiples +-1: one launch a call."""
    x = torch.from_numpy(_mixed(n, n + 1).view(np.int32)).to(cuda)
    before = bytesplit.encode_launches
    assert torch.equal(bytesplit.vbyte_encode(x),
                       bytesplit.vbyte_encode_plain(x))
    ctrl, data = bytesplit.svb_encode(x)
    pc, pdata = bytesplit.svb_encode_plain(x)
    assert torch.equal(ctrl, pc) and torch.equal(data, pdata)
    assert bytesplit.encode_launches == before + 2


@pytest.mark.parametrize("length", [D - 1, D, D + 1, 2 * D - 1, 2 * D,
                                    2 * D + 1])
@pytest.mark.parametrize("mis", [0, 1, 15])
def test_vbyte_decode_at_chunk_edges(cuda, length, mis):
    """K9 on streams of chunk multiples +-1 bytes at 16-byte boundaries and
    off them, one-byte and longer elements mixed."""
    rng = np.random.default_rng(length + mis)
    x = torch.from_numpy(_mixed(length, length).view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)[:length]
    n = int((vb < 0x80).sum())
    vb = _at(vb, mis)
    want = bytesplit.vbyte_decode_plain(vb, n)
    assert torch.equal(_vb_decode_counted(vb, n), want)
    k = int(rng.integers(1, n + 1))
    assert torch.equal(_vb_decode_counted(vb, k), want[:k])


@pytest.mark.parametrize("mis", [0, 1, 7, 8, 15])
def test_vbyte_five_byte_element_ending_a_chunk_boundary(cuda, mis):
    """A 5-byte element whose terminator is the first byte of a chunk: its
    four continuation bytes lie in the chunk before, read from the halo."""
    first = D - mis  # the stream position of chunk 1's first byte
    vals = np.concatenate([np.arange(first - 4) % 128,
                           [(1 << 32) - 1 - mis],
                           _mixed(3000, mis)]).astype(np.uint32)
    x = torch.from_numpy(vals.view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)
    assert int(vb[first]) < 0x80 and bool((vb[first - 4: first] >= 0x80).all())
    got = _vb_decode_counted(_at(vb, mis), len(vals))
    assert torch.equal(got, x)


@pytest.mark.parametrize("split", [0, 1, 3, 5])
def test_vbyte_six_byte_element_across_a_chunk_boundary(cuda, split):
    """A 6-byte element with `split` of its bytes before the first chunk
    boundary (5: its terminator is chunk 1's first byte) raises flag bit 1
    when it is among the first n elements, and is not read when it lies
    past them."""
    head = np.full(D - split, 5, np.uint8)  # one-byte elements
    bad = np.array([0x80] * 5 + [1], np.uint8)
    vb = torch.from_numpy(np.concatenate([head, bad, np.full(100, 7,
                                                             np.uint8)]))
    vb = _at(vb.to(cuda), 0)
    for n in (len(head) + 1, len(head) + 50):
        with pytest.raises(ValueError, match="longer than 5"):
            _vb_decode_counted(vb, n)
    got = _vb_decode_counted(vb, len(head))
    assert torch.equal(got, bytesplit.vbyte_decode_plain(vb, len(head)))


def test_bytesplit_look_back_past_one_window(cuda):
    """n = 2^22 + 5: K7 over 1025 chunks and K9 over about as many, so that
    the look-back can walk more than one window (32 LOOK status words: 64,
    or 256 at K2's width); the same output on five repeated calls (the
    status words are zeroed every call)."""
    n = (1 << 22) + 5
    x = torch.from_numpy(_mixed(n, 22).view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)
    assert torch.equal(vb, bytesplit.vbyte_encode_plain(x))
    ctrl, data = bytesplit.svb_encode(x)
    pc, pdata = bytesplit.svb_encode_plain(x)
    assert torch.equal(ctrl, pc) and torch.equal(data, pdata)
    assert bytesplit.encode_chunks(n) > 32 * 8
    assert bytesplit.decode_chunks(vb.numel(), vb.data_ptr()) > 32 * 8
    assert torch.equal(_vb_decode_counted(vb, n), x)
    for _ in range(5):
        assert torch.equal(bytesplit.vbyte_encode(x), vb)
        again = bytesplit.svb_encode(x)
        assert torch.equal(again[0], ctrl) and torch.equal(again[1], data)
        assert torch.equal(_vb_decode_counted(vb, n), x)


@pytest.mark.parametrize("mis", range(1, 16, 2))
def test_vbyte_decode_at_odd_addresses(cuda, mis):
    """A vbyte stream sliced at an odd address, as the codecs hand a joined
    stream over: byte loads at the head and tail, 16-byte loads between."""
    n = 70001
    x = torch.from_numpy(_mixed(n, mis).view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)
    joined = torch.cat([vb.new_full((mis,), 0x80), vb])
    assert joined[mis:].data_ptr() % 16 == mis
    assert torch.equal(_vb_decode_counted(joined[mis:], n), x)
    assert torch.equal(_vb_decode_counted(_at(vb, mis), n - 7), x[:-7])


def test_vbyte_decode_more_and_fewer_elements_than_n(cuda):
    """More elements than n: the first n, the rest not read (a corrupt
    element among them raises nothing); fewer: ValueError naming the
    count."""
    n = 3 * D + 11
    x = torch.from_numpy(_mixed(n, 5).view(np.int32)).to(cuda)
    vb = bytesplit.vbyte_encode(x)
    longer = torch.cat([vb, vb.new_full((9,), 0x80), vb.new_ones(1)])
    for k in (1, D - 1, D, n):
        assert torch.equal(_vb_decode_counted(longer, k), x[:k])
    with pytest.raises(ValueError, match=f"holds {n} elements, caller asked "
                                         f"for {n + 2}"):
        _vb_decode_counted(vb, n + 2)
    with pytest.raises(ValueError, match=f"holds {n + 1} elements"):
        _vb_decode_counted(longer, n + 5)


# K8 as a chained scan with decoupled look-back: chunks of
# bytesplit.SVB_CHUNK elements, the data staged as aligned 16-byte granules

V = bytesplit.SVB_CHUNK


def _svb_decode_counted(control, data, n):
    before = bytesplit.svb_decode_launches
    try:
        return bytesplit.svb_decode(control, data, n)
    finally:
        assert bytesplit.svb_decode_launches == before + 1


def _svb_checked(control, data, n):
    """K8 (one launch) held against its plain version."""
    got = _svb_decode_counted(control, data, n)
    assert torch.equal(got, bytesplit.svb_decode_plain(control, data, n))
    return got


@pytest.mark.parametrize("n", [V - 1, V, V + 1, V + 2, 2 * V - 3, 2 * V,
                               3 * V + 1])
def test_svb_decode_at_chunk_edges(cuda, n):
    """K8 at chunk multiples +-1 and with a partial last control byte; and
    three elements fewer than the stream holds, so that the last control
    byte's keys past n are not counted."""
    x = torch.from_numpy(_mixed(n, n + 2).view(np.int32)).to(cuda)
    ctrl, data = bytesplit.svb_encode(x)
    assert torch.equal(_svb_checked(ctrl, data, n), x)
    assert torch.equal(_svb_checked(ctrl, data, n - 3), x[: n - 3])


@pytest.mark.parametrize("mis", range(1, 16))
def test_svb_decode_at_misaligned_addresses(cuda, mis):
    """Control bytes, data bytes and both at addresses 1-15 past a 16-byte
    boundary: the data's first and last granules take byte loads."""
    n = 3 * V + 7
    x = torch.from_numpy(_mixed(n, mis).view(np.int32)).to(cuda)
    ctrl, data = bytesplit.svb_encode(x)
    for c, d in ((_at(ctrl, mis), data), (ctrl, _at(data, mis)),
                 (_at(ctrl, mis), _at(data, 16 - mis))):
        assert torch.equal(_svb_checked(c, d, n), x)


def test_svb_decode_look_back_past_one_window(cuda):
    """n = 2^20 + 3: 257 chunks, past one look-back window (64 chunks at two
    status words a lane, 256 at eight); the same values on five repeated
    calls (the status words are zeroed every call)."""
    n = (1 << 20) + 3
    x = torch.from_numpy(_mixed(n, 20).view(np.int32)).to(cuda)
    ctrl, data = bytesplit.svb_encode(x)
    assert bytesplit.svb_chunks(n) > 32 * 8
    assert torch.equal(_svb_checked(ctrl, data, n), x)
    for _ in range(5):
        assert torch.equal(_svb_decode_counted(ctrl, data, n), x)


@pytest.mark.parametrize("n", [5, V - 1, V + 1, 2 * V + 5])
def test_svb_decode_short_streams_raise(cuda, n):
    """Data one byte short raises from the data length the kernel writes;
    control bytes one short, and no data at all, raise before a launch."""
    x = torch.from_numpy(_mixed(n, n).view(np.int32)).to(cuda)
    ctrl, data = bytesplit.svb_encode(x)
    with pytest.raises(ValueError, match="passes the end of the data bytes"):
        _svb_decode_counted(ctrl, data[:-1].clone(), n)
    before = bytesplit.svb_decode_launches
    with pytest.raises(ValueError, match="too few control bytes"):
        bytesplit.svb_decode(ctrl[:-1].clone(), data, n)
    with pytest.raises(ValueError, match="passes the end of the data bytes"):
        bytesplit.svb_decode(ctrl, data[:0], n)
    assert bytesplit.svb_decode_launches == before


@pytest.mark.parametrize("length", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [V, 2 * V, 2 * V + 1])
def test_svb_every_length_at_a_chunks_last_element(cuda, length, n):
    """A chunk's last element (and the stream's) 1-4 bytes long behind
    elements of every length: its bytes end the chunk's data range."""
    vals = _mixed(n, 10 * n + length)
    big = np.uint32({1: 0x7F, 2: 0xABCD, 3: 0xABCDEF, 4: 0xFEDCBA98}[length])
    vals[V - 1::V] = big
    vals[-1] = big
    x = torch.from_numpy(vals.view(np.int32)).to(cuda)
    ctrl, data = bytesplit.svb_encode(x)
    assert torch.equal(_svb_checked(ctrl, data, n), x)


# --------------------------------------------------------------------------
# the batched kernels: D streams of one model in one launch of K1/K6, K2
# and K3/K4/K5 (the sections of a blocked container)
# --------------------------------------------------------------------------

def _batch_lengths(D, T, S, seed):
    """D stream lengths of at most T * S positions: unequal, the first
    full, one empty (from D = 2 on), one a single position (from D = 3)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, T * S + 1, size=D)
    n[0] = T * S
    if D >= 2:
        n[D // 2] = 0
    if D >= 3:
        n[-1] = 1
    return n.astype(np.int64)


def _batch_stage(kind, D, T, S, cuda, seed=0):
    """(enc, dec tables, (D, T, S) staged inputs, n (D,) i64, values):
    kind "fold" (fold-2 on zipf values with exception bytes, K1/K3/K4) or
    "grouped" (fold-7 over 2^20-value data, K6 with its in-kernel rank
    map, K5)."""
    n = _batch_lengths(D, T, S, seed)
    total = int(n.sum())
    # the model's values: the batch's first, then more (a frame with more
    # than 2^13 live symbols for the grouped kind whatever the batch)
    size = max(total, 60000)
    if kind == "fold":
        x = _values(size, seed, wide=True)
        fidelity = 2
    else:
        x = np.random.default_rng(seed + 1).integers(
            0, 1 << 15, size=size).astype(np.uint32)
        fidelity = 7
    codec = AnsFold(fidelity, device=cuda)
    mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(x)
    enc, _ = _stage(mapped, k, low, len(x), ffreqs, raw, S)
    assert isinstance(enc, tables.GroupedEncDevice) == (kind == "grouped")
    dec = codec._table(pfreqs)
    staged = []
    starts = np.concatenate(([0], np.cumsum(n)))
    for t in (mapped, k, low):
        out = torch.zeros((D, T * S), dtype=torch.int32, device=cuda)
        for d in range(D):
            out[d, :n[d]] = t[starts[d]:starts[d + 1]]
        staged.append(out.reshape(D, T, S))
    return (enc, dec, staged, torch.from_numpy(n).to(cuda), x[:total],
            starts)


def _valid(out, n):
    """The decoded values of each stream, one after the other (host)."""
    flat = out.reshape(out.shape[0], -1)
    return torch.cat([flat[d, :int(nd)] for d, nd in enumerate(
        n.tolist())]).cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["fold", "grouped"])
@pytest.mark.parametrize("D,S,T", [(1, 4096, 6), (2, 32, 70), (3, 16384, 2),
                                   (8, 4096, 5), (8, 32, 40),
                                   (133, 4096, 3), (133, 32, 9)])
def test_batched_kernels_match_plain(cuda, kind, D, S, T):
    """K1 or K6, K2 and the decodes (K3 and K4, or K5; each in both
    instances) on a batch of D streams of unequal length, one of them
    empty, against the batched plain versions, one launch each; the
    batch decodes to its input; K2's chain runs across the streams (at
    D = 133, S = 32 over a thousand chunks)."""
    enc, dec, (m, nb, ex), n, x, _ = _batch_stage(kind, D, T, S, cuda, D)
    scan, scan_plain = ((encode.encode_scan_grouped_batch,
                         lane_codec.encode_scan_grouped_batch_plain)
                        if kind == "grouped" else
                        (encode.encode_scan_batch,
                         lane_codec.encode_scan_batch_plain))
    counts = (encode.launches + encode.grouped_launches, place.launches)
    packed, states = scan(m, n, enc)
    pp, ps = scan_plain(m, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    stream, offsets, ends = place.place_batch(packed, nb, ex, n)
    ws, wo = lane_codec.place_batch_plain(packed, nb, ex, n)
    assert torch.equal(stream, ws) and torch.equal(offsets.cpu(), wo.cpu())
    np.testing.assert_array_equal(ends, wo[:, T].cpu().numpy())
    assert (encode.launches + encode.grouped_launches, place.launches) == (
        counts[0] + 1, counts[1] + 1)
    # the same bytes on a repeated run, the ends checked
    assert torch.equal(place.place_batch(packed, nb, ex, n, ends)[0], stream)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, T]]).contiguous()
    engines = (("grouped", decode.decode_grouped_batch,
                lane_codec.decode_grouped_batch_plain),) if kind == "grouped" \
        else (("search", decode.decode_search_batch,
               lane_codec.decode_search_batch_plain),
              ("direct", decode.decode_direct_batch,
               lane_codec.decode_direct_batch_plain))
    for name, kernel, plain in engines:
        tab = tables.to_device(tables.materialize_slots(dec)
                               if name == "direct" else dec, cuda)
        want = plain(stream, stream_off, states, n, tab, T)
        for instance in (None, "global"):
            before = (decode.launches + decode.direct_launches
                      + decode.grouped_launches)
            out = kernel(stream, stream_off, states, n, tab, T,
                         instance=instance)
            assert (decode.launches + decode.direct_launches
                    + decode.grouped_launches) == before + 1
            got = _valid(out, n)
            np.testing.assert_array_equal(got, _valid(want, n))
            np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("engine_name", ["search", "direct"])
def test_batch_of_one_is_the_one_stream_kernel(cuda, engine_name):
    """The one-stream wrappers are the batch of one: the same words, bytes
    and values, one launch each."""
    enc, dec, (m, nb, ex), n, x, _ = _batch_stage("fold", 1, 9, 4096, cuda)
    n1 = int(n[0])
    packed, states = encode.encode_scan(m[0], n1, enc)
    bp, bs = encode.encode_scan_batch(m, n, enc)
    assert torch.equal(packed, bp[0]) and torch.equal(states, bs[0])
    stream, step_base, total = place.place(packed, nb[0], ex[0], n1)
    s2, off, ends = place.place_batch(bp, nb, ex, n)
    assert torch.equal(stream, s2) and total == int(ends[0])
    assert torch.equal(step_base, off[0, :-1])
    tab = tables.to_device(tables.materialize_slots(dec)
                           if engine_name == "direct" else dec, cuda)
    one = {"search": decode.decode_search,
           "direct": decode.decode_direct}[engine_name]
    batch = {"search": decode.decode_search_batch,
             "direct": decode.decode_direct_batch}[engine_name]
    out = one(stream, states, tab, n1, 9)
    stream_off = torch.tensor([0, total], dtype=torch.int64, device=cuda)
    assert torch.equal(out, batch(stream, stream_off, bs, n, tab, 9)[0])
    np.testing.assert_array_equal(_valid(out[None], n), x)


def test_batch_of_empty_streams(cuda):
    """A batch whose streams are all empty writes no byte and decodes to
    nothing; a truncated stream in a batch raises."""
    enc, dec, (m, nb, ex), n, x, starts = _batch_stage("fold", 4, 6, 32,
                                                        cuda, 3)
    zero = torch.zeros_like(n)
    packed, states = encode.encode_scan_batch(m, zero, enc)
    stream, offsets, ends = place.place_batch(packed, nb, ex, zero)
    assert stream.numel() == 0 and not ends.any()
    tab = tables.to_device(dec, cuda)
    stream_off = torch.zeros(5, dtype=torch.int64, device=cuda)
    out = decode.decode_search_batch(stream, stream_off, states, zero, tab,
                                     6)
    assert _valid(out, zero).size == 0
    packed, states = encode.encode_scan_batch(m, n, enc)
    stream, offsets, _ = place.place_batch(packed, nb, ex, n)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, 6]]).contiguous()
    cut = stream_off.clone()
    # stream 0 one byte short of its end (the later streams keep their
    # lengths and start a byte early)
    cut[1:] -= 1
    cut[0] = 0
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_search_batch(stream, cut, states, n, tab, 6)


@pytest.mark.parametrize("kind,engine_name", [("fold", "search"),
                                              ("fold", "direct"),
                                              ("grouped", "grouped")])
@pytest.mark.parametrize("instance", [None, "global"])
def test_batch_later_stream_truncated_raises(cuda, kind, engine_name,
                                             instance):
    """A batch whose last stream with bytes, not stream 0, is one byte
    short raises: that stream's block checks its reads against its own
    end, in the instance the wrapper picks and on global loads.  The
    intact batch decodes to its input."""
    enc, dec, (m, nb, ex), n, x, _ = _batch_stage(kind, 4, 6, 32, cuda, 3)
    scan = (encode.encode_scan_grouped_batch if kind == "grouped"
            else encode.encode_scan_batch)
    packed, states = scan(m, n, enc)
    stream, offsets, _ = place.place_batch(packed, nb, ex, n)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, 6]]).contiguous()
    lens = torch.diff(stream_off).tolist()
    d = max(i for i, length in enumerate(lens) if length > 0)
    assert d > 0
    tab = tables.to_device(tables.materialize_slots(dec)
                           if engine_name == "direct" else dec, cuda)
    kernel = {"search": decode.decode_search_batch,
              "direct": decode.decode_direct_batch,
              "grouped": decode.decode_grouped_batch}[engine_name]
    np.testing.assert_array_equal(_valid(kernel(
        stream, stream_off, states, n, tab, 6, instance=instance), n), x)
    cut = stream_off.clone()
    cut[d + 1:] -= 1  # stream d one byte short; the streams after it empty
    with pytest.raises(ValueError, match="corrupt"):
        kernel(stream, cut, states, n, tab, 6, instance=instance)


@pytest.mark.parametrize("method", ["ANSfold-2", "ANSfold-7", "ANSmsb", "ANS",
                                    "ANSrfold-2"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_blocked_on_card_equals_cpu(cuda, method, D):
    """BlockCodec on the card writes the container the CPU's plain
    versions write, decodes it exactly, and each call is one scan, one
    placement and one decode launch."""
    from ans_tpu_torch.parallel import BlockCodec
    rng = np.random.default_rng(D)
    x = (rng.zipf(1.2, size=30000) - 1).clip(0, (1 << 20) - 1).astype(
        np.uint32)
    if method == "ANS":
        x = x % 5000
    want = BlockCodec(method, D, 128, device="cpu").encode(x)
    codec = BlockCodec(method, D, 128, device=cuda)
    counts = (encode.launches + encode.grouped_launches, place.launches,
              decode.launches + decode.direct_launches
              + decode.grouped_launches)
    blob = codec.encode(x)
    assert blob == want
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
    assert (encode.launches + encode.grouped_launches, place.launches,
            decode.launches + decode.direct_launches
            + decode.grouped_launches) == tuple(c + 1 for c in counts)
    pe = codec.prepare_encoder(x)
    assert pe.to_bytes(*pe()) == want


# --------------------------------------------------------------------------
# the batched kernels over streams with a model each: K1/K6, K2 and K3/K4/K5
# on a ModelBatch (ops/model_batch.py; the blocks of a pseudo-adaptive
# container), and PseudoAdaptive on the card
# --------------------------------------------------------------------------

def _ranks(v):
    return np.searchsorted(np.unique(v), v).astype(np.uint32)


def _model_streams(route):
    """Streams of one scan table kind, each with its own model, of unequal
    length and frames of different log2m, renorm rounds (NR 2 and 3) and
    exception rounds: a list of (values, host decode table, scan table on
    the CPU, syms, nb, excw)."""
    from ans_tpu_torch.inputs import zipf_sample
    from ans_tpu_torch.models.ans import AnsMsb, scan_table, to_ranks
    z125 = zipf_sample(np.random.default_rng(42), 1 << 17, 1 << 28,
                       1.25) - 1
    z20 = zipf_sample(np.random.default_rng(0), 1 << 17, 1 << 20)
    if route == "value":
        inputs = [(AnsInt, _ranks(z125[:1 << 13])),   # log2m 13
                  (AnsInt, _ranks(z125[:1 << 16])),   # escape, 16
                  (AnsInt, _ranks(z125)),             # escape, 17: NR 3
                  (AnsMsb, z125[:5000])]              # msb, 12
    else:
        from ans_tpu_torch.inputs import dense_input
        inputs = [(AnsInt, _ranks(z20[:1 << 16])),    # escape, 16
                  (AnsInt, _ranks(z20)),              # escape, 17: NR 3
                  (AnsInt, np.random.default_rng(1).integers(
                      0, 9000, size=1 << 15).astype(np.uint32)),  # raw
                  (AnsInt, dense_input(1 << 14))]     # raw, 14
    out = []
    for cls, v in inputs:
        codec = cls(lanes=32, device="cpu")
        mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(v)
        table, rank_of = scan_table(ffreqs, raw, "cpu")
        out.append((v, codec._table(pfreqs), table,
                    to_ranks(mapped, rank_of), k, low))
    return out


@pytest.mark.parametrize("route", ["value", "grouped"])
@pytest.mark.parametrize("S", [32, 4096])
def test_per_model_batched_kernels_match_plain(cuda, route, S):
    """K1 or K6, K2 and the decodes (K3 and K4, or K5 and K4; each in
    both instances) over a ModelBatch of streams with a model each (frames
    of log2m 12 to 17, NR 2 and 3, exception bytes or none, K6's streams
    fed symbol ids or ranks, K5's with and without a per-rank table),
    against the batched plain versions on the same batch, one launch each;
    the batch decodes to its input."""
    from ans_tpu_torch.ops import model_batch
    streams = _model_streams(route)
    D = len(streams)
    n_np = np.array([len(s[0]) for s in streams], np.int64)
    T = int(max(lane_codec.lane_steps(int(k), S) for k in n_np))
    staged = []
    for i in (3, 4, 5):
        t = torch.zeros((D, T * S), dtype=torch.int32)
        for d, s in enumerate(streams):
            t[d, :len(s[0])] = s[i]
        staged.append(t.reshape(D, T, S).to(cuda))
    m, nb, ex = staged
    n = torch.from_numpy(n_np).to(cuda)
    enc = model_batch.stack([s[2] for s in streams], cuda)
    assert len(set(enc.column("log2m").tolist())) == D
    grouped = route == "grouped"
    scan, plain = ((encode.encode_scan_grouped_batch,
                    lane_codec.encode_scan_grouped_batch_plain) if grouped
                   else (encode.encode_scan_batch,
                         lane_codec.encode_scan_batch_plain))
    before = encode.grouped_launches if grouped else encode.launches
    packed, states = scan(m, n, enc)
    assert (encode.grouped_launches if grouped
            else encode.launches) == before + 1
    pp, ps = plain(m, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    stream, offsets, ends = place.place_batch(packed, nb, ex, n)
    ws, wo = lane_codec.place_batch_plain(packed, nb, ex, n)
    assert torch.equal(stream, ws) and torch.equal(offsets, wo)
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, T]]).contiguous()
    engines = ("grouped", "direct") if grouped else ("search", "direct")
    kernels = {"search": (decode.decode_search_batch,
                          lane_codec.decode_search_batch_plain),
               "direct": (decode.decode_direct_batch,
                          lane_codec.decode_direct_batch_plain),
               "grouped": (decode.decode_grouped_batch,
                           lane_codec.decode_grouped_batch_plain)}
    for engine_name in engines:
        keep = [d for d, s in enumerate(streams)
                if engine_name != "direct" or tables.direct_fits(s[1])]
        assert len(keep) >= 2
        sel = torch.tensor(keep, device=cuda)
        part = torch.cat([stream[int(stream_off[d]):int(stream_off[d + 1])]
                          for d in keep])
        off = torch.cat([torch.zeros(1, dtype=torch.int64, device=cuda),
                         torch.cumsum(stream_off[sel + 1] - stream_off[sel],
                                      0)])
        dec = model_batch.stack([engine.dec_device_table(
            streams[d][1], engine_name, "cpu") for d in keep], cuda)
        if engine_name != "direct":
            assert set(dec.column("NR").tolist()) == {2, 3}
        kernel, plain_batch = kernels[engine_name]
        want = plain_batch(part, off, states[sel], n[sel], dec, T)
        for instance in (None, "global"):
            got = kernel(part, off, states[sel], n[sel], dec, T,
                         instance=instance)
            np.testing.assert_array_equal(_valid(got, n[sel]),
                                          _valid(want, n[sel]))
        for d, i in enumerate(keep):
            vals = got[d].reshape(-1)[:len(streams[i][0])].cpu().numpy()
            np.testing.assert_array_equal(vals.view(np.uint32),
                                          streams[i][0])


@pytest.mark.parametrize("bs,kind,lanes,eng", [
    (4096, "msb", 32, "lane"), (4096, "int", None, "lane"),
    (1 << 16, "int", 32, "auto"), (1 << 16, "msb", 4096, "auto")])
def test_pseudo_adaptive_on_card_equals_cpu(cuda, bs, kind, lanes, eng):
    """PseudoAdaptive on the card writes the container the CPU's plain
    versions write (single-symbol blocks, a ragged last block, blocks of
    the escape onto the grouped layout and onto value order among them),
    decodes it exactly, and each encode is one scan launch and one
    placement launch per scan batch, each decode one decode launch per
    decode batch."""
    from ans_tpu_torch.inputs import zipf_sample
    from ans_tpu_torch.models.pseudo_adaptive import (PseudoAdaptive,
                                                      _encode_batches)
    z20 = zipf_sample(np.random.default_rng(0), 3 << 16, 1 << 20)
    x = np.concatenate([np.full(bs, 77, np.uint32), z20,
                        zipf_sample(np.random.default_rng(42), 1 << 16,
                                    1 << 28, 1.25) - 1, z20[:5000]])
    want = PseudoAdaptive(bs, kind, lanes, eng, device="cpu").encode(x)
    codec = PseudoAdaptive(bs, kind, lanes, eng, device=cuda)
    _, blocks = codec._stage(x)
    nbatch = len(_encode_batches(blocks, "cpu"))
    counts = (encode.launches + encode.grouped_launches, place.launches,
              decode.launches + decode.direct_launches
              + decode.grouped_launches)
    blob = codec.encode(x)
    assert blob == want
    pd = codec.prepare_decoder(blob)
    np.testing.assert_array_equal(codec.decode(blob), x)
    assert (encode.launches + encode.grouped_launches, place.launches,
            decode.launches + decode.direct_launches
            + decode.grouped_launches) == (counts[0] + nbatch,
                                           counts[1] + nbatch,
                                           counts[2] + len(pd.batches))
    np.testing.assert_array_equal(pd.to_host(pd()), x)
    pe = codec.prepare_encoder(x)
    assert pe.to_bytes(pe()) == want


def test_pseudo_golden_containers_on_card(cuda):
    """The committed ATFP containers written by ans_tpu (pseudo.json)
    re-encode to the same bytes on the card and decode exactly."""
    from ans_tpu_torch.models.pseudo_adaptive import PseudoAdaptive
    recs = json.loads((LANE_FIXTURES / "pseudo.json").read_text())
    for rec in recs:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        codec = PseudoAdaptive(rec["block_size"], rec["kind"], rec["lanes"],
                               rec["engine"], device=cuda)
        assert codec.encode(x) == blob
        np.testing.assert_array_equal(codec.decode(blob), x)


@pytest.mark.parametrize("method,engine", [
    ("ANSfold-2", "lane"), ("ANS", "lane"), ("ANSmsb", "lane"),
    ("vbyteANS", "lane"), ("streamvbyteANS", "lane"),
    ("pseudo_adaptive", "lane"), ("ANSfold-2", "compat")])
def test_container_on_card_equals_cpu(cuda, method, engine):
    """The ATFC file written on the card equals the CPU's, and each
    device decodes it exactly."""
    from ans_tpu_torch import container
    x = _values(30000, 11) % (1 << 20)
    want = container.compress(x, method, engine, device="cpu")
    got = container.compress(x, method, engine, device=cuda)
    assert got == want
    np.testing.assert_array_equal(container.decompress(got, device=cuda), x)


def test_cli_roundtrip_on_card(cuda, tmp_path, capsys):
    """python -m ans_tpu_torch on the card (its default device): the ATFC
    and the blocked file equal the CPU's, the kernels run, and decompress
    gives the input back."""
    from ans_tpu_torch.__main__ import main as cli
    x = _values(50000, 12)
    src = tmp_path / "in.u32"
    x.astype("<u4").tofile(src)
    for extra in ([], ["--blocked", "-D", "3"], ["-m", "ANSmsb", "-S", "32"]):
        out, ref, dst = (tmp_path / "card.bin", tmp_path / "cpu.bin",
                         tmp_path / "out.u32")
        k1, k2 = encode.launches, place.launches
        assert cli(["compress", str(src), str(out), *extra]) == 0
        assert (encode.launches, place.launches) == (k1 + 1, k2 + 1)
        assert cli(["compress", str(src), str(ref), *extra, "--device",
                    "cpu"]) == 0
        assert out.read_bytes() == ref.read_bytes()
        assert cli(["info", str(out)]) == 0
        assert cli(["decompress", str(out), str(dst)]) == 0
        np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), x)
    capsys.readouterr()


# the host-entropy composites: K7 splits on the card, the split stream
# crosses to the host once, the host library codes it, and K9 / K8 join
# the decoded stream on the card

HOST_COMPOSITES = {"vbytefse": "vbyte_decode_launches",
                   "streamvbytefse": "svb_decode_launches",
                   "vbytehuffzero": "vbyte_decode_launches",
                   "streamvbytehuffzero": "svb_decode_launches"}


@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("n", [C - 1, C + 1, D - 1, D, D + 1, 2 * D + 1,
                               bytesplit.SVB_CHUNK * 3 + 2])
@pytest.mark.parametrize("name", sorted(HOST_COMPOSITES))
def test_host_composites_on_card_equal_cpu(cuda, name, n, small):
    """At split lengths around the K7 / K8 / K9 chunk multiples (one-byte
    values: the vbyte stream is n bytes long), and on values of every
    byte length: the card's blob equals the CPU path's (held to ans_tpu's
    by the CPU tests), both decode it, and each card call is one K7 launch
    on encode and one K9 / K8 launch on decode."""
    from ans_tpu_torch import models
    x = _mixed(n, n + 3) & (0x7F if small else 0xFFFFFFFF)
    counter = HOST_COMPOSITES[name]
    k7, dec = bytesplit.encode_launches, getattr(bytesplit, counter)
    on_card = models.get(name, device=cuda)
    blob = on_card.encode(x)
    assert bytesplit.encode_launches == k7 + 1
    if small and name.startswith("vbyte"):
        assert int.from_bytes(blob[:4], "little") == n
    on_cpu = models.get(name, device="cpu")
    assert blob == on_cpu.encode(x)
    np.testing.assert_array_equal(on_card.decode(blob, len(x)), x)
    assert getattr(bytesplit, counter) == dec + 1
    np.testing.assert_array_equal(on_cpu.decode(blob, len(x)), x)


def test_benchmark_driver_on_card(cuda, tmp_path, capsys):
    """python -m ans_tpu_torch.drivers.benchmark on its default device:
    every round trip it asserts passes, its lines equal the CPU run's but
    for the time columns, and K1, K2, K7 and the decode kernels ran."""
    from ans_tpu_torch.drivers import benchmark
    src = tmp_path / "zipf.u32"
    _values(40000, 13).astype("<u4").tofile(src)
    argv = ["-i", str(src), "--runs", "1", "--methods",
            "ANSfold-2,vbyteANS,vbytefse,streamvbytehuffzero,shuff,arith"]
    k1, k2, k7 = encode.launches, place.launches, bytesplit.encode_launches
    benchmark.main(argv)
    card = capsys.readouterr().out.splitlines()
    assert encode.launches > k1 and place.launches > k2
    assert bytesplit.encode_launches > k7
    benchmark.main([*argv, "--device", "cpu"])
    cpu = capsys.readouterr().out.splitlines()
    assert len(card) == len(cpu) == 6
    for a, b in zip(card, cpu):
        assert a.split("\t\t")[:-3] == b.split("\t\t")[:-3]
