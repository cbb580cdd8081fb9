"""K3's plain version (lane_codec.decode_search_plain) against the Pallas
pivot-search decode run in interpret mode: whole (T, S) outputs, for
fold tables, three renorm rounds, a single-symbol alphabet, a ragged
tail and several sections; and corrupt streams must raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.models import framing as jframing
from ans_tpu.models.ans import AnsFold, AnsInt
from ans_tpu.ops import lane_codec as jlc
from ans_tpu.ops import pallas_decode
from ans_tpu.ops import tables as jtables
from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import adjust_freqs, load_prelude
from ans_tpu_torch.ops import decode, tables


def _zipf(n, seed=5, clip=1 << 27):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, size=n) - 1).clip(0, clip).astype(np.uint32)


def _fold_stream(values, S, fidelity, cap_bytes=3 << 20):
    """XLA-engine encode (any section cap) + the fold search table."""
    mapped = map_np.fold_map(values, fidelity)
    k, b = map_np.fold_exceptions(values, fidelity)
    freqs = np.bincount(mapped).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, len(freqs) - 1, True, 1)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    st = jtables.build_search_table(
        nfreqs, *map_np.fold_unmap_high(syms, fidelity))
    return _encode(mapped, k, b, nfreqs, S, cap_bytes) + (st,)


def _encode(mapped, k, b, nfreqs, S, cap_bytes=3 << 20):
    et = jtables.build_enc_table(nfreqs)
    n = len(mapped)
    T = jlc.lane_steps(n, S)
    pad = T * S - n
    stream, total, states, sb = jlc.encode_lanes(
        jnp.asarray(np.pad(mapped, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(k, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    total = int(total)
    t_sec, sec_len = jframing.choose_sections(np.asarray(sb), total, T,
                                              cap_bytes=cap_bytes)
    return (np.array(stream[:total]), np.array(states), t_sec, sec_len, n,
            T)


def _blob_stream(codec, values, st_of):
    blob = codec.encode(values)
    nfreqs, plen = load_prelude(blob)
    S, states, payload, t_sec, sec_len = jframing.parse(blob, plen)
    return (np.array(payload), states, t_sec, sec_len, len(values),
            jlc.lane_steps(len(values), S), st_of(nfreqs))


def _port(payload, states, st, n, T):
    return decode.decode_search(
        torch.from_numpy(payload), torch.from_numpy(states.view(np.int32)),
        tables.to_device(st, "cpu"), n, T)


def _check(payload, states, t_sec, sec_len, n, T, st, values=None):
    S = len(states)
    want = pallas_decode.decode_search(
        payload, states, st, n, S=S, T=T, t_sec=t_sec, sec_len=sec_len,
        TC=32, interpret=True)
    before = decode.launches
    got = _port(payload, states, st, n, T)
    assert decode.launches == before == 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want)[:T])
    if values is not None:
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32).reshape(-1)[:n], values)
    return got


def test_fold2_s256():
    values = _zipf(40000)
    case = _fold_stream(values, 256, 2)
    assert case[-1].high is not None
    _check(*case, values=values)


def test_ragged_tail_fold1():
    values = _zipf(128 * 37 + 5)
    _check(*_fold_stream(values, 128, 1), values=values)


def test_several_sections():
    values = _zipf(30000)
    case = _fold_stream(values, 128, 2, cap_bytes=8192)
    assert len(case[3]) > 2
    _check(*case, values=values)


def test_three_exception_bytes():
    rng = np.random.default_rng(8)
    values = _zipf(12000)
    big = rng.integers(1 << 25, 1 << 32, size=12000, dtype=np.uint64)
    values = np.where(rng.random(12000) < 0.2, big, values).astype(np.uint32)
    case = _fold_stream(values, 128, 2)
    assert tables.to_device(case[-1], "cpu").NE == 3
    _check(*case, values=values)


def test_three_renorm_rounds():
    """log2m = 17 forces NR = 3 (a hand-built frame, identity table)."""
    rng = np.random.default_rng(13)
    values = rng.integers(0, 4096, size=20000).astype(np.uint32)
    nfreqs = np.full(4096, 32, dtype=np.uint64)
    case = _encode(values, np.zeros(20000, np.uint32),
                   np.zeros((20000, 3), np.uint8), nfreqs, 128)
    st = jtables.build_search_table(nfreqs)
    assert tables.to_device(st, "cpu").NR == 3 and st.val is None
    _check(*case, st, values=values)


def test_single_symbol_alphabet():
    """sigma == 1: depth 0, no pivots, f == M."""
    values = np.full(5000, 7, dtype=np.uint32)
    case = _blob_stream(AnsInt(lanes=128), values,
                        jtables.build_search_table)
    assert case[-1].depth == 0 and case[-1].val is not None
    _check(*case, values=values)


def test_sparse_value_table():
    values = (_zipf(20000) % 300).astype(np.uint32) * 7 + 3
    case = _blob_stream(AnsInt(lanes=128), values,
                        jtables.build_search_table)
    assert case[-1].val is not None
    _check(*case, values=values)


@pytest.mark.parametrize("S", [1, 32, 64])
def test_small_lane_counts(S):
    """S below the Pallas kernel's 128-lane rows: hold the plain decode
    against the input itself."""
    values = _zipf(3000 + S)
    codec = AnsFold(2, lanes=S)
    payload, states, _, _, n, T, st = _blob_stream(
        codec, values, lambda nf: jtables.build_search_table(
            nf, *map_np.fold_unmap_high(np.arange(len(nf), dtype=np.uint32),
                                        2)))
    got = _port(payload, states, st, n, T).numpy().view(np.uint32)
    np.testing.assert_array_equal(got.reshape(-1)[:n], values)


def test_corrupt_stream_raises():
    values = _zipf(6000)
    payload, states, _, _, n, T, st = _fold_stream(values, 128, 2)
    with pytest.raises(ValueError, match="corrupt"):
        _port(payload[: len(payload) // 2].copy(), states, st, n, T)
    with pytest.raises(ValueError):
        decode.decode_search(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(128, dtype=torch.int32),
                             tables.to_device(st, "cpu"), n, T)
