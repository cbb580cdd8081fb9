"""K1's plain version (lane_codec.encode_scan_plain) against the Pallas
encode scan run in interpret mode (whole packed words and final states)
and against the XLA engine's final states (lane_codec.encode_lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.ops import lane_codec as jlc
from ans_tpu.ops import pallas_encode
from ans_tpu.ops import tables as jtables
from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu_torch.ops import encode, lane_codec, tables


def _fold_case(n, fidelity, seed):
    rng = np.random.default_rng(seed)
    values = (rng.zipf(1.3, size=n) - 1).clip(0, 1 << 27).astype(np.uint32)
    mapped = map_np.fold_map(values, fidelity)
    k, b = map_np.fold_exceptions(values, fidelity)
    freqs = np.bincount(mapped).astype(np.uint64)
    return mapped, k, b, adjust_freqs(freqs, len(freqs) - 1, True, 1)


def _big_frame_case(n, seed):
    """log2m = 17 (M = 2^17): three renorm rounds."""
    rng = np.random.default_rng(seed)
    mapped = rng.integers(0, 4096, size=n).astype(np.uint32)
    k = np.zeros(n, np.uint32)
    b = np.zeros((n, 3), np.uint8)
    return mapped, k, b, np.full(4096, 32, np.uint64)


def _staged(mapped, k, b, S):
    n = len(mapped)
    T = jlc.lane_steps(n, S)
    pad = T * S - n
    m_ts = np.pad(mapped, (0, pad)).reshape(T, S)
    k_ts = np.pad(k, (0, pad)).reshape(T, S)
    b_ts = np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)
    return n, T, m_ts, k_ts, b_ts


def _port_scan(m_ts, n, et):
    return encode.encode_scan(torch.from_numpy(m_ts.astype(np.int32)), n,
                              tables.to_device(et, "cpu"))


CASES = [("fold2", 128, 128 * 40 + 7), ("fold1", 128, 4096),
         ("fold4", 256, 5000), ("big_frame", 128, 6000)]


def _case(kind, n):
    if kind == "big_frame":
        return _big_frame_case(n, 1)
    return _fold_case(n, int(kind[-1]), 11)


@pytest.mark.parametrize("kind,S,n", CASES)
def test_plain_scan_matches_pallas(kind, S, n):
    mapped, k, b, nfreqs = _case(kind, n)
    et = jtables.build_enc_table(nfreqs)
    assert (et.log2m > 16) == (kind == "big_frame")
    n, T, m_ts, k_ts, _ = _staged(mapped, k, b, S)
    jp, js, _ = pallas_encode.encode_scan(
        jnp.asarray(m_ts), jnp.asarray(k_ts), jnp.int32(n), et, S=S, T=T,
        TC=32, interpret=True)
    packed, states = _port_scan(m_ts, n, et)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp)[:T])
    np.testing.assert_array_equal(states.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind,S,n", CASES + [("fold2", 32, 3001),
                                              ("fold2", 1, 257),
                                              ("big_frame", 64, 999)])
def test_plain_scan_states_match_xla(kind, S, n):
    """Any power-of-two S (the Pallas scan needs multiples of 128)."""
    mapped, k, b, nfreqs = _case(kind, n)
    et = jtables.build_enc_table(nfreqs)
    n, T, m_ts, k_ts, b_ts = _staged(mapped, k, b, S)
    _, _, jstates, _ = jlc.encode_lanes(
        jnp.asarray(m_ts), jnp.asarray(k_ts), jnp.asarray(b_ts),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    _, states = _port_scan(m_ts, n, et)
    np.testing.assert_array_equal(states.numpy().view(np.uint32),
                                  np.asarray(jstates))


def test_single_symbol_frame():
    """M = 1 (log2m = 0, f = M): the state never changes, no bytes."""
    n, S = 300, 32
    et = jtables.build_enc_table(np.array([0, 1], np.uint64))
    m_ts = np.ones((lane_codec.lane_steps(n, S), S), np.int32)
    packed, states = _port_scan(m_ts, n, et)
    assert (states.numpy() == tables.A_L).all()
    assert ((packed.numpy() >> 24) == 0).all()


def test_wrapper_runs_plain_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    mapped, k, b, nfreqs = _fold_case(2000, 2, 3)
    et = jtables.build_enc_table(nfreqs)
    n, _, m_ts, _, _ = _staged(mapped, k, b, 64)
    before = encode.launches
    syms = torch.from_numpy(m_ts.astype(np.int32))
    table = tables.to_device(et, "cpu")
    got = encode.encode_scan(syms, n, table)
    want = lane_codec.encode_scan_plain(syms, n, table)
    assert encode.launches == before == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        encode.encode_scan(syms.to(torch.int64), n, table)
