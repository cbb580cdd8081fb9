"""K2's plain version (lane_codec.place_plain: the stream, the stream
offset of every step and the stream's length) and the round totals
(lane_codec.encode_totals) against the Pallas placement run in interpret
mode (+ sections_to_stream), the XLA scatter placement
(lane_codec.place_stream_packed) and ans_tpu's encode_totals, across
several sections, lane counts, steps that write no byte and three
exception rounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.models import framing as jframing
from ans_tpu.ops import lane_codec as jlc
from ans_tpu.ops import pallas_encode, pallas_place
from ans_tpu.ops import tables as jtables
from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu_torch.ops import encode, lane_codec, place, tables


def _values(kind, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.zipf(1.35, size=n) - 1).clip(0, 1 << 26)
    if kind == "wide":  # values >= 2^25: three exception bytes (fold-2)
        big = rng.integers(1 << 25, 1 << 32, size=n, dtype=np.uint64)
        x = np.where(rng.random(n) < 0.2, big, x)
    return x.astype(np.uint32)


def _scan(values, S, fidelity=2):
    mapped = map_np.fold_map(values, fidelity)
    k, b = map_np.fold_exceptions(values, fidelity)
    freqs = np.bincount(mapped).astype(np.uint64)
    et = jtables.build_enc_table(
        adjust_freqs(freqs, len(freqs) - 1, True, 1))
    n = len(values)
    T = jlc.lane_steps(n, S)
    pad = T * S - n
    m_ts = jnp.asarray(np.pad(mapped, (0, pad)).reshape(T, S))
    k_ts = np.pad(k, (0, pad)).reshape(T, S)
    b_ts = np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)
    packed, _, _ = pallas_encode.encode_scan(
        m_ts, jnp.asarray(k_ts), jnp.int32(n), et, S=S, T=T, TC=32,
        interpret=True)
    return n, T, et, np.array(packed[:T]), k_ts, b_ts


def _port_args(packed, k_ts, b_ts):
    b = b_ts.astype(np.int32)
    excw = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    return (torch.from_numpy(packed), torch.from_numpy(k_ts.astype(np.int32)),
            torch.from_numpy(excw))


@pytest.mark.parametrize("kind,S,n,cap", [("zipf", 128, 30000, 16384),
                                          ("wide", 128, 12000, 8192),
                                          ("zipf", 256, 20000, 3 << 20)])
def test_plain_place_matches_pallas(kind, S, n, cap):
    n, T, et, packed, k_ts, b_ts = _scan(_values(kind, n, 4), S)
    jrb, jtot = jlc.encode_totals(jnp.asarray(packed), jnp.asarray(k_ts),
                                  jnp.int32(n), S=S, T=T)
    jtot = int(jtot)
    t_sec, sec_len = jframing.choose_sections(np.asarray(jrb)[::6], jtot,
                                              T, cap_bytes=cap)
    assert (len(sec_len) > 1) == (cap < 1 << 20)
    NE = int(k_ts.max())
    assert NE == 3 or kind != "wide"
    secs = pallas_place.place(
        jnp.asarray(packed), jnp.asarray(k_ts), jnp.asarray(b_ts),
        jnp.int32(n), S=S, T=T, t_sec=t_sec, sec_len=sec_len,
        NR=jtables.max_renorm_rounds(et.log2m), NE=NE, interpret=True)
    want = pallas_place.sections_to_stream(np.asarray(secs), sec_len)

    pk, nb, excw = _port_args(packed, k_ts, b_ts)
    rb, tot = lane_codec.encode_totals(pk, nb, n)
    np.testing.assert_array_equal(rb.numpy(), np.asarray(jrb))
    assert int(tot) == jtot == len(want)
    before = place.launches
    for total in (None, jtot):
        stream, step_base, got = place.place(pk, nb, excw, n, total)
        np.testing.assert_array_equal(stream.numpy(), want)
        np.testing.assert_array_equal(step_base.numpy(), np.asarray(jrb)[::6])
        assert got == jtot
    assert place.launches == before == 0


@pytest.mark.parametrize("kind,S,n", [("zipf", 32, 5000), ("wide", 1, 300),
                                      ("wide", 512, 9000)])
def test_plain_place_matches_scatter(kind, S, n):
    """Against the XLA scatter placement (any power-of-two S)."""
    values = _values(kind, n, 9)
    mapped = map_np.fold_map(values, 2)
    k, b = map_np.fold_exceptions(values, 2)
    freqs = np.bincount(mapped).astype(np.uint64)
    et = jtables.build_enc_table(
        adjust_freqs(freqs, len(freqs) - 1, True, 1))
    T = jlc.lane_steps(n, S)
    pad = T * S - n
    m_ts = np.pad(mapped, (0, pad)).reshape(T, S)
    k_ts = np.pad(k, (0, pad)).reshape(T, S)
    b_ts = np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)
    xs, xtot, _, xsb = jlc.encode_lanes(
        jnp.asarray(m_ts), jnp.asarray(k_ts), jnp.asarray(b_ts),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    packed, _ = encode.encode_scan(torch.from_numpy(m_ts.astype(np.int32)),
                                   n, tables.to_device(et, "cpu"))
    ps, ptot, _ = jlc.place_stream_packed(
        jnp.asarray(packed.numpy()), jnp.asarray(k_ts), jnp.asarray(b_ts),
        jnp.int32(n), S=S, T=T)
    pk, nb, excw = _port_args(packed.numpy(), k_ts, b_ts)
    rb, tot = lane_codec.encode_totals(pk, nb, n)
    np.testing.assert_array_equal(rb.numpy()[::6], np.asarray(xsb))
    assert int(tot) == int(xtot) == int(ptot)
    stream, step_base, got = place.place(pk, nb, excw, n)
    np.testing.assert_array_equal(step_base.numpy(), np.asarray(xsb))
    assert got == int(tot)
    stream = stream.numpy()
    np.testing.assert_array_equal(stream, np.asarray(xs)[:int(xtot)])
    np.testing.assert_array_equal(stream, np.asarray(ps)[:int(ptot)])


def test_place_checks_shapes():
    pk = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        place.place(pk, pk[:3], pk, 32)
    with pytest.raises(ValueError):
        place.place(pk, pk, pk.to(torch.int64), 32)
    with pytest.raises(ValueError, match="section plan"):
        place.place(pk, pk, pk, 32, 1)
    stream, step_base, total = place.place(pk, pk, pk, 32, 0)
    assert stream.numel() == 0 and total == 0
    assert step_base.tolist() == [0, 0, 0, 0]


def _sparse_words(T, S, seed, ne):
    """(packed, nb, excw) of T x S positions where most steps write no
    byte: a few lanes renormalise (rc 1-3) or carry exception bytes (nb
    up to `ne`), in a few steps."""
    rng = np.random.default_rng(seed)
    busy = rng.random(T) < 0.3
    rc = np.where(busy[:, None] & (rng.random((T, S)) < 0.2),
                  rng.integers(1, 4, size=(T, S)), 0)
    nb = np.where(busy[:, None] & (rng.random((T, S)) < 0.2),
                  rng.integers(0, ne + 1, size=(T, S)), 0)
    low = rng.integers(0, 1 << 24, size=(T, S))
    packed = (rng.integers(0, 1 << 24, size=(T, S)) | (rc << 24))
    return (packed.astype(np.int32), nb.astype(np.int32),
            low.astype(np.int32))


@pytest.mark.parametrize("kind,S,n", [
    ("sparse", 1, 3000), ("sparse", 32, 5000 - 3), ("sparse", 256, 9000),
    ("sparse", 4096, 3 * 4096 + 5), ("silent", 128, 2000),
    ("zipf", 1, 400), ("wide", 32, 4001), ("wide", 1024, 20000)])
def test_plain_step_offsets_match_encode_totals(kind, S, n):
    """The plain placement's step offsets and length are ans_tpu's
    round_base[::6] and total, on steps that write no byte, whole inputs
    that write none, and three exception rounds."""
    T = jlc.lane_steps(n, S)
    if kind in ("sparse", "silent"):
        packed, k_ts, low = _sparse_words(T, S, S + n, 3 if kind == "sparse"
                                          else 0)
        if kind == "silent":
            packed &= 0xFFFFFF
        pk, nb, excw = map(torch.from_numpy, (packed, k_ts, low))
    else:  # the port's scan: the Pallas one needs S a multiple of 128
        values = _values(kind, n, 2)
        mapped = map_np.fold_map(values, 2)
        k, b = map_np.fold_exceptions(values, 2)
        et = jtables.build_enc_table(adjust_freqs(
            np.bincount(mapped).astype(np.uint64), int(mapped.max()), True,
            1))
        pad = T * S - n
        k_ts = np.pad(k, (0, pad)).reshape(T, S)
        packed, _ = encode.encode_scan(
            torch.from_numpy(np.pad(mapped, (0, pad)).reshape(T, S).astype(
                np.int32)), n, tables.to_device(et, "cpu"))
        pk, nb, excw = _port_args(packed.numpy(), k_ts,
                                  np.pad(b, ((0, pad), (0, 0))).reshape(
                                      T, S, 3))
        assert int(k_ts.max()) == 3 or kind != "wide"
    jrb, jtot = jlc.encode_totals(jnp.asarray(pk.numpy()),
                                  jnp.asarray(nb.numpy()), jnp.int32(n),
                                  S=S, T=T)
    jsteps = np.asarray(jrb)[::6]
    stream, step_base, total = place.place(pk, nb, excw, n)
    np.testing.assert_array_equal(step_base.numpy(), jsteps)
    assert total == int(jtot) == stream.numel()
    assert (total == 0) == (kind == "silent")
    if kind == "sparse":  # steps with no byte, and steps with some
        sizes = np.diff(np.append(jsteps, total))
        assert (sizes == 0).any() and (sizes > 0).any()
