"""The direct decode engine (K4): its plain version
(ans_tpu_torch.ops.lane_codec.decode_direct_plain) and the per-slot table
(ans_tpu_torch.ops.tables.materialize_slots) against ans_tpu's direct
Pallas kernel in interpret mode, as tests/test_pallas_interpret.py runs
it, against ans_tpu's per-slot tables and against the port's own search
and grouped engines.  All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.models import framing as jframing
from ans_tpu.models.ans import AnsFold as RefAnsFold
from ans_tpu.models.ans import AnsInt as RefAnsInt
from ans_tpu.models.bytes import AnsByte as RefAnsByte
from ans_tpu.ops import grouped as jgrouped
from ans_tpu.ops import lane_codec as jlane
from ans_tpu.ops import pallas_decode
from ans_tpu.ops import tables as jtables
from ans_tpu.reference_model import mappings as jmap
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu_torch.models import engine
from ans_tpu_torch.models.ans import AnsFold, AnsInt, _stage
from ans_tpu_torch.models.bytes import AnsByte
from ans_tpu_torch.ops import decode, lane_codec, tables


@pytest.fixture(scope="module")
def zdata():
    rng = np.random.default_rng(5)
    return (rng.zipf(1.3, size=40000) - 1).clip(0, 1 << 27).astype(
        np.uint32)


def _pallas_direct(payload, states, dt, n, S, t_sec, sec_len, has_exc):
    """ans_tpu's direct kernel in interpret mode -> (n,) u32."""
    T = jlane.lane_steps(n, S)
    out = pallas_decode.decode(np.asarray(payload), np.asarray(states), dt,
                               n, S=S, T=T, has_exc=has_exc, t_sec=t_sec,
                               sec_len=sec_len, TC=32, interpret=True)
    return np.asarray(out).reshape(-1)[:n].astype(np.uint32)


def _plain_direct(payload, states, table, n, S):
    """The port's plain K4 on the per-slot table of `table` -> (n,) u32."""
    assert tables.direct_fits(table)
    dd = tables.to_device(tables.materialize_slots(table), "cpu")
    out = lane_codec.decode_direct_plain(
        torch.from_numpy(np.array(payload, dtype=np.uint8)),
        torch.from_numpy(np.asarray(states, np.uint32).view(np.int32).copy()),
        dd, n, lane_codec.lane_steps(n, S))
    return out.reshape(-1)[:n].numpy().view(np.uint32)


def _check_codec(ref, port, values, want, S):
    """ans_tpu's blob through ans_tpu's direct kernel and through the
    port's plain K4 and its layout engine."""
    blob = ref.encode(values)
    dt, off = ref._dec_table(blob) if hasattr(ref, "_dec_table") else (
        None, None)
    if dt is None:  # AnsByte: the byte prelude
        from ans_tpu.reference_model.rans_compat import byte_prelude_decode
        nfreqs, off = byte_prelude_decode(blob)
        dt = jtables.build_dec_table(nfreqs.astype(np.uint32))
    dt = jtables.materialize_slots(dt)
    S_, states, payload, t_sec, sec_len = jframing.parse(blob, off)
    assert S_ == S
    n = len(want)
    ref_out = _pallas_direct(payload, states, dt, n, S, t_sec, sec_len,
                             dt.has_exc)
    table, poff = port._dec_table(blob)
    assert poff == off
    got = _plain_direct(payload, states, table, n, S)
    np.testing.assert_array_equal(got, ref_out)
    np.testing.assert_array_equal(got, want)
    own = engine.eligible_engines(table)[0]
    np.testing.assert_array_equal(
        engine.decode(payload, states, table, n, S=S,
                      T=lane_codec.lane_steps(n, S), sec_len=sec_len,
                      device="cpu", engine=own), want)


def test_direct_fold_with_exceptions(zdata):
    _check_codec(RefAnsFold(2, lanes=256), AnsFold(2, device="cpu"), zdata,
                 zdata, 256)


def test_direct_identity(zdata):
    v = (zdata % 3000).astype(np.uint32)
    _check_codec(RefAnsInt(lanes=128), AnsInt(device="cpu"), v, v, 128)


def test_direct_ragged_tail(zdata):
    v = zdata[: 128 * 37 + 5]
    _check_codec(RefAnsFold(1, lanes=128), AnsFold(1, device="cpu"), v, v,
                 128)


@pytest.mark.parametrize("distinct", [256, 37, 1])
def test_direct_ansbyte_table(distinct):
    """AnsByte's frame (M <= 4096): all 256 byte values present (the
    symbol is its own value), a sparse alphabet (a value table), and one
    distinct byte."""
    rng = np.random.default_rng(distinct)
    alphabet = rng.permutation(256)[:distinct].astype(np.uint8)
    data = alphabet[(rng.zipf(1.5, size=20000) - 1) % distinct]
    data[:distinct] = alphabet
    want = data.astype(np.uint32)
    _check_codec(RefAnsByte(lanes=128), AnsByte(device="cpu"),
                 data.tobytes(), want, 128)


def test_direct_several_sections(zdata):
    """A small section cap cuts the stream into several sections; the
    port's one cursor runs over their concatenation."""
    values = zdata[:30000]
    S, f = 128, 2
    mapped = jmap.fold_map(values, f)
    k, b = jmap.fold_exceptions(values, f)
    freqs = np.bincount(mapped).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, len(freqs) - 1, True, 1)
    et = jtables.build_enc_table(nfreqs)
    n = len(values)
    T = jlane.lane_steps(n, S)
    pad = T * S - n
    stream, total, states, sb = jlane.encode_lanes(
        jnp.asarray(np.pad(mapped, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(k, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    total = int(total)
    t_sec, sec_len = jframing.choose_sections(np.asarray(sb), total, T,
                                              cap_bytes=8192)
    assert len(sec_len) > 2
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    high, nb = jmap.fold_unmap_high(syms, f)
    payload, states = np.array(stream[:total]), np.array(states)
    ref_out = _pallas_direct(payload, states,
                             jtables.build_dec_table(nfreqs, high, nb), n, S,
                             t_sec, sec_len, True)
    got = _plain_direct(payload, states,
                        tables.build_dec_table(nfreqs, high, nb), n, S)
    np.testing.assert_array_equal(got, ref_out)
    np.testing.assert_array_equal(got, values)


def _small_grouped_freqs(seed=6):
    """9000 symbols of frequency 1 or 2 in no order, M = 2^14: a
    frequency-grouped frame whose per-slot table fits K4."""
    f = np.ones(9000, np.int64)
    f[:7384] = 2
    return np.random.default_rng(seed).permutation(f).astype(np.uint64)


@pytest.mark.parametrize("exceptions", [False, True])
def test_direct_grouped_order_table(exceptions):
    """The direct engine under the grouped slot order: the port's grouped
    encode (held equal to ans_tpu's elsewhere) writes the stream; ans_tpu's
    direct kernel on its layout-ordered slots, the port's plain K4 and the
    port's grouped engine all decode it."""
    nf = _small_grouped_freqs()
    n, S = 20000, 128
    rng = np.random.default_rng(1)
    syms = rng.choice(len(nf), size=n, p=nf / nf.sum()).astype(np.uint32)
    ids = np.arange(len(nf), dtype=np.uint32)
    if exceptions:
        low = rng.integers(0, 256, size=n).astype(np.uint32)
        want = (syms << np.uint32(8)) | low
        high, nb = ids << np.uint32(8), np.ones(len(nf), np.uint32)
        k, lw = np.ones(n, np.int32), low.view(np.int32)
    else:
        want, high, nb = syms, None, None
        k = lw = np.zeros(n, np.int32)
    enc, staged = _stage(torch.from_numpy(syms.view(np.int32)),
                         torch.from_numpy(k), torch.from_numpy(lw), n, nf,
                         False, S)
    assert isinstance(enc, tables.GroupedEncDevice)
    blob = engine.encode(*staged, n, enc)
    S_, states, payload, t_sec, sec_len = jframing.parse(blob, 0)
    jdt = jtables.materialize_slots(jtables.build_dec_table(
        nf, high, nb, layout=jgrouped.build_group_layout(nf), slots=False))
    ref_out = _pallas_direct(payload, states, jdt, n, S, t_sec, sec_len,
                             exceptions)
    table = tables.build_dec_table(nf, high, nb)
    assert isinstance(table, tables.GroupedTable)
    got = _plain_direct(payload, states, table, n, S)
    np.testing.assert_array_equal(got, ref_out)
    np.testing.assert_array_equal(got, want)
    T = lane_codec.lane_steps(n, S)
    for eng in ("grouped", "direct"):
        np.testing.assert_array_equal(
            engine.decode(payload, states, table, n, S=S, T=T,
                          sec_len=sec_len, device="cpu", engine=eng), want)


def _zipf_freqs(sigma, log2m, gaps=False):
    M = 1 << log2m
    w = 1.0 / np.arange(1, sigma + 1)
    nf = 1 + np.floor((M - sigma) * w / w.sum()).astype(np.int64)
    nf[0] += M - int(nf.sum())
    nf = np.random.default_rng(sigma).permutation(nf)
    if gaps:
        out = np.zeros(3 * sigma, np.int64)
        out[::3] = nf
        nf = out
    return nf.astype(np.uint64)


@pytest.mark.parametrize("sigma,log2m,gaps,fold", [
    (1, 0, False, False), (1, 6, True, False), (5, 4, False, True),
    (255, 12, True, False), (1546, 15, False, True), (3000, 12, True, True),
    (9000, 14, False, False), (9000, 14, True, True),
    (12000, 14, False, True)])
def test_materialize_slots_equals_reference(sigma, log2m, gaps, fold):
    """The two-level table (slot -> index, index -> row) expands to
    ans_tpu's per-slot arrays, under both slot orders."""
    nf = _zipf_freqs(sigma, log2m, gaps)
    ids = np.arange(len(nf), dtype=np.uint32)
    hi_nb = (ids * np.uint32(7), ids % np.uint32(4)) if fold else (None,
                                                                    None)
    layout = (jgrouped.build_group_layout(nf)
              if jgrouped.use_grouped_layout(nf) else None)
    want = jtables.materialize_slots(jtables.build_dec_table(
        nf, *hi_nb, layout=layout, slots=False))
    table = tables.build_dec_table(nf, *hi_nb)
    assert isinstance(table, tables.GroupedTable) == (layout is not None)
    st = tables.materialize_slots(table)
    assert (st.sigma, st.frame_size, st.log2m) == (sigma, 1 << log2m, log2m)
    assert st.slot_sym.dtype == np.uint16 and len(st.slot_sym) == 1 << log2m
    idx = st.slot_sym.astype(np.int64)
    np.testing.assert_array_equal(st.freq[idx], want.freq)
    np.testing.assert_array_equal(
        np.arange(1 << log2m) - st.base[idx].astype(np.int64), want.offset)
    if fold:
        np.testing.assert_array_equal(st.high[idx], want.high)
        np.testing.assert_array_equal(st.nb[idx], want.nb)
    else:
        np.testing.assert_array_equal(st.high[idx], want.sym)
        assert not st.nb.any()
    dd = tables.to_device(st, "cpu")
    assert dd.slot_sym.dtype == torch.int16 and dd.rows.shape == (sigma, 4)
    assert (dd.NR, dd.NE) == (tables.max_renorm_rounds(log2m),
                              int(st.nb.max()))
    assert tables.direct_table_bytes(table) == 2 * (1 << log2m) + 16 * sigma


@pytest.mark.parametrize("sigma,log2m,fits", [
    (256, 12, True), (1546, 15, True), (2048, 16, True), (6000, 16, True),
    (8192, 16, False), (4096, 17, False), (9000, 14, True),
    (12000, 14, True), (10000, 15, True), (12000, 15, False),
    (70000, 17, False)])
def test_eligibility_is_capacity(sigma, log2m, fits):
    """"direct" is eligible exactly when the tables fit one block's shared
    memory; the rule never picks it otherwise and forcing it raises."""
    table = tables.build_dec_table(_zipf_freqs(sigma, log2m))
    own = "grouped" if isinstance(table, tables.GroupedTable) else "search"
    assert tables.direct_fits(table) == fits
    assert (2 * (1 << log2m) + 16 * sigma <= tables.DIRECT_TABLE_BYTES
            and sigma <= 1 << 16) == fits
    assert engine.eligible_engines(table) == (
        (own, "direct") if fits else (own,))
    chosen = engine.choose_decode_engine(table, 4096)
    assert chosen in engine.eligible_engines(table)
    assert chosen == engine.choose_decode_engine(table, 32)
    payload, states = np.zeros(8, np.uint8), np.full(32, 1 << 23, np.uint32)
    kw = dict(S=32, T=1, sec_len=[8], device="cpu")
    other = "search" if own == "grouped" else "grouped"
    for eng in ("direct", other, "xla"):
        if eng == "direct" and fits:
            assert engine.PreparedDecoder(payload, states, table, 32,
                                          engine=eng, **kw).engine == eng
            continue
        with pytest.raises(ValueError, match="not eligible"):
            engine.PreparedDecoder(payload, states, table, 32, engine=eng,
                                   **kw)
    if not fits and sigma <= 1 << 16:
        dd = tables.to_device(tables.materialize_slots(table), "cpu")
        with pytest.raises(ValueError, match="shared memory"):
            decode.decode_direct(torch.zeros(8, dtype=torch.uint8),
                                 torch.full((32,), 1 << 23,
                                            dtype=torch.int32), dd, 32, 1)
    if sigma > 1 << 16:
        with pytest.raises(ValueError, match="u16"):
            tables.materialize_slots(table)


def test_direct_corrupt_stream_raises_and_counts_nothing(zdata):
    port = AnsFold(2, lanes=64, device="cpu")
    blob = port.encode(zdata[:5000])
    count = decode.direct_launches
    pd = port.prepare_decoder(blob, 5000, "direct")
    np.testing.assert_array_equal(pd.to_host(pd()), zdata[:5000])
    assert decode.direct_launches == count  # CPU tensors: the plain version
    pd.stream = pd.stream[: pd.stream.numel() // 2].clone()
    with pytest.raises(ValueError, match="corrupt"):
        pd()
