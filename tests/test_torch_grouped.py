"""K6's and K5's plain versions (lane_codec.encode_scan_grouped_plain,
decode_grouped_plain) against ans_tpu's grouped Pallas kernels run in
interpret mode: whole packed words and states for the scan, with ranks
and with in-kernel symbol -> rank maps; whole (T, S) outputs for the
decode, with a value table, high/nb exceptions, the identity, several
sections, three renorm rounds and f == 1 groups.  Each interpret run is
made once per case (module-scoped fixtures)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.models import framing as jframing
from ans_tpu.ops import grouped as jgrouped
from ans_tpu.ops import lane_codec as jlc
from ans_tpu.ops import pallas_decode, pallas_encode
from ans_tpu.ops import tables as jtables
from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu_torch.ops import decode, encode, lane_codec, tables


def _identity_freqs(sigma, log2m):
    """A dense frame whose frequencies fall with the value (so every
    rank is its own value), summing to 2^log2m."""
    v = np.arange(sigma)
    nf = (1 + (v < sigma // 2) + 2 * (v < sigma // 8)
          + 5 * (v < 64)).astype(np.uint64)
    nf[0] += (1 << log2m) - int(nf.sum())
    return nf


def _case(values, nfreqs, S, high=None, nb_sym=None, cap_bytes=3 << 20):
    """Encode `values` (symbols = values, or with high/nb_sym: symbols
    values >> 8 with one exception byte) with ans_tpu's XLA engine under
    the grouped layout."""
    if high is None:
        syms, nb = values, np.zeros(len(values), np.uint32)
    else:
        syms, nb = values >> np.uint32(8), np.ones(len(values), np.uint32)
    excb = np.zeros((len(values), 3), np.uint8)
    excb[:, 0] = values & 0xFF
    lay = jgrouped.build_group_layout(nfreqs)
    et = jtables.build_enc_table(nfreqs, lay)
    n = len(values)
    T = jlc.lane_steps(n, S)
    pad = T * S - n
    stream, total, states, sb = jlc.encode_lanes(
        jnp.asarray(np.pad(syms, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(nb, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(excb, ((0, pad), (0, 0))).reshape(T, S, 3)),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    total = int(total)
    t_sec, sec_len = jframing.choose_sections(np.asarray(sb), total, T,
                                              cap_bytes=cap_bytes)
    return dict(values=values, syms=syms, nfreqs=nfreqs, lay=lay, S=S, T=T,
                n=n, payload=np.array(stream[:total]),
                states=np.asarray(states).view(np.uint32), t_sec=t_sec,
                sec_len=sec_len, high=high, nb_sym=nb_sym)


def _sparse_values():
    """sigma > 2^13 with gaps (a value table is needed)."""
    rng = np.random.default_rng(7)
    base = np.repeat(np.arange(9000, dtype=np.uint32) * 3, 2)
    tail = (rng.zipf(1.2, size=30000) - 1).clip(0, 60000)
    return np.concatenate([base, tail]).astype(np.uint32)


def _freqs(syms, fold):
    freqs = np.bincount(syms).astype(np.uint64)
    return adjust_freqs(freqs, int(syms.max()), fold, 1)


@pytest.fixture(scope="module")
def cases():
    out = {}
    x = _sparse_values()
    out["values"] = _case(x, _freqs(x, False), 256)
    out["sections"] = _case(x, _freqs(x, False), 128, cap_bytes=8192)
    # high/nb: a fold-like coder whose low byte rides the exception
    # stream while the table rebuilds high = sym << 8
    rng = np.random.default_rng(9)
    sym = np.concatenate([
        np.arange(9000, dtype=np.uint32),
        (rng.zipf(1.3, size=36000) - 1).clip(0, 12000).astype(np.uint32)])
    vals = (sym << np.uint32(8)) | rng.integers(0, 256, size=len(sym)
                                                ).astype(np.uint32)
    nf = _freqs(sym, True)
    ids = np.arange(len(nf), dtype=np.uint32)
    out["high_nb"] = _case(vals, nf, 256, high=ids << np.uint32(8),
                           nb_sym=np.ones(len(nf), np.uint32))
    # identity and three renorm rounds: M = 2^17
    nf = _identity_freqs(9000, 17)
    p = nf / nf.sum()
    x = np.random.default_rng(10).choice(9000, size=40000, p=p).astype(
        np.uint32)
    out["identity"] = _case(x, nf, 128)
    return out


def _port_table(c):
    return tables.to_device(tables.build_grouped_table(
        c["nfreqs"], c["high"], c["nb_sym"]), "cpu")


@pytest.fixture(scope="module")
def pallas_decoded(cases):
    """ans_tpu's grouped decode of every case, in interpret mode."""
    out = {}
    for name, c in cases.items():
        gt = jgrouped.build_group_table(c["lay"], c["high"], c["nb_sym"])
        got = pallas_decode.decode_grouped(
            c["payload"], c["states"], gt, c["n"], S=c["S"], T=c["T"],
            t_sec=c["t_sec"], sec_len=c["sec_len"], TC=32, interpret=True)
        out[name] = np.asarray(got)[: c["T"]]
    return out


def _port_decode(c, payload=None):
    payload = c["payload"] if payload is None else payload
    states = torch.from_numpy(c["states"].view(np.int32).copy())
    return decode.decode_grouped(torch.from_numpy(payload), states,
                                 _port_table(c), c["n"], c["T"])


@pytest.mark.parametrize("name", ["values", "sections", "high_nb",
                                  "identity"])
def test_plain_decode_matches_pallas(cases, pallas_decoded, name):
    c = cases[name]
    before = decode.grouped_launches
    got = _port_decode(c).numpy().view(np.uint32)
    assert decode.grouped_launches == before == 0
    np.testing.assert_array_equal(got, pallas_decoded[name])
    np.testing.assert_array_equal(got.reshape(-1)[: c["n"]], c["values"])


def test_decode_case_shapes(cases):
    """The cases cover what they are named for."""
    t = {k: _port_table(c) for k, c in cases.items()}
    assert t["values"].table.numel() and t["values"].NE == 0
    assert t["high_nb"].NE == 1 and t["high_nb"].nb.dtype == torch.uint8
    assert t["identity"].table.numel() == 0 and t["identity"].NR == 3
    assert len(cases["sections"]["sec_len"]) > 2
    for c in cases.values():
        assert tables.use_grouped_layout(c["nfreqs"])
    assert cases["values"]["lay"].g_f.min() == 1  # f == 1 groups


def test_truncated_stream_raises(cases):
    c = cases["values"]
    with pytest.raises(ValueError, match="corrupt"):
        _port_decode(c, c["payload"][: len(c["payload"]) // 2].copy())


def _grouped_fold_symbols():
    """ANSfold-8 symbols of ~14k distinct values: a grouped frame fed to
    the scan as symbol ids (the in-kernel symbol -> rank map)."""
    x = np.random.default_rng(1).integers(0, 1 << 15, size=30000).astype(
        np.uint32)
    mapped = map_np.fold_map(x, 8)
    return mapped, _freqs(mapped, True)


@pytest.fixture(scope="module")
def scan_cases(cases):
    """(ranks or symbol ids, layout, by_symbol) per scan case."""
    out = {}
    for name in ("values", "identity"):
        c = cases[name]
        ranks = c["lay"].rank_of[c["syms"]]
        out[name] = (ranks, c["lay"], False)
    mapped, nf = _grouped_fold_symbols()
    out["rank_of"] = (mapped, jgrouped.build_group_layout(nf), True)
    return out


@pytest.mark.parametrize("name", ["values", "identity", "rank_of"])
def test_plain_scan_matches_pallas(scan_cases, name):
    syms, lay, by_symbol = scan_cases[name]
    S = 128
    n = len(syms)
    T = jlc.lane_steps(n, S)
    syms_ts = np.pad(syms, (0, T * S - n)).reshape(T, S).astype(np.int32)
    vr = jgrouped.pack_planes(lay.rank_of) if by_symbol else None
    jp, js, _ = pallas_encode.encode_scan_grouped(
        jnp.asarray(syms_ts), jnp.int32(n), lay, S=S, T=T, TC=32,
        vr_planes=vr, interpret=True)
    table = tables.grouped_enc_to_device(lay, "cpu", rank_of=by_symbol)
    before = encode.grouped_launches
    packed, states = encode.encode_scan_grouped(torch.from_numpy(syms_ts),
                                                n, table)
    assert encode.grouped_launches == before == 0
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp)[:T])
    np.testing.assert_array_equal(states.numpy(), np.asarray(js))
    if name == "identity":
        assert lay.log2m == 17


def test_scan_rejects_out_of_range(scan_cases):
    syms, lay, _ = scan_cases["values"]
    table = tables.grouped_enc_to_device(lay, "cpu", rank_of=False)
    bad = torch.from_numpy(np.array([[0, lay.sigma]], np.int32))
    with pytest.raises(ValueError, match="outside"):
        lane_codec.encode_scan_grouped_plain(bad, 2, table)
    # past n the input is not read
    lane_codec.encode_scan_grouped_plain(bad, 1, table)
    table = tables.grouped_enc_to_device(lay, "cpu", rank_of=True)
    bad = torch.from_numpy(np.array([[len(lay.rank_of)]], np.int32))
    with pytest.raises(ValueError, match="outside"):
        encode.encode_scan_grouped(bad, 1, table)
