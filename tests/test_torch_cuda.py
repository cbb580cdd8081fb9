"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip.  On the
card, run them without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py covers the main path at full width; these cover the edges:
lane counts from 1 to 2^13 (one to eight lanes per decode thread), three
renorm rounds, three exception bytes, and corrupt streams.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import adjust_freqs
from ans_tpu_torch.models.ans import AnsFold, _stage_ts
from ans_tpu_torch.ops import decode, encode, lane_codec, place, tables
from ans_tpu_torch.ops.mappings import fold_map_hist

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


def _run_all(mapped, k, low, enc, dec, n, S):
    """Kernels and plain versions on the same device tensors."""
    T = lane_codec.lane_steps(n, S)
    m_ts, nb_ts, ex_ts = _stage_ts(mapped, k, low, n, S, T)
    packed, states = encode.encode_scan(m_ts, n, enc)
    pp, ps = lane_codec.encode_scan_plain(m_ts, n, enc)
    assert torch.equal(packed, pp) and torch.equal(states, ps)
    rb, total = lane_codec.encode_totals(packed, nb_ts, n)
    args = (packed, nb_ts, ex_ts, n, rb, int(total))
    stream = place.place(*args)
    assert torch.equal(stream, lane_codec.place_plain(*args))
    out = decode.decode_search(stream, states, dec, n, T)
    assert torch.equal(out, lane_codec.decode_search_plain(stream, states,
                                                           dec, n, T))
    return out, stream, states, T


@pytest.mark.parametrize("S", [1, 32, 128, 2048, 8192])
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
    x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
    blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
    codec = AnsFold(int(rec["method"].split("-")[1]), lanes=rec["lanes"],
                    device=cuda)
    assert codec.encode(x) == blob
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
