"""The plain versions of the byte-splitter kernels K7-K9
(ans_tpu_torch/ops/bytesplit.py) against ans_tpu: the XLA versions of
ans_tpu/ops/bytesplit.py and the Pallas kernels of
ans_tpu/ops/pallas_bytesplit.py in interpret mode.  Integer codecs: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.ops import bytesplit as jbs
from ans_tpu.ops import pallas_bytesplit as jpb
from ans_tpu_torch.ops import bytesplit as bs


def _mixed(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    m = rng.random(n)
    return np.where(m < .5, x & 0x7F,
                    np.where(m < .8, x & 0xFFFF, x)).astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _ref_vbyte(x):
    out, total = jbs.vbyte_encode(jnp.asarray(x))
    return np.array(out[: int(total)])


def _ref_svb(x):
    control, data, total = jbs.svb_encode(jnp.asarray(x))
    return np.array(control), np.array(data[: int(total)])


SIZES = [1, 3, 100, 101, 5000, 70000]


@pytest.mark.parametrize("n", SIZES)
def test_vbyte_encode_plain_equals_xla(n):
    x = _mixed(np.random.default_rng(n), n)
    np.testing.assert_array_equal(bs.vbyte_encode_plain(_t(x)).numpy(),
                                  _ref_vbyte(x))


@pytest.mark.parametrize("n", SIZES)
def test_svb_encode_plain_equals_xla(n):
    x = _mixed(np.random.default_rng(n), n)
    control, data = bs.svb_encode_plain(_t(x))
    rc, rd = _ref_svb(x)
    np.testing.assert_array_equal(control.numpy(), rc)
    np.testing.assert_array_equal(data.numpy(), rd)
    np.testing.assert_array_equal(
        control.numpy(), np.asarray(jpb.svb_control(jnp.asarray(x))))


@pytest.mark.parametrize("n", [100, 5000, 70000])
@pytest.mark.parametrize("vbyte", [False, True])
def test_encode_plain_equals_pallas_kernel(n, vbyte):
    """K7's plain version against `_enc_kernel` in interpret mode, at the
    sizes of tests/test_pallas_bytesplit.py."""
    x = _mixed(np.random.default_rng(n), n)
    out, tots = jpb.split_encode(x, n, vbyte=vbyte, E=1 << 12,
                                 interpret=True)
    want = jpb.sections_to_bytes(out, tots)
    got = (bs.vbyte_encode_plain(_t(x)) if vbyte
           else bs.svb_encode_plain(_t(x))[1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [100, 5000, 70000])
def test_svb_decode_plain_equals_pallas_kernel(n):
    x = _mixed(np.random.default_rng(n + 1), n)
    control, data = _ref_svb(x)
    want = np.asarray(jpb.svb_decode(control, data, n, T_SEC=4,
                                     interpret=True)).reshape(-1)[:n]
    got = _u32(bs.svb_decode_plain(torch.from_numpy(control),
                                   torch.from_numpy(data), n))
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n", [100, 4096, 50000])
def test_vbyte_decode_plain_equals_pallas_kernel(n):
    x = _mixed(np.random.default_rng(n + 2), n)
    data = _ref_vbyte(x)
    want = np.asarray(jpb.vbyte_decode(data, n, GD=2,
                                       interpret=True)).reshape(-1)[:n]
    got = _u32(bs.vbyte_decode_plain(torch.from_numpy(data), n))
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n", SIZES)
def test_decode_plain_equals_xla(n):
    x = _mixed(np.random.default_rng(n + 3), n)
    data = _ref_vbyte(x)
    pad = np.concatenate([data, np.zeros(8, np.uint8)])
    want = np.asarray(jbs.vbyte_decode(jnp.asarray(pad), n=n))
    np.testing.assert_array_equal(
        _u32(bs.vbyte_decode_plain(torch.from_numpy(data), n)), want)
    control, sdata = _ref_svb(x)
    pad = np.concatenate([sdata, np.zeros(8, np.uint8)])
    want = np.asarray(jbs.svb_decode(jnp.asarray(control), jnp.asarray(pad),
                                     n=n))
    np.testing.assert_array_equal(
        _u32(bs.svb_decode_plain(torch.from_numpy(control),
                                 torch.from_numpy(sdata), n)), want)


@pytest.mark.parametrize("kmax", [1, 2, 3, 4, 5])
def test_every_vbyte_length(kmax):
    """Streams whose longest element has exactly kmax bytes, the edge
    values of every length included (2^28 and 2^31 as i32 bit patterns)."""
    rng = np.random.default_rng(kmax)
    hi = min((1 << (7 * kmax)) - 1, (1 << 32) - 1)
    x = rng.integers(0, hi + 1, size=9001, dtype=np.uint64).astype(np.uint32)
    edges = [v for k in range(kmax) for v in ((1 << (7 * k)) - 1, 1 << (7 * k))
             if v <= hi] + [hi]
    if kmax == 5:
        edges += [1 << 31, (1 << 31) - 1, (1 << 32) - 1]
    x[: len(edges)] = edges
    stream = bs.vbyte_encode_plain(_t(x))
    np.testing.assert_array_equal(stream.numpy(), _ref_vbyte(x))
    ends = np.flatnonzero((stream.numpy() & 0x80) == 0)
    assert int(np.diff(np.concatenate(([-1], ends))).max()) == kmax
    np.testing.assert_array_equal(_u32(bs.vbyte_decode_plain(stream, 9001)),
                                  x)
    control, data = bs.svb_encode_plain(_t(x))
    np.testing.assert_array_equal(
        _u32(bs.svb_decode_plain(control, data, 9001)), x)


def test_last_control_byte_is_partial():
    """n = 4k + r: the unused keys of the last control byte are 0."""
    for n in (1, 2, 3, 5, 6, 7):
        x = np.full(n, (1 << 32) - 1, np.uint32)
        control, data = bs.svb_encode_plain(_t(x))
        assert control.numel() == -(-n // 4) and data.numel() == 4 * n
        used = n % 4 or 4
        assert int(control[-1]) == (1 << (2 * used)) - 1


def test_decode_takes_the_first_n_elements():
    x = _mixed(np.random.default_rng(8), 1000)
    stream = bs.vbyte_encode_plain(_t(x))
    np.testing.assert_array_equal(_u32(bs.vbyte_decode_plain(stream, 700)),
                                  x[:700])
    control, data = bs.svb_encode_plain(_t(x))
    np.testing.assert_array_equal(
        _u32(bs.svb_decode_plain(control, data, 700)), x[:700])
    assert bs.vbyte_decode_plain(stream, 0).numel() == 0
    assert bs.svb_decode_plain(control, data, 0).numel() == 0


def test_truncated_vbyte_stream_raises():
    x = _mixed(np.random.default_rng(5), 300)
    data = _ref_vbyte(x)
    for short in (data[:-1], data[: len(data) // 2], data[:0]):
        with pytest.raises(ValueError, match="holds"):
            jpb._scan_vbyte(short, 300, 1 << 14)
        with pytest.raises(ValueError, match="holds"):
            bs.vbyte_decode_plain(torch.from_numpy(short.copy()), 300)
        with pytest.raises(ValueError, match="holds"):
            bs.vbyte_decode(torch.from_numpy(short.copy()), 300)


def test_six_byte_element_raises():
    x = _mixed(np.random.default_rng(6), 300)
    data = _ref_vbyte(x)
    bad = np.concatenate([data[:40], np.full(5, 0x80, np.uint8), data[40:]])
    # byte 39 may end an element or not: either way one element has >= 6
    with pytest.raises(ValueError, match="corrupt"):
        jpb._scan_vbyte(bad, 300, 1 << 14)
    with pytest.raises(ValueError, match="corrupt"):
        bs.vbyte_decode_plain(torch.from_numpy(bad), 300)
    # past the elements asked for, a long element is not looked at
    n_before = int(((data[:40] & 0x80) == 0).sum())
    np.testing.assert_array_equal(
        _u32(bs.vbyte_decode_plain(torch.from_numpy(bad), n_before)),
        x[:n_before])


def test_short_streamvbyte_stream_raises():
    x = _mixed(np.random.default_rng(7), 301)
    control, data = bs.svb_encode_plain(_t(x))
    with pytest.raises(ValueError, match="corrupt"):
        bs.svb_decode_plain(control, data[:-1], 301)
    with pytest.raises(ValueError, match="corrupt"):
        bs.svb_decode(control[:-1], data, 301)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    x = _t(_mixed(np.random.default_rng(9), 500))
    counts = (bs.encode_launches, bs.svb_decode_launches,
              bs.vbyte_decode_launches)
    stream = bs.vbyte_encode(x)
    assert torch.equal(stream, bs.vbyte_encode_plain(x))
    assert torch.equal(bs.vbyte_decode(stream, 500), x)
    control, data = bs.svb_encode(x)
    assert torch.equal(bs.svb_decode(control, data, 500), x)
    assert (bs.encode_launches, bs.svb_decode_launches,
            bs.vbyte_decode_launches) == counts


@pytest.mark.parametrize("fn", [bs.vbyte_encode, bs.svb_encode])
def test_encode_refuses_bad_input(fn):
    with pytest.raises(ValueError, match="empty"):
        fn(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fn(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="uint8"):
        bs.vbyte_decode(torch.zeros(4, dtype=torch.int32), 1)


@pytest.mark.parametrize("n", [1, bs.ENCODE_CHUNK - 1, bs.ENCODE_CHUNK,
                               bs.ENCODE_CHUNK + 1, bs.DECODE_CHUNK - 1,
                               bs.DECODE_CHUNK, bs.DECODE_CHUNK + 1, 1 << 25])
def test_chained_scratch_sizing(n):
    """K7 and K9's scratch: a status word for each chunk, the ticket, the
    grand total and the flag word, zeroed; K9's chunks are cut at 16-byte
    boundaries of the address space, so a stream's address moves its
    count."""
    chunks = bs.encode_chunks(n)
    assert chunks == -(-n // bs.ENCODE_CHUNK)
    assert (chunks - 1) * bs.ENCODE_CHUNK < n <= chunks * bs.ENCODE_CHUNK
    scratch = bs.chained_scratch(chunks, "cpu")
    assert scratch.dtype == torch.int64 and scratch.numel() == chunks + 3
    assert not scratch.any()
    C = bs.DECODE_CHUNK
    for address in (0, 16, 4096):
        assert bs.decode_chunks(n, address) == -(-n // C)
    for address in (1, 15, 31):
        got = bs.decode_chunks(n, address)
        assert (got - 1) * C < address % 16 + n <= got * C
    assert bs.decode_chunks(C - 15, 15) == 1
    assert bs.decode_chunks(C - 15, 16 + 15) == 1
    assert bs.decode_chunks(C - 14, 15) == 2


@pytest.mark.parametrize("n", [1, bs.SVB_CHUNK - 1, bs.SVB_CHUNK,
                               bs.SVB_CHUNK + 1, 1 << 25])
def test_svb_chunks_sizing(n):
    """K8's scratch: chunks of SVB_CHUNK elements, the last one partial, and
    the same zeroed scratch as K7 and K9 (a status word for each chunk, the
    ticket, then the data length the n elements take)."""
    chunks = bs.svb_chunks(n)
    assert chunks == -(-n // bs.SVB_CHUNK)
    assert (chunks - 1) * bs.SVB_CHUNK < n <= chunks * bs.SVB_CHUNK
    scratch = bs.chained_scratch(chunks, "cpu")
    assert scratch.dtype == torch.int64 and scratch.numel() == chunks + 3
    assert not scratch.any()
