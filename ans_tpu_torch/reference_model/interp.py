"""Binary interpolative coding of strictly-increasing u32 sequences.
A copy of ans_tpu/reference_model/interp.py, held equal to it by
tests/test_torch_host.py: its C++ fast path goes through the port's own
host library (ans_tpu_torch/native), and each pure-Python body is that
call's plain version (it runs when `_native` is None).

Behavioral re-expression of the reference's recursive interpolative coder
(reference: include/interp.hpp:25-119): centered minimal-binary codes
(write/read_center_mid, interp.hpp:28-63) around the midpoint element,
recursing on both halves.  Produces bit-identical payloads (up to the
reference's uninitialized final-word padding, which we zero).

The recursion is converted to an explicit stack so large alphabets
(sigma up to 2**20+) do not hit Python's recursion limit.
"""

from __future__ import annotations

import numpy as np

from ..native import deferred as _native
from .bitio import BitReader, BitWriter


def _hi(x: int) -> int:
    """floor(log2(x)) with hi(0)=0 (reference: bits.hpp:34-40)."""
    return x.bit_length() - 1 if x > 0 else 0


def _write_center_mid(w: BitWriter, val: int, u: int) -> None:
    # reference: interp.hpp:28-46
    if u == 1:
        return
    b = _hi(u - 1) + 1
    d = 2 * u - (1 << b)
    val = val + (u - (d >> 1))
    if val > u:
        val -= u
    m = (1 << b) - u
    if val <= m:
        w.put(val - 1, b - 1)
    else:
        val += m
        w.put((val - 1) >> 1, b - 1)
        w.put((val - 1) & 1, 1)


def _read_center_mid(r: BitReader, u: int) -> int:
    # reference: interp.hpp:47-63
    b = 0 if u == 1 else _hi(u - 1) + 1
    d = 2 * u - (1 << b)
    val = 1
    if u != 1:
        m = (1 << b) - u
        val = r.get(b - 1) + 1
        if val > m:
            val = (2 * val + r.get(1)) - m - 1
    val = val + (d >> 1)
    if val > u:
        val -= u
    return val


def encode(seq, n: int, u: int) -> bytes:
    """Encode seq[0:n] (strictly increasing, values in [0, u)) over universe u.

    Matches interpolative_internal::encode (interp.hpp:100-108): internally
    values are shifted by +1 ("we don't encode 0") and coded in [1, u+1].
    Returns the byte stream (whole little-endian u32 words).
    """
    if _native is not None:
        return _native.interp_encode(
            np.ascontiguousarray(seq, dtype=np.uint64), n, int(u))
    w = BitWriter()
    # stack of (start, n, low, high); mid-first pre-order like the recursion
    stack = [(0, n, 1, u + 1)]
    while stack:
        start, cnt, low, high = stack.pop()
        if cnt == 0:
            continue
        h = (cnt + 1) >> 1
        n1 = h - 1
        n2 = cnt - h
        v = int(seq[start + h - 1]) + 1
        _write_center_mid(w, v - low - n1 + 1, high - n2 - low - n1 + 1)
        # recursion order: left half first -> push right first
        stack.append((start + h, n2, v + 1, high))
        stack.append((start, n1, low, v - 1))
    return w.flush()


def decode(buf: bytes, n: int, u: int, bit_offset: int = 0):
    """Decode n values over universe u; returns (values, words_consumed)."""
    if _native is not None:
        return _native.interp_decode(bytes(buf), n, int(u), bit_offset)
    r = BitReader(buf, bit_offset)
    out = [0] * n
    stack = [(0, n, 1, u + 1)]
    while stack:
        start, cnt, low, high = stack.pop()
        if cnt == 0:
            continue
        h = (cnt + 1) >> 1
        n1 = h - 1
        n2 = cnt - h
        v = low + n1 - 1 + _read_center_mid(r, high - n2 - low - n1 + 1)
        out[start + h - 1] = v - 1
        stack.append((start + h, n2, v + 1, high))
        stack.append((start, n1, low, v - 1))
    words = (r.bit_pos - bit_offset + 31) // 32
    return out, words
