"""7-bit-per-byte varint for u32 (reference: include/vbyte.hpp:32-95).
A copy of ans_tpu/reference_model/vbyte.py."""

from __future__ import annotations


def encode_u32(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_u32(buf, pos: int = 0):
    """Returns (value, new_pos)."""
    x = 0
    shift = 0
    while True:
        c = buf[pos]
        pos += 1
        x += (c & 0x7F) << shift
        if not (c & 0x80):
            return x, pos
        shift += 7
