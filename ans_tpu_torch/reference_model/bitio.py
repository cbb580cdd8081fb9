"""Bit-level I/O over little-endian u32 words (NumPy golden model).
A copy of ans_tpu/reference_model/bitio.py, held equal to it through
the interp and prelude tests of tests/test_torch_host.py.

Behavioral re-expression of the reference's buffered bit stream
(reference: include/bits.hpp:146-218 `bit_stream`, :49-105 read/write_int):
values are written LSB-first into consecutive 32-bit little-endian words.
One deliberate difference: the reference leaves the unused high bits of the
final partial word uninitialized (stack garbage); we zero them, so streams
are fully deterministic.  Decoders never read those bits.
"""

from __future__ import annotations


class BitWriter:
    """Append-only bit stream; bits fill each u32 word from the LSB."""

    __slots__ = ("_words", "_cur", "_off")

    def __init__(self) -> None:
        self._words: list[int] = []
        self._cur = 0  # current (partial) word
        self._off = 0  # bits used in current word

    def put(self, val: int, bits: int) -> None:
        if bits == 0:
            return
        val &= (1 << bits) - 1
        self._cur |= val << self._off
        self._off += bits
        while self._off >= 32:
            self._words.append(self._cur & 0xFFFFFFFF)
            self._cur >>= 32
            self._off -= 32

    def flush(self) -> bytes:
        """Byte stream of all complete words plus a zero-padded partial word."""
        words = list(self._words)
        if self._off:
            words.append(self._cur & 0xFFFFFFFF)
        out = bytearray()
        for w in words:
            out += w.to_bytes(4, "little")
        return bytes(out)


class BitReader:
    """Reads bits LSB-first from a byte buffer viewed as u32 LE words.

    May read up to one whole word past the last logical bit, like the
    reference's double-buffered reader; callers must ensure the buffer has
    enough physical bytes (ans preludes are followed by stream bytes, and we
    pad when standalone).
    """

    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes, bit_offset: int = 0) -> None:
        self._buf = buf
        self._pos = bit_offset

    def get(self, bits: int) -> int:
        if bits == 0:
            return 0
        p = self._pos
        self._pos = p + bits
        byte0 = p >> 3
        # read enough bytes to cover the span (max 32 bits + 7 bit skew)
        chunk = self._buf[byte0 : byte0 + 8]
        v = int.from_bytes(chunk.ljust(8, b"\0"), "little")
        return (v >> (p & 7)) & ((1 << bits) - 1)

    @property
    def bit_pos(self) -> int:
        return self._pos

    def words_consumed(self) -> int:
        """Number of u32 words touched so far (ceil of bit position / 32)."""
        return (self._pos + 31) // 32
