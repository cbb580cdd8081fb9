"""OptPFor-style patched frame-of-reference codec.

Counterpart of the reference's FastPFor OPTPFor<128> + VariableByte
composite (reference: include/methods.hpp:61-87).  Re-designed, not a
port of FastPFor: per 128-int block, every bit width b is costed exactly
(payload 128*b bits + exception list of positions and overflow high
bits) and the cheapest is chosen — the "Opt" in OptPFor.  Wire format is
self-defined; the tail (n mod 128) is vbyte-coded like the reference's
VariableByte composite stage.

Block layout: u8 b | u8 n_exc | n_exc * u8 positions
              | n_exc * vbyte(value >> b) | ceil(128*b/8) payload bytes

A copy of ans_tpu/models/pfor.py (pure NumPy).
"""

from __future__ import annotations

import time

import numpy as np

from ..reference_model import vbyte
from ..utils.stats import record_stats

BLOCK = 128


def _pack_bits(vals: np.ndarray, b: int) -> bytes:
    """Pack BLOCK values of b bits each, LSB-first per value."""
    if b == 0:
        return b""
    bits = ((vals[:, None] >> np.arange(b, dtype=np.uint32)) & 1).astype(
        np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _unpack_bits(buf: bytes, b: int) -> np.ndarray:
    if b == 0:
        return np.zeros(BLOCK, dtype=np.uint32)
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                         count=BLOCK * b, bitorder="little")
    bits = bits.reshape(BLOCK, b).astype(np.uint32)
    return (bits << np.arange(b, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)


def _best_width(vals: np.ndarray) -> int:
    nbits = np.zeros(BLOCK, dtype=np.int64)
    nz = vals > 0
    nbits[nz] = np.floor(np.log2(vals[nz].astype(np.float64))).astype(
        np.int64) + 1
    best_b, best_cost = 32, 1 << 60
    over_bytes = np.maximum(0, -(-(nbits[:, None]
                                   - np.arange(33)) // 7))
    for b in range(33):
        exc = nbits > b
        n_exc = int(exc.sum())
        if n_exc > 255:
            continue
        cost = 2 + n_exc + int(over_bytes[exc, b].sum()) + (BLOCK * b + 7) // 8
        if cost < best_cost:
            best_cost, best_b = cost, b
    return best_b


# cost tables indexed by (value bit length v, width b): exception flag
# and vbyte bytes of the overflow high part — the per-block cost is then
# a histogram-times-table product, so width selection is one matmul for
# ALL blocks (same argmin-by-lowest-b tie rule as _best_width)
_BS = np.arange(33, dtype=np.int64)
_EXC_T = (_BS[:, None] > _BS).astype(np.int64)            # (v, b)
_OVER_T = np.maximum(0, -(-(_BS[:, None] - _BS) // 7))    # (v, b)


def _best_width_all(blocks: np.ndarray) -> np.ndarray:
    """Vectorized _best_width over (NB, BLOCK) blocks -> (NB,) widths."""
    nbits = np.zeros(blocks.shape, dtype=np.int64)
    nz = blocks > 0
    nbits[nz] = np.floor(np.log2(blocks[nz].astype(np.float64))).astype(
        np.int64) + 1
    hist = np.zeros((len(blocks), 33), dtype=np.int64)
    for v in range(33):
        hist[:, v] = (nbits == v).sum(axis=1)
    n_exc = hist @ _EXC_T
    cost = 2 + n_exc + hist @ _OVER_T + 16 * _BS
    cost[n_exc > 255] = 1 << 60
    return cost.argmin(axis=1)


def _vbyte_np(vals: np.ndarray):
    """Batch 7-bit varints (wire = vbyte.encode_u32): returns
    (bytes, per-value byte lengths)."""
    vals = np.asarray(vals, dtype=np.uint32)
    if len(vals) == 0:
        return b"", np.zeros(0, np.int64)
    ln = np.ones(len(vals), dtype=np.int64)
    for t in (7, 14, 21, 28):
        ln += vals >= (1 << t)
    pos = np.concatenate(([0], np.cumsum(ln)[:-1]))
    out = np.zeros(int(ln.sum()), dtype=np.uint8)
    for j in range(5):
        m = ln > j
        if not m.any():
            break
        out[pos[m] + j] = (((vals[m] >> np.uint32(7 * j)) & 0x7F)
                           | np.where(j + 1 < ln[m], 0x80, 0))
    return out.tobytes(), ln


class OptPFor:
    name = "OptPFor"

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        t0 = time.perf_counter_ns()
        n = len(values)
        nb = n // BLOCK
        tail_vb, _ = _vbyte_np(values[nb * BLOCK:])
        if nb == 0:
            record_stats(encode_bytes=len(tail_vb),
                         encode_time_ns=time.perf_counter_ns() - t0)
            return tail_vb
        blocks = values[: nb * BLOCK].reshape(nb, BLOCK)
        widths = _best_width_all(blocks)
        # exceptions, all blocks at once (b = 32 shifts are UB in C but
        # exact via uint64)
        highs = (blocks.astype(np.uint64)
                 >> widths[:, None].astype(np.uint64))
        exc_mask = highs > 0
        n_exc = exc_mask.sum(axis=1)
        all_high = highs[exc_mask].astype(np.uint32)
        vb_all, vb_len = _vbyte_np(all_high)
        vb_off = np.concatenate(([0], np.cumsum(vb_len)))
        exc_off = np.concatenate(([0], np.cumsum(n_exc)))
        vb_blk = vb_off[exc_off]              # vb bytes before block i
        # one output buffer, all sections scattered in (no per-block
        # Python): block i spans [off[i], off[i+1]) =
        # 2 | n_exc positions | their varints | 16*b payload
        piece_len = 2 + n_exc + (vb_blk[1:] - vb_blk[:-1]) + 16 * widths
        off = np.concatenate(([0], np.cumsum(piece_len)))
        buf = np.zeros(int(off[-1]), dtype=np.uint8)
        buf[off[:-1]] = widths
        buf[off[:-1] + 1] = n_exc
        blk_of_exc = np.repeat(np.arange(nb), n_exc)
        pos_base = off[blk_of_exc] + 2
        buf[pos_base + (np.arange(len(all_high)) - exc_off[blk_of_exc])
            ] = np.where(exc_mask)[1]
        # varint bytes: per-value dest start, then per-byte offsets
        vb_start = (off[blk_of_exc] + 2 + n_exc[blk_of_exc]
                    + vb_off[:-1] - vb_blk[blk_of_exc])
        byte_dst = (np.repeat(vb_start, vb_len)
                    + np.arange(int(vb_off[-1]))
                    - np.repeat(vb_off[:-1], vb_len))
        buf[byte_dst] = np.frombuffer(vb_all, np.uint8)
        # payloads batched per distinct width (16*b bytes/block)
        pay_dst = off[:-1] + 2 + n_exc + (vb_blk[1:] - vb_blk[:-1])
        for b in np.unique(widths):
            if b == 0:
                continue
            rows = np.flatnonzero(widths == b)
            low = blocks[rows] & np.uint32((1 << int(b)) - 1
                                           if b < 32 else 0xFFFFFFFF)
            bits = ((low[:, :, None]
                     >> np.arange(b, dtype=np.uint32)) & 1)
            packed = np.packbits(bits.reshape(len(rows), -1).astype(
                np.uint8), axis=1, bitorder="little")
            buf[pay_dst[rows][:, None]
                + np.arange(16 * int(b))] = packed
        out = buf.tobytes() + tail_vb
        # no separate model/prelude phase: per-block headers ride the
        # stream, so the whole cost is encode time (P7 split)
        record_stats(encode_bytes=len(out),
                     encode_time_ns=time.perf_counter_ns() - t0)
        return out

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        pos = 0
        nb = n // BLOCK
        for i in range(nb):
            b = buf[pos]
            n_exc = buf[pos + 1]
            pos += 2
            exc_pos = np.frombuffer(buf, dtype=np.uint8, count=n_exc,
                                    offset=pos)
            pos += n_exc
            highs = np.empty(n_exc, dtype=np.uint32)
            for j in range(n_exc):
                h, pos = vbyte.decode_u32(buf, pos)
                highs[j] = h
            nbytes = (BLOCK * b + 7) // 8
            vals = _unpack_bits(buf[pos:pos + nbytes], b)
            pos += nbytes
            if n_exc:
                vals[exc_pos] |= highs << np.uint32(b)
            out[i * BLOCK:(i + 1) * BLOCK] = vals
        for i in range(nb * BLOCK, n):
            v, pos = vbyte.decode_u32(buf, pos)
            out[i] = v
        return out
