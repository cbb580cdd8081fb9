"""Semi-static arithmetic coder baseline.

Counterpart of the reference's 56-bit Moffat coder
(reference: include/arith.hpp:57-483: scaled pow2 cumulative model,
carry-propagating byte-oriented encoder, binary-search decoder, recursive
prelude).  Re-designed as a classic carryless 32-bit range coder
(Subbotin scheme) with the same model discipline (histogram scaled to a
power-of-two total, every present symbol >= 1) and this framework's
vbyte+interp prelude; the wire format is self-defined (the reference's
is its own too — no cross-compatibility requirement for baselines).

Host implementation: each range-coder chain is inherently sequential
(single carry chain), so the payload rides FOUR independent substreams
(element i on chain i mod 4, the same discipline as the shuff payload:
vbyte(len s0..s2) then the concatenated streams) decoded round-robin
by compiled loops in the native backend (ans_native.cpp
arith_encode4/arith_decode4; the reference's coder is one compiled
sequential chain, arith.hpp:245-483), with the original NumPy/Python
loops kept as the bit-identical no-native fallback.  It exists as a
measurement baseline, not a north-star target (SURVEY.md section 7
step 5).

A copy of ans_tpu/models/arith.py: its hot loops run in the port's host
library (ans_tpu_torch/native) through the module global `_native`
(native.deferred); each pure-Python body is the plain version, run
when `_native` is None.
"""

from __future__ import annotations

import bisect
import time

import numpy as np

from ..native import deferred as _native
from ..reference_model import interp, vbyte
from ..utils.stats import record_stats


_TOP = 1 << 56
_BOT = 1 << 48
_MASK = (1 << 64) - 1
_W = 64


def _scale_counts(counts: np.ndarray, total_log2: int) -> np.ndarray:
    """Scale positive counts to sum exactly 2**total_log2, each >= 1
    (model discipline of arith.hpp:210-241).  The correction is
    vectorized: the old one-unit-at-a-time loop was O(sigma * |diff|)
    and effectively hung on heavy-hitter histograms (one dominant
    symbol + tens of thousands of singletons puts the whole deficit on
    a single decrementable entry)."""
    target = 1 << total_log2
    c = counts.astype(np.float64)
    s = np.maximum((c * target / c.sum()).astype(np.int64), 1)
    diff = int(target - s.sum())
    if diff > 0:
        # distribute the surplus round-robin, largest entries first
        order = np.argsort(-s)
        q, r = divmod(diff, len(s))
        s += q
        s[order[:r]] += 1
    elif diff < 0:
        # waterfill the deficit over the entries with room (s > 1):
        # every giver gives min(room, k) for the smallest level k that
        # covers the deficit, then the excess is returned
        need = -diff
        room = s - 1
        rs = np.sort(room)
        csum = np.concatenate(([0], np.cumsum(rs)))
        m = len(rs)
        lo, hi = 0, int(room.max())
        while lo < hi:
            mid = (lo + hi) // 2
            j = int(np.searchsorted(rs, mid, side="left"))
            if csum[j] + (m - j) * mid >= need:
                hi = mid
            else:
                lo = mid + 1
        give = np.minimum(room, lo)
        excess = int(give.sum()) - need
        if excess > 0:
            cand = np.flatnonzero(give == lo)
            give[cand[:excess]] -= 1
        s -= give
    return s


# beyond this live-alphabet size the frequency table itself is coded by
# a RECURSIVE arith pass instead of the interp cumulative — the twin of
# the reference's PREL_RECURSE scheme (arith.hpp:280-286,405-411); the
# recursion terminates because each level's alphabet is the set of
# distinct frequency values of the previous one
PREL_ARITH_MIN_SIGMA = 1025
_MAX_PREL_DEPTH = 8


class Arith:
    name = "arith"

    def __init__(self, _depth: int = 0):
        self._depth = _depth

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        t0 = time.perf_counter_ns()
        lib = _native
        max_sym = int(values.max())
        counts = (lib.hist_u32(values, max_sym + 1) if lib is not None
                  else np.bincount(values, minlength=max_sym + 1))
        syms = np.flatnonzero(counts)
        sigma = len(syms)
        # model total ~ n: scaled freqs stay near the exact counts (the
        # reference codes with the EXACT counts, total = n; the old
        # sigma-driven total quantized zipf-2^20 to avg freq 2 and lost
        # ~0.4 bits/int to the per-symbol >= 1 floors)
        total_log2 = min(31, max(16, sigma.bit_length() + 1,
                                 (len(values) - 1).bit_length()))
        freq = _scale_counts(counts[syms], total_log2)
        cum = np.concatenate(([0], np.cumsum(freq)))
        total = int(cum[-1])

        out = bytearray()
        out += vbyte.encode_u32(max_sym)
        out += vbyte.encode_u32(sigma)
        out.append(total_log2)
        pre = interp.encode(syms, sigma, max_sym + 1)
        out += vbyte.encode_u32(len(pre))
        out += pre
        if (sigma >= PREL_ARITH_MIN_SIGMA
                and self._depth < _MAX_PREL_DEPTH):
            out.append(1)  # recursive-arith frequency table
            sub = Arith(self._depth + 1).encode(
                (freq - 1).astype(np.uint32))
            out += vbyte.encode_u32(len(sub))
            out += sub
        else:
            out.append(0)  # interp cumulative frequency table
            inc = np.cumsum(freq + 1) - 1
            pre2 = interp.encode(inc, sigma, total + sigma + 1)
            out += vbyte.encode_u32(len(pre2))
            out += pre2
        t1 = time.perf_counter_ns()

        prelude_len = len(out)
        # 4 interleaved substreams (element i rides chain i mod 4), the
        # same discipline as the shuff payload: four independent carry
        # chains overlap the serial range updates and the per-symbol
        # model gather.  The native path reads a VALUE-indexed packed
        # table (cum<<32|freq), fusing the dense-rank remap away.
        if lib is not None:
            vcumfq = np.zeros(max_sym + 1, dtype=np.uint64)
            vcumfq[syms] = ((cum[:-1].astype(np.uint64) << np.uint64(32))
                            | freq.astype(np.uint64))
            streams = lib.arith_encode4(values, vcumfq, total_log2)
        else:
            rank = np.zeros(max_sym + 1, dtype=np.uint32)
            rank[syms] = np.arange(sigma, dtype=np.uint32)
            ids = rank[values]
            streams = [self._encode_payload_python(cum, freq, ids[j::4],
                                                   total)
                       for j in range(4)]
        for j in range(3):
            out += vbyte.encode_u32(len(streams[j]))
        # one-pass assembly (see models/shuff.py): each stream is a
        # memoryview into the native output buffer, copied exactly once
        blob = b"".join([bytes(out), *streams])
        record_stats(prelude_bytes=prelude_len,
                     encode_bytes=len(blob) - prelude_len,
                     prelude_time_ns=t1 - t0,
                     encode_time_ns=time.perf_counter_ns() - t1)
        return blob

    @staticmethod
    def _encode_payload_python(cum, freq, ids, total) -> bytes:
        lo_arr = cum[ids].tolist()
        f_arr = freq[ids].tolist()
        low, rng = 0, _MASK
        payload = bytearray()
        for lo_, f_ in zip(lo_arr, f_arr):
            r = rng // total
            low = (low + r * lo_) & _MASK
            rng = r * f_
            while True:
                if (low ^ (low + rng)) < _TOP:
                    pass
                elif rng < _BOT:
                    rng = (-low) & (_BOT - 1)
                else:
                    break
                payload.append((low >> 56) & 0xFF)
                low = (low << 8) & _MASK
                rng = (rng << 8) & _MASK
        for _ in range(8):
            payload.append((low >> 56) & 0xFF)
            low = (low << 8) & _MASK
        return bytes(payload)

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        max_sym, pos = vbyte.decode_u32(buf, 0)
        sigma, pos = vbyte.decode_u32(buf, pos)
        total_log2 = buf[pos]
        pos += 1
        # forged total_log2 outside the encoder's range would shift u64
        # by >= 64 (UB) and blow up the second interp universe — reject
        # before using it
        if not (16 <= total_log2 <= 31):
            raise ValueError(
                f"corrupt arith stream: total_log2 {total_log2} outside "
                f"the encoder's [16, 31] range")
        plen, pos = vbyte.decode_u32(buf, pos)
        syms, _ = interp.decode(buf[pos:pos + plen + 8], sigma, max_sym + 1)
        pos += plen
        if pos >= len(buf):
            raise ValueError("corrupt arith stream: truncated prelude")
        mode = buf[pos]
        pos += 1
        total = 1 << total_log2
        if mode == 1:
            if self._depth >= _MAX_PREL_DEPTH:
                raise ValueError("corrupt arith stream: prelude "
                                 "recursion too deep")
            plen2, pos = vbyte.decode_u32(buf, pos)
            sub = Arith(self._depth + 1).decode(buf[pos:pos + plen2],
                                                sigma)
            pos += plen2
            freq = sub.astype(np.int64) + 1
        elif mode == 0:
            plen2, pos = vbyte.decode_u32(buf, pos)
            inc, _ = interp.decode(buf[pos:pos + plen2 + 8], sigma,
                                   total + sigma + 1)
            pos += plen2
            inc = np.asarray(inc, dtype=np.int64)
            freq = np.diff(np.concatenate(([-1], inc))) - 1
            freq[0] = int(inc[0])
        else:
            raise ValueError(
                f"corrupt arith stream: unknown prelude mode {mode}")
        # corrupt-wire guard BEFORE either coder loop: a zero/negative
        # frequency (non-increasing interp prelude) makes rng collapse
        # to 0 and the next (code-low)/r divide by zero — SIGFPE in the
        # native loop, ZeroDivisionError in Python
        if len(freq) == 0 or freq.min() < 1 or int(freq.sum()) != total:
            raise ValueError("corrupt arith stream: invalid frequency "
                             "table in prelude")
        cum = np.concatenate(([0], np.cumsum(freq)))
        syms = np.asarray(syms, dtype=np.uint32)
        slen = []
        for _ in range(3):
            l, pos = vbyte.decode_u32(buf, pos)
            slen.append(l)
        payload = memoryview(buf)[pos:]
        if sum(slen) > len(payload):
            raise ValueError("corrupt arith stream (substream lengths "
                             "exceed payload)")
        slen.append(len(payload) - sum(slen))
        lib = _native
        if lib is not None:
            ids = lib.arith_decode4(payload, slen, cum, total_log2, n)
            return syms[ids]
        cum_l = cum.tolist()
        freq_l = freq.tolist()
        out = np.empty(n, dtype=np.uint32)
        off = 0
        for j in range(4):
            nj = (n - j + 3) // 4
            ids = self._decode_payload_python(
                payload, off, off + slen[j], cum_l, freq_l, total, nj)
            out[j::4] = syms[ids]
            off += slen[j]
        return out

    @staticmethod
    def _decode_payload_python(buf, start, end, cum_l, freq_l, total,
                               n):
        low, rng, code = 0, _MASK, 0
        p = start
        for _ in range(8):
            code = ((code << 8) | (buf[p] if p < end else 0)) & _MASK
            p += 1
        out = np.empty(n, dtype=np.uint32)
        for i in range(n):
            r = rng // total
            if r == 0:
                raise ValueError(
                    "corrupt arith stream (range collapsed)")
            target = min(((code - low) & _MASK) // r, total - 1)
            k = bisect.bisect_right(cum_l, target) - 1
            out[i] = k
            low = (low + r * cum_l[k]) & _MASK
            rng = r * freq_l[k]
            while True:
                if (low ^ (low + rng)) < _TOP:
                    pass
                elif rng < _BOT:
                    rng = (-low) & (_BOT - 1)
                else:
                    break
                code = ((code << 8) | (buf[p] if p < end else 0)) \
                    & _MASK
                low = (low << 8) & _MASK
                rng = (rng << 8) & _MASK
                p += 1
        return out
