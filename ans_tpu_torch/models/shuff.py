"""Semi-static canonical minimum-redundancy (Huffman) coder.

Counterpart of the reference's one-file shuff port
(reference: include/shuff.hpp:734-897: Moffat-Katajainen codeword
lengths, canonical min_code/lj_base arrays, interp-coded symbol set
prelude, LUT-accelerated left-justified decode).  Re-designed rather
than translated: lengths come from the classic heap merge over the
histogram, the prelude reuses this framework's vbyte+interp primitives,
and the bit streams are plain MSB-first byte sequences so both hot
loops run either in the native backend (ans_native.cpp shuff_pack /
shuff_unpack, 16-bit-LUT canonical decode) or as vectorized NumPy
(encode: one bitwise_or scatter per word half; decode: per-symbol
fallback loop).

Format: vbyte(max_sym) | vbyte(sigma) | vbyte(max_len)
        | interp(sorted distinct symbols, universe max_sym+1)
        | 6-bit code lengths per distinct symbol, MSB-first, byte-padded
        | vbyte(len s0) | vbyte(len s1) | vbyte(len s2)
        | payload: 4 concatenated substreams s0..s3 (s3's length is the
          remainder); substream j holds the canonical codes of elements
          i with i mod 4 == j, MSB-first, byte-padded

Codeword lengths are limited to 32 bits (freq-halving flatten for the
pathological cases), so every code fits a u32.  The 4-substream split
is the reference's interleaved-ANS-states trick (ans_int.hpp:225-241)
applied to Huffman: a single canonical-decode chain is latency-bound
(refill -> LUT -> canonical lookup, ~11 ns/sym on 16-bit codes); four
independent chains decoded round-robin overlap those latencies and
roughly double both directions on this host.

A copy of ans_tpu/models/shuff.py: its hot loops run in the port's host
library (ans_tpu_torch/native) through the module global `_native`
(native.deferred); each pure-Python body is the plain version, run
when `_native` is None.
"""

from __future__ import annotations

import time

import numpy as np

from ..native import deferred as _native
from ..reference_model import interp, vbyte
from ..utils.stats import record_stats



def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths for positive freqs (Huffman tree depth;
    same lengths as the reference's in-place Moffat-Katajainen
    calculation, shuff.hpp:451-513).  Native path: sort + O(sigma)
    two-queue merge (the Python heap loop below capped encode at ~3M
    ints/s on sigma ~ 10^6 alphabets); heap merge + one top-down depth
    pass over the parent array as the no-native fallback (parents are
    created after children, so a reverse-creation-order sweep resolves
    every depth)."""
    sigma = len(freqs)
    if sigma == 1:
        return np.array([1], dtype=np.int64)
    lib = _native
    if lib is not None:
        order = np.argsort(freqs, kind="stable")
        out = np.empty(sigma, dtype=np.int64)
        out[order] = lib.huff_code_lengths(
            np.asarray(freqs, dtype=np.uint64)[order])
        return out
    import heapq
    h = [(int(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(h)
    parent = np.full(2 * sigma - 1, -1, dtype=np.int64)
    next_id = sigma
    while len(h) > 1:
        fa, a = heapq.heappop(h)
        fb, b = heapq.heappop(h)
        parent[a] = parent[b] = next_id
        heapq.heappush(h, (fa + fb, next_id))
        next_id += 1
    depth = np.zeros(2 * sigma - 1, dtype=np.int64)
    for node in range(next_id - 2, -1, -1):
        depth[node] = depth[parent[node]] + 1
    return depth[:sigma]


def limited_code_lengths(freqs: np.ndarray, cap: int = 32) -> np.ndarray:
    """code_lengths with a depth cap: halve frequencies until the tree
    fits (cheap length-limit heuristic; only pathological skews with
    huge n ever trigger it)."""
    f = np.asarray(freqs, dtype=np.uint64)
    lens = code_lengths(f)
    while int(lens.max()) > cap:
        f = (f + 1) >> np.uint64(1)
        lens = code_lengths(f)
    return lens


def canonical_tables(lens: np.ndarray):
    """Canonical code assignment, vectorized.

    Returns (codes u32 per input index, order = argsort by (len, sym),
    first_code i64 (max_len+2,), first_idx i64 (max_len+2,))."""
    lens = np.asarray(lens, dtype=np.int64)
    max_len = int(lens.max())
    count_l = np.bincount(lens, minlength=max_len + 2)
    # stable counting sort by length (== lexsort((arange, lens)); a few
    # flatnonzero passes beat the general sort ~3x at sigma = 2^20)
    bucket0 = np.zeros(max_len + 2, dtype=np.int64)
    bucket0[1:] = np.cumsum(count_l)[:-1]
    order = np.empty(len(lens), dtype=np.int64)
    for l in np.flatnonzero(count_l):
        idx = np.flatnonzero(lens == l)
        order[bucket0[l]:bucket0[l] + len(idx)] = idx
    first_code = np.zeros(max_len + 2, dtype=np.int64)
    first_idx = np.zeros(max_len + 2, dtype=np.int64)
    code = idx = 0
    for l in range(1, max_len + 2):
        code <<= 1
        first_code[l] = code
        first_idx[l] = idx
        code += int(count_l[l]) if l <= max_len else 0
        idx += int(count_l[l]) if l <= max_len else 0
    slens = lens[order]
    rank_in_len = np.arange(len(lens)) - first_idx[slens]
    codes = np.zeros(len(lens), dtype=np.uint32)
    codes[order] = (first_code[slens] + rank_in_len).astype(np.uint32)
    return codes, order, first_code, first_idx


def _build_lut16(first_code, first_idx, max_len):
    """lut16[w] for the 16-bit MSB prefix w: the exact code length when
    it is <= 16, else the minimal length of any longer code with that
    prefix (the canonical scan starts there instead of blindly at 17).
    0 = no codeword has this prefix (corrupt stream).  Writing lengths
    in descending order makes the smallest match win; prefix-freeness
    keeps short-code extensions and long-code prefixes disjoint."""
    lut = np.zeros(1 << 16, dtype=np.uint8)
    for l in range(max_len, 16, -1):
        cnt = int(first_idx[l + 1] - first_idx[l])
        if cnt == 0:
            continue
        lo = int(first_code[l]) >> (l - 16)
        hi = ((int(first_code[l]) + cnt - 1) >> (l - 16)) + 1
        lut[lo:hi] = l
    for l in range(min(16, max_len), 0, -1):
        lo = int(first_code[l]) << (16 - l)
        hi = (int(first_code[l]) + int(first_idx[l + 1] - first_idx[l])) \
            << (16 - l)
        lut[lo:hi] = l
    return lut


def _pack_msb_numpy(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Vectorized MSB-first packer: each code lands in at most two
    64-bit big-endian words; one unbuffered bitwise_or scatter each."""
    vals = vals.astype(np.uint64)
    lens = lens.astype(np.uint64)
    ends = np.cumsum(lens)
    starts = ends - lens
    total = int(ends[-1]) if len(ends) else 0
    nwords = (total + 63) // 64 + 1
    W = np.zeros(nwords, dtype=np.uint64)
    w = (starts >> np.uint64(6)).astype(np.int64)
    o = starts & np.uint64(63)
    sh = (np.uint64(64) - o - lens).astype(np.int64)  # may be negative
    shp = (sh & 63).astype(np.uint64)
    shn = ((-sh) & 63).astype(np.uint64)
    lo = np.where(sh >= 0, vals << shp, vals >> shn)
    np.bitwise_or.at(W, w, lo)
    sp = np.maximum(-sh, 0).astype(np.uint64)
    spill = np.where(sp > 0,
                     (vals & ((np.uint64(1) << sp) - np.uint64(1)))
                     << ((np.uint64(64) - sp) & np.uint64(63)),
                     np.uint64(0))
    np.bitwise_or.at(W, w + 1, spill)
    return W.byteswap().tobytes()[: (total + 7) // 8]


def _unpack_msb_fixed(buf, n: int, width: int, offset: int = 0
                      ) -> np.ndarray:
    """n fixed-width MSB-first fields from a byte-padded stream (read
    at `offset` — no slice copy).  Shift-accumulate over the width
    beats the int64 matmul ~1.5x and stays O(n*width)."""
    nbytes = (n * width + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, count=nbytes,
                                       offset=offset))
    bits = bits[: n * width].reshape(n, width)
    out = np.zeros(n, dtype=np.int64)
    for k in range(width):
        out = (out << 1) | bits[:, k]
    return out


def _unpack_payload_numpy(payload, n, first_code, first_idx, max_len,
                          ssyms):
    """Fallback canonical decoder (per-symbol loop)."""
    out = np.empty(n, dtype=np.uint32)
    arr = np.frombuffer(payload, np.uint8)
    acc = 0
    nbits = 0
    pos = 0
    nbytes = len(arr)
    for i in range(n):
        while nbits <= 56 and pos < nbytes:
            acc |= int(arr[pos]) << (56 - nbits)
            pos += 1
            nbits += 8
        for l in range(1, max_len + 1):
            pfx = acc >> (64 - l)
            j = pfx - int(first_code[l])
            if 0 <= j < int(first_idx[l + 1] - first_idx[l]):
                if nbits < l:
                    # the zero-refilled accumulator can keep matching
                    # codewords past end-of-buffer; mirror the native
                    # truncation check instead of returning garbage
                    raise ValueError("corrupt shuff stream (truncated)")
                out[i] = ssyms[int(first_idx[l]) + j]
                acc = (acc << l) & ((1 << 64) - 1)
                nbits -= l
                break
        else:
            raise ValueError("corrupt shuff stream")
    return out


class Shuff:
    name = "shuff"

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
        lens = limited_code_lengths(counts[syms])
        codes, _, _, _ = canonical_tables(lens)
        max_len = int(lens.max())

        out = bytearray()
        out += vbyte.encode_u32(max_sym)
        out += vbyte.encode_u32(sigma)
        out += vbyte.encode_u32(max_len)
        out += interp.encode(syms, sigma, max_sym + 1)
        # 6-bit lens, MSB-first, byte-padded (model data -> prelude side
        # of the split, like the reference's RECORD_STATS accounting)
        out += self._pack(lens.astype(np.uint32),
                          np.full(sigma, 6, np.int64))
        prelude_len = len(out)
        t1 = time.perf_counter_ns()
        # payload: rank-map values to dense ids (native gather) and let
        # shuff_pack's own codes[id]/lens[id] indexing do the rest —
        # the numpy codes[rank[values]] double gather cost ~1.5 s at
        # n = 2^25
        # value-indexed code tables fuse the value -> dense-rank remap
        # into the pack itself (the intermediate ids array cost a full
        # 4n-byte write + random re-read per element: ~25% of encode at
        # sigma = 2^20); the packer is index-agnostic — it just reads
        # codes[x]/lens[x]
        vcodes = np.zeros(max_sym + 1, dtype=np.uint32)
        vcodes[syms] = codes
        vlens = np.zeros(max_sym + 1, dtype=np.uint8)
        vlens[syms] = lens.astype(np.uint8)
        if lib is not None:
            streams = lib.shuff_pack4(values, vcodes, vlens)
        else:
            streams = [_pack_msb_numpy(vcodes[values[j::4]],
                                       vlens[values[j::4]])
                       for j in range(4)]
        for j in range(3):
            out += vbyte.encode_u32(len(streams[j]))
        # one-pass assembly: b"".join copies each stream exactly once
        # (the old bytearray += / bytes(out) pair copied the payload
        # three times, ~15% of encode at 16-bit codes)
        blob = b"".join([bytes(out), *streams])
        record_stats(prelude_bytes=prelude_len,
                     encode_bytes=len(blob) - prelude_len,
                     prelude_time_ns=t1 - t0,
                     encode_time_ns=time.perf_counter_ns() - t1)
        return blob

    @staticmethod
    def _pack(vals, lens):
        lib = _native
        if lib is not None:
            ids = np.arange(len(vals), dtype=np.uint32)
            return lib.shuff_pack(ids, vals, lens)
        return _pack_msb_numpy(vals, lens)

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        max_sym, pos = vbyte.decode_u32(buf, 0)
        sigma, pos = vbyte.decode_u32(buf, pos)
        max_len, pos = vbyte.decode_u32(buf, pos)
        syms, words = interp.decode(buf, sigma, max_sym + 1,
                                    bit_offset=pos * 8)
        pos += words * 4
        lens = _unpack_msb_fixed(buf, sigma, 6, offset=pos)
        pos += (sigma * 6 + 7) // 8
        # the canonical tables are sized from the actual lens; a forged
        # header max_len larger than lens.max() would make the >16-bit
        # scan read first_code[] out of bounds in the native decoder
        if len(lens) == 0 or lens.min() < 1 or lens.max() > 32:
            raise ValueError("corrupt shuff prelude: code length out of "
                             "[1, 32]")
        if max_len != int(lens.max()):
            raise ValueError(
                f"corrupt shuff prelude: header max_len {max_len} != "
                f"actual {int(lens.max())}")
        _, order, first_code, first_idx = canonical_tables(lens)
        ssyms = np.asarray(syms, dtype=np.uint32)[order]
        slen = []
        for _ in range(3):
            l, pos = vbyte.decode_u32(buf, pos)
            slen.append(l)
        payload = memoryview(buf)[pos:]  # zero-copy (blob-sized slice)
        if sum(slen) > len(payload):
            raise ValueError("corrupt shuff stream (substream lengths "
                             "exceed payload)")
        slen.append(len(payload) - sum(slen))
        lib = _native
        if lib is not None:
            lut16 = _build_lut16(first_code, first_idx, max_len)
            return lib.shuff_unpack4(payload, slen, n, lut16,
                                     first_code, first_idx, max_len,
                                     ssyms)
        out = np.empty(n, dtype=np.uint32)
        off = 0
        for j in range(4):
            nj = (n - j + 3) // 4
            out[j::4] = _unpack_payload_numpy(
                payload[off:off + slen[j]], nj, first_code, first_idx,
                max_len, ssyms)
            off += slen[j]
        return out
