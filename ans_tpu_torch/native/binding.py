"""ctypes binding of the host library (native/ans_native.cpp, built by
native/build.py).  A copy of ans_tpu/native/binding.py's NativeLib that
loads the library from the path it is given; every function of the
library is bound."""

from __future__ import annotations

import ctypes as ct

import numpy as np

_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")


class NativeLib:
    """Thin typed wrapper; model.py/rans_compat.py call these."""

    def __init__(self, cdll: ct.CDLL):
        self._c = cdll
        c = cdll
        c.ans_entropy_ordered.restype = ct.c_double
        c.ans_entropy_ordered.argtypes = [_u64p, ct.c_int64, ct.c_uint64]
        c.ans_cross_entropy_ordered.restype = ct.c_double
        c.ans_cross_entropy_ordered.argtypes = [_u64p, ct.c_int64, _u32p,
                                                ct.c_int64]
        c.ans_scale_freqs.restype = ct.c_int32
        c.ans_scale_freqs.argtypes = [_u32p, _u64p, _i64p, ct.c_int64,
                                      ct.c_int64, ct.c_int64]
        c.ans_compat_encode.restype = ct.c_int64
        c.ans_compat_encode.argtypes = [_u32p, ct.c_int64, ct.c_void_p,
                                        ct.c_void_p, _u32p, _u32p,
                                        ct.c_int64, _u8p, ct.c_int64]
        c.ans_compat_decode.restype = ct.c_int64
        c.ans_compat_decode.argtypes = [_u8p, ct.c_int64, ct.c_int64,
                                        _u32p, _u32p, _u32p, ct.c_int64,
                                        ct.c_void_p, ct.c_void_p, _u32p]
        c.ans_mtf.restype = None
        c.ans_mtf.argtypes = [_u32p, ct.c_int64, ct.c_int64, _u32p]
        c.tans_encode.restype = ct.c_int64
        c.tans_encode.argtypes = [_u8p, ct.c_int64, _u8p, _u32p, _u32p,
                                  _u32p, _u32p, ct.c_int64, ct.c_int64,
                                  _u32p, _u8p, ct.c_int64]
        c.hist_u8.restype = None
        c.hist_u8.argtypes = [_u8p, ct.c_int64, _u64p]
        c.hist_u32.restype = None
        c.hist_u32.argtypes = [_u32p, ct.c_int64, _u64p]
        c.remap_u32.restype = None
        c.remap_u32.argtypes = [_u32p, _u32p, ct.c_int64, _u32p]
        c.huff_code_lengths.restype = None
        c.huff_code_lengths.argtypes = [_u64p, ct.c_int64, _i64p]
        c.tans_decode.restype = ct.c_int64
        c.tans_decode.argtypes = [_u8p, ct.c_int64, ct.c_int64, _u32p,
                                  _u8p, _u32p, ct.c_int64, _u32p, _u8p]
        c.ans_interp_encode.restype = ct.c_int64
        c.ans_interp_encode.argtypes = [_u64p, ct.c_int64, ct.c_uint64,
                                        _u8p, ct.c_int64]
        c.ans_interp_decode.restype = ct.c_int64
        c.ans_interp_decode.argtypes = [_u8p, ct.c_int64, ct.c_int64,
                                        ct.c_uint64, ct.c_int64, _u64p]
        c.shuff_pack.restype = ct.c_int64
        c.shuff_pack.argtypes = [_u32p, ct.c_int64, _u32p, _u8p, _u8p,
                                 ct.c_int64]
        c.shuff_unpack.restype = ct.c_int64
        c.shuff_unpack.argtypes = [_u8p, ct.c_int64, ct.c_int64, _u8p,
                                   _i64p, _i64p, ct.c_int64, _u32p, _u32p]
        c.shuff_pack4.restype = ct.c_int64
        c.shuff_pack4.argtypes = [_u32p, ct.c_int64, _u32p, _u8p,
                                  ct.c_int64, _u8p, ct.c_int64, _i64p]
        c.shuff_unpack4.restype = ct.c_int64
        c.shuff_unpack4.argtypes = [_u8p, _i64p, _i64p, ct.c_int64,
                                    _u8p, _i64p, _i64p, ct.c_int64,
                                    _u32p, _u32p]
        c.arith_encode4.restype = ct.c_int64
        c.arith_encode4.argtypes = [_u64p, _u32p, ct.c_int64,
                                    ct.c_uint32, _u8p, ct.c_int64, _i64p]
        c.arith_decode4.restype = ct.c_int64
        c.arith_decode4.argtypes = [_u8p, _i64p, _i64p, _u64p,
                                    ct.c_uint32, _u32p, ct.c_int64,
                                    _u32p]

    @classmethod
    def load(cls, path):
        return cls(ct.CDLL(str(path)))

    # ---- model math ------------------------------------------------------

    def entropy_ordered(self, freqs: np.ndarray, freq_sum: int) -> float:
        return self._c.ans_entropy_ordered(freqs, len(freqs), freq_sum)

    def cross_entropy_ordered(self, P: np.ndarray, Q: np.ndarray) -> float:
        return self._c.ans_cross_entropy_ordered(P, len(P), Q, len(Q))

    def scale_freqs(self, S, F, mapping, M, sigma, freq_sum) -> bool:
        # S is mutated IN PLACE: pass it through unconverted so a
        # wrong-dtype/non-contiguous array raises (a silent
        # ascontiguousarray copy would leave the caller's S untouched)
        return bool(self._c.ans_scale_freqs(S, F, mapping, M, sigma,
                                            freq_sum))

    # ---- compat streams --------------------------------------------------

    def compat_encode(self, mapped, exc_counts, exc_bytes, freq, base,
                      M: int) -> bytes:
        n = len(mapped)
        cap = 8 * n + 4096
        out = np.empty(cap, np.uint8)
        ec = (exc_counts.ctypes.data if exc_counts is not None else None)
        eb = (exc_bytes.ctypes.data if exc_bytes is not None else None)
        size = self._c.ans_compat_encode(
            np.ascontiguousarray(mapped, np.uint32), n, ec, eb,
            np.ascontiguousarray(freq, np.uint32),
            np.ascontiguousarray(base, np.uint32), M, out, cap)
        if size < 0:
            raise RuntimeError("native compat encode overflow")
        return out[:size].tobytes()

    def compat_decode(self, buf: bytes, n: int, freq_slot, offset_slot,
                      sym_slot, M: int, high=None, nb=None) -> np.ndarray:
        out = np.empty(n, np.uint32)
        arr = np.frombuffer(buf, np.uint8)
        hp = high.ctypes.data if high is not None else None
        np_ = nb.ctypes.data if nb is not None else None
        rc = self._c.ans_compat_decode(
            arr, len(arr), n,
            np.ascontiguousarray(freq_slot, np.uint32),
            np.ascontiguousarray(offset_slot, np.uint32),
            np.ascontiguousarray(sym_slot, np.uint32), M, hp, np_, out)
        if rc < 0:
            raise ValueError("corrupt compat stream (underrun)")
        return out

    # ---- interpolative coder --------------------------------------------

    def interp_encode(self, seq: np.ndarray, n: int, u: int) -> bytes:
        cap = 16 * max(1, n) + 64 + (u.bit_length() // 4)
        out = np.empty(cap, np.uint8)
        size = self._c.ans_interp_encode(
            np.ascontiguousarray(seq, np.uint64), n, u, out, cap)
        if size < 0:
            raise RuntimeError("native interp encode overflow")
        return out[:size].tobytes()

    def interp_decode(self, buf: bytes, n: int, u: int,
                      bit_offset: int = 0):
        out = np.empty(max(1, n), np.uint64)
        arr = np.frombuffer(buf, np.uint8)
        words = self._c.ans_interp_decode(arr, len(arr), n, u, bit_offset,
                                          out)
        return out[:n], int(words)

    # ---- shuff payload ----------------------------------------------------

    def shuff_pack(self, ids, codes, lens) -> bytes:
        """MSB-first bit-pack of canonical codewords (lens <= 32)."""
        n = len(ids)
        cap = 4 * n + int(lens.max()) * 8 + 64
        out = np.empty(cap, np.uint8)
        size = self._c.shuff_pack(
            np.ascontiguousarray(ids, np.uint32), n,
            np.ascontiguousarray(codes, np.uint32),
            np.ascontiguousarray(lens, np.uint8), out, cap)
        if size < 0:
            raise RuntimeError("native shuff pack overflow or len > 32")
        return out[:size].tobytes()

    def shuff_pack4(self, ids, codes, lens):
        """4-interleaved-substream MSB-first pack (lens <= 32): symbols
        i mod 4 == j form stream j.  Returns the four streams as
        bytes."""
        n = len(ids)
        # stream j holds <= ceil(n/4) codes of <= 32 bits = <= n + 4
        # bytes, plus the 8-byte branchless-store slack
        cap4 = n + 64
        out = np.empty(4 * cap4, np.uint8)
        len4 = np.zeros(4, np.int64)
        lens = np.ascontiguousarray(lens, np.uint8)
        rc = self._c.shuff_pack4(
            np.ascontiguousarray(ids, np.uint32), n,
            np.ascontiguousarray(codes, np.uint32), lens,
            int(lens.max()) if len(lens) else 0, out, cap4, len4)
        if rc < 0:
            raise RuntimeError("native shuff pack overflow or len > 32")
        # memoryviews, not .tobytes(): the caller b"".join()s the four
        # streams into the blob, so copying here would double the
        # payload traffic (a measured ~15% of encode at 16-bit codes)
        return [memoryview(out)[j * cap4:j * cap4 + int(len4[j])]
                for j in range(4)]

    def shuff_unpack4(self, payload, stream_lens, n, lut16, first_code,
                      first_idx, max_len, syms) -> np.ndarray:
        """Decode n symbols from 4 concatenated substreams (lengths
        stream_lens, summing to len(payload)); out[i] comes from
        stream i mod 4."""
        out = np.empty(n, np.uint32)
        raw = np.frombuffer(payload, np.uint8)
        arr = np.zeros(len(raw) + 8, np.uint8)
        arr[:len(raw)] = raw
        slen = np.asarray(stream_lens, np.int64)
        off = np.concatenate([[0], np.cumsum(slen)[:3]]).astype(np.int64)
        rc = self._c.shuff_unpack4(
            arr, np.ascontiguousarray(off), np.ascontiguousarray(slen),
            n, np.ascontiguousarray(lut16, np.uint8),
            np.ascontiguousarray(first_code, np.int64),
            np.ascontiguousarray(first_idx, np.int64), max_len,
            np.ascontiguousarray(syms, np.uint32), out)
        if rc < 0:
            raise ValueError("corrupt shuff stream")
        return out

    def shuff_unpack(self, payload, n, lut16, first_code, first_idx,
                     max_len, syms) -> np.ndarray:
        out = np.empty(n, np.uint32)
        raw = np.frombuffer(payload, np.uint8)
        # 8 zero bytes of tail slack: the branchless refill reads one
        # unaligned u64 at the cursor (truncation accounting still uses
        # the real length)
        arr = np.zeros(len(raw) + 8, np.uint8)
        arr[:len(raw)] = raw
        rc = self._c.shuff_unpack(
            arr, len(raw), n,
            np.ascontiguousarray(lut16, np.uint8),
            np.ascontiguousarray(first_code, np.int64),
            np.ascontiguousarray(first_idx, np.int64), max_len,
            np.ascontiguousarray(syms, np.uint32), out)
        if rc < 0:
            raise ValueError("corrupt shuff stream")
        return out

    # ---- arith range coder -------------------------------------------

    def arith_encode4(self, values, vcumfq, total_log2: int):
        """4-substream range-coder payload (models/arith.py wire):
        element i rides chain i mod 4.  vcumfq[x] = cum<<32|freq
        indexed directly by the coded value (total_log2 <= 31 keeps the
        32/32 packing exact).  Returns the four streams as bytes;
        retries with a larger buffer on overflow."""
        n = len(values)
        values = np.ascontiguousarray(values, np.uint32)
        vcumfq = np.ascontiguousarray(vcumfq, np.uint64)
        cap4 = n + 64
        while True:
            out = np.empty(4 * cap4, np.uint8)
            len4 = np.zeros(4, np.int64)
            rc = self._c.arith_encode4(vcumfq, values, n, total_log2,
                                       out, cap4, len4)
            if rc == 0:
                # views, not copies — see shuff_pack4
                return [memoryview(out)[j * cap4:j * cap4 + int(len4[j])]
                        for j in range(4)]
            if cap4 > 3 * n + 64:
                raise RuntimeError("arith encoder overflow")  # unreachable
            cap4 = cap4 * 2 + 64

    def arith_decode4(self, payload, stream_lens, cum, total_log2: int,
                      n: int) -> np.ndarray:
        """Symbol ids from 4 concatenated substreams (lengths
        stream_lens); out[i] comes from stream i mod 4."""
        out = np.empty(n, np.uint32)
        arr = np.frombuffer(payload, np.uint8)
        cum = np.ascontiguousarray(cum, np.uint64)
        slen = np.asarray(stream_lens, np.int64)
        off = np.concatenate([[0], np.cumsum(slen)[:3]]).astype(np.int64)
        # 16-bit jump table: last k with cum[k] <= b << (tl2-16)
        bvals = (np.arange((1 << 16) + 1, dtype=np.uint64)
                 << np.uint64(total_log2 - 16))
        jump = (np.searchsorted(cum, bvals, side="right") - 1).clip(
            0, len(cum) - 2).astype(np.uint32)
        rc = self._c.arith_decode4(arr, np.ascontiguousarray(off),
                                   np.ascontiguousarray(slen), cum,
                                   total_log2, jump, n, out)
        if rc < 0:
            raise ValueError("corrupt arith stream (range collapsed)")
        return out

    # ---- tANS ------------------------------------------------------------

    def tans_encode(self, ids: np.ndarray, t: dict):
        """4-state tANS encode (tables from models.tans.build_tables;
        ids are byte-alphabet, sigma <= 256).
        Returns (final_states list[4], total_bits, payload bytes)."""
        n = len(ids)
        cap = 2 * n + 64
        out = np.empty(cap, np.uint8)
        states = np.empty(4, np.uint32)
        bits = self._c.tans_encode(
            np.ascontiguousarray(ids, np.uint8), n, t["k0"],
            t["cutoff"], t["cumbase"], t["q"], t["enc_next"],
            int(t["L"]), len(t["q"]), states, out, cap)
        if bits < 0:
            raise RuntimeError("native tans encode overflow")
        nbytes = (int(bits) + 7) // 8
        return ([int(s) for s in states], int(bits),
                out[:nbytes].tobytes() if nbytes else b"\x00")

    def tans_decode(self, payload: bytes, total_bits: int, states,
                    n: int, t: dict) -> np.ndarray:
        out = np.empty(n, np.uint8)
        # 8-byte read slack past any bit position
        arr = np.zeros(len(payload) + 8, np.uint8)
        arr[: len(payload)] = np.frombuffer(payload, np.uint8)
        rc = self._c.tans_decode(arr, total_bits, n, t["sym"], t["nbt"],
                                 t["base"], int(t["L"]),
                                 np.asarray(states, np.uint32), out)
        if rc < 0:
            raise ValueError("corrupt tans stream (state or bit "
                             "underrun)")
        return out

    def hist_u8(self, data: np.ndarray) -> np.ndarray:
        out = np.empty(256, np.uint64)
        self._c.hist_u8(np.ascontiguousarray(data, np.uint8), len(data),
                        out)
        return out

    def hist_u32(self, data: np.ndarray, nbins: int) -> np.ndarray:
        """u32 histogram (caller guarantees data < nbins)."""
        out = np.zeros(nbins, np.uint64)
        self._c.hist_u32(np.ascontiguousarray(data, np.uint32),
                         len(data), out)
        return out

    def remap_u32(self, table: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """out[i] = table[idx[i]] (caller guarantees idx < len(table))."""
        out = np.empty(len(idx), np.uint32)
        self._c.remap_u32(np.ascontiguousarray(table, np.uint32),
                          np.ascontiguousarray(idx, np.uint32),
                          len(idx), out)
        return out

    def huff_code_lengths(self, sorted_freqs: np.ndarray) -> np.ndarray:
        """Huffman code lengths for an ASCENDING-sorted positive
        frequency array (two-queue merge)."""
        out = np.empty(len(sorted_freqs), np.int64)
        self._c.huff_code_lengths(
            np.ascontiguousarray(sorted_freqs, np.uint64),
            len(sorted_freqs), out)
        return out

    # ---- transforms ------------------------------------------------------

    def mtf(self, seq: np.ndarray, sigma: int) -> np.ndarray:
        out = np.empty(len(seq), np.uint32)
        self._c.ans_mtf(np.ascontiguousarray(seq, np.uint32), len(seq),
                        sigma, out)
        return out
