"""Tabled ANS (tANS / FSE-equivalent) over the byte alphabet.

The reference's `fse` method (methods.hpp:159-176) wraps the external
FSE library (fse.h is not vendored in the reference tree).  There is
therefore no wire format to match; this is an original tANS with the
framework's own model pipeline:

  * normalization: the same `byte_adjust_freqs` the byte-rANS uses
    (reference semantics, power-of-two frame L <= 4096);
  * prelude: the same interp code of cumulative freqs as `ansbyte`, so
    the two byte-entropy stages differ ONLY in the stream encoding;
  * spread: the standard stride spread (step = (L>>1)+(L>>3)+3, RFC
    8878 section 4.1.1's public FSE_TABLESTEP construction) — step is
    odd, hence coprime with the power-of-two L and a full cycle;
  * stream: 4 interleaved states sharing one LSB-first bitstream,
    encoded in reverse (state p & 3 owns position p), decoded forward
    reading bits from the tail — the same LIFO discipline as the
    compat rANS byte stream, at bit granularity.

State machine (L = 2^R, q = normalized freq of s):
  encode   nb = k0(s) - (x < cutoff(s)),  k0 = R - floor(log2 q),
           cutoff = q << k0; emit nb low bits of x;
           x' = enc_next[cumbase(s) + (x >> nb) - q]   in [L, 2L)
  decode   p = x - L; s = sym[p]; x' = base[p] + read(nbt[p])
  where enc_next/base are the increasing enumeration of each symbol's
  spread slots (rank t of s at slot p <-> xsmall = q + t), which makes
  the two directions exact inverses.

Hot loops run in the native backend (ans_native.cpp tans_encode /
tans_decode); a pure-Python fallback keeps the path correct without
the shared library.  The TPU byte-entropy composites (`vbyteANS`) run
the Pallas rANS kernels; tANS is the host-library-shaped baseline,
exactly as FSE is for the reference.

A copy of ans_tpu/models/tans.py: its hot loops run in the port's host
library (ans_tpu_torch/native) through the module global `_native`
(native.deferred); each pure-Python body is the plain version, run
when `_native` is None.
"""

from __future__ import annotations

import numpy as np

import time

from .. import native
from ..native import deferred as _native
from ..reference_model.byte_model import (byte_prelude_decode,
                                          byte_prelude_encode)
from ..utils.stats import record_stats

_NSTATES = 4



def build_tables(nfreqs: np.ndarray):
    """All static tables from normalized freqs (sum = L, power of 2).

    Returns dict with R, L, per-symbol k0/cutoff/cumbase/q, the encode
    transition table enc_next (flat, cumbase[s] + (xsmall - q_s)), and
    the decode slot tables sym/nbt/base.
    """
    q = np.asarray(nfreqs, dtype=np.int64)
    L = int(q.sum())
    R = L.bit_length() - 1
    assert 1 << R == L, "normalized freqs must sum to a power of two"
    step = (L >> 1) + (L >> 3) + 3
    slots = (step * np.arange(L, dtype=np.int64)) & (L - 1)
    spread = np.zeros(L, dtype=np.int64)
    spread[slots] = np.repeat(np.arange(len(q)), q)
    # rank of each slot among its symbol's slots, in slot order
    order = np.argsort(spread, kind="stable")
    rank = np.zeros(L, dtype=np.int64)
    rank[order] = np.arange(L) - np.repeat(
        np.concatenate(([0], np.cumsum(q)[:-1])), q)
    cumbase = np.concatenate(([0], np.cumsum(q)[:-1]))
    # encode: t-th slot of s (increasing) <- xsmall = q_s + t
    enc_next = np.zeros(L, dtype=np.uint32)
    enc_next[cumbase[spread] + rank] = L + np.arange(L)
    # decode: slot p hands out xsmall = q_s + rank, renormed to [L, 2L)
    xsmall = q[spread] + rank
    # frexp's exponent-1 is an exact floor(log2) for these magnitudes
    nbt = R - (np.frexp(xsmall.astype(np.float64))[1] - 1)
    base = (xsmall << nbt).astype(np.uint32)
    k0 = np.where(q > 0,
                  R - (np.frexp(np.maximum(q, 1).astype(
                      np.float64))[1] - 1), 0).astype(np.int64)
    cutoff = (q << k0).astype(np.uint32)
    return dict(R=R, L=L, q=q.astype(np.uint32),
                k0=k0.astype(np.uint8), cutoff=cutoff,
                cumbase=cumbase.astype(np.uint32), enc_next=enc_next,
                sym=spread.astype(np.uint32), nbt=nbt.astype(np.uint8),
                base=base)


# ---------------------------------------------------------- pure python ---

def _encode_py(ids: np.ndarray, t: dict):
    L, R = t["L"], t["R"]
    k0, cutoff, cumbase, q = t["k0"], t["cutoff"], t["cumbase"], t["q"]
    enc_next = t["enc_next"]
    states = [L] * _NSTATES
    # LSB-first bitstream flushed byte-by-byte as it fills (a single
    # growing bigint accumulator made this fallback O(n^2))
    out = bytearray()
    acc = 0
    fill = 0
    for p in range(len(ids) - 1, -1, -1):
        s = ids[p]
        x = states[p & 3]
        nb = int(k0[s]) - (x < int(cutoff[s]))
        acc |= (x & ((1 << nb) - 1)) << fill
        fill += nb
        while fill >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            fill -= 8
        states[p & 3] = int(enc_next[int(cumbase[s]) + (x >> nb)
                                     - int(q[s])])
    total_bits = 8 * len(out) + fill
    if fill:
        out.append(acc & 0xFF)
    payload = bytes(out) if out else b"\x00"
    return states, total_bits, payload


def _decode_py(payload: bytes, total_bits: int, states, n: int, t: dict):
    L = t["L"]
    sym, nbt, base = t["sym"], t["nbt"], t["base"]
    acc = int.from_bytes(payload, "little")
    cur = total_bits
    st = list(states)
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        x = st[i & 3]
        p = x - L
        out[i] = sym[p]
        nb = int(nbt[p])
        cur -= nb
        st[i & 3] = int(base[p]) + ((acc >> cur) & ((1 << nb) - 1))
    return out


# ------------------------------------------------------------- the codec ---

class ByteTans:
    """tANS byte-entropy stage: encode(bytes) -> bytes,
    decode(buf, n) -> bytes (the _SplitPlusByteEntropy contract).

    Wire: interp prelude of cumulative freqs (identical layout to
    ansbyte's) | 4 x u16 final encoder states (x - L) | u64 bit count |
    bitstream (LSB-first, decoder reads from the tail).
    """

    name = "tansbyte"

    def encode(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, dtype=np.uint8)
        if len(arr) == 0:
            raise ValueError("cannot encode an empty sequence")
        t0 = time.perf_counter_ns()
        freqs = native.byte_histogram(arr, _native)
        lib = _native
        prelude, nfreqs = byte_prelude_encode(freqs)
        t = build_tables(nfreqs)
        # the wire header stores final states as u16 (x - L)
        assert t["L"] <= (1 << 16), "byte frame exceeds the u16 header"
        t1 = time.perf_counter_ns()
        if lib is not None:
            states, total_bits, payload = lib.tans_encode(arr, t)
        else:
            states, total_bits, payload = _encode_py(arr, t)
        head = b"".join(int(s - t["L"]).to_bytes(2, "little")
                        for s in states)
        head += int(total_bits).to_bytes(8, "little")
        record_stats(prelude_bytes=len(prelude),
                     encode_bytes=len(head) + len(payload),
                     prelude_time_ns=t1 - t0,
                     encode_time_ns=time.perf_counter_ns() - t1)
        return prelude + head + payload

    def decode(self, buf: bytes, n: int) -> bytes:
        nfreqs, off = byte_prelude_decode(buf)
        t = build_tables(nfreqs.astype(np.uint32))
        states = [t["L"] + int.from_bytes(buf[off + 2 * i: off + 2 * i
                                              + 2], "little")
                  for i in range(_NSTATES)]
        total_bits = int.from_bytes(buf[off + 8: off + 16], "little")
        # a forged/truncated wire u64 must fail here, not in the native
        # decoder (which trusts that the payload really holds total_bits
        # bits and reads at payload + (cur >> 3))
        need = (total_bits + 7) // 8 or 1
        if len(buf) < off + 16 + need:
            raise ValueError(
                f"corrupt tans stream: header claims {total_bits} payload"
                f" bits but only {len(buf) - off - 16} bytes follow")
        payload = buf[off + 16: off + 16 + need]
        lib = _native
        if lib is not None:
            return lib.tans_decode(payload, total_bits, states, n,
                                   t).tobytes()
        out = _decode_py(payload, total_bits, states, n, t)
        return out.astype(np.uint8).tobytes()


class Fse:
    """The reference's `fse` method over the framework's tANS: entropy-
    code the raw little-endian bytes of the u32 input
    (methods.hpp:159-176)."""

    name = "fse"

    def __init__(self):
        self.entropy = ByteTans()

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype="<u4")
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        return self.entropy.encode(values.tobytes())

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        raw = self.entropy.decode(buf, n * 4)
        return np.frombuffer(raw, dtype="<u4").copy()
