"""Wire-compatible shuff (canonical Huffman) codec: a copy of
ans_tpu/reference_model/shuff_compat.py (NumPy only), held equal to it by
tests/test_torch_host.py.  `_indirect_sort` reproduces the reference's
qsort order operation for operation and stays exactly as written.

Re-expresses the reference's in-repo shuff coder
(include/shuff.hpp:734-897 and helpers) so users can
decode existing shuff archives and produce blobs the reference
decodes.  The wire is bit-level:

  u64-word bitstream, MSB-first within each little-endian u64
  (shuff.hpp SHUFF_OUTPUT_ULONG:112-125)
  n (27 bits) | max_cw_len (6 bits)
  per distinct symbol, ascending: unary(max_cw_len - len)  [0^k 1]
  interpolative code of the sorted distinct symbols (+1-biased; symbol
  0 is always present with freq 1, shuff.hpp:415-417)
  canonical codewords, one per input element

Determinism notes (why byte parity is achievable): codeword lengths
come from the Moffat-Katajainen in-place algorithm over symbols sorted
by the reference's own Bentley-McIlroy quicksort — equal-frequency
ORDER changes individual lengths, so both are reproduced operation-
for-operation below (shuff_indirect_sort:549-609,
shuff_calculate_minimum_redundancy:455-512).  The math IS the wire.

Known reference defect reproduced-around: shuff_compress RETURNS only
the complete-u64 byte count, losing up to 63 tail bits
(SHUFF_FINISH_OUTPUT:139-146 never advances past the partial word) —
the reference's own encode->file->decode round-trip fails.  encode()
here returns the FULL wire (ceil(bits/64) words); the reference
decodes it unchanged, and decode() accepts either form.
"""

from __future__ import annotations

import numpy as np

LOG2_L = 6
L = 63
LOG2_MAX_SYMBOL = 27
MAX_SYMBOL = 1 << LOG2_MAX_SYMBOL
MASK64 = (1 << 64) - 1


# --------------------------------------------------------------------------
# u64 MSB-first bit I/O (shuff.hpp:60-225)
# --------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.words: list[int] = []
        self.cur = 0
        self.btg = 64

    def ulong(self, n: int, length: int) -> None:
        if length <= 0:
            return
        if length < self.btg:
            self.cur = ((self.cur << length) | n) & MASK64
            self.btg -= length
        else:
            self.words.append(
                ((self.cur << self.btg) | (n >> (length - self.btg)))
                & MASK64)
            self.cur = n & MASK64
            self.btg = 64 - (length - self.btg)

    def bit(self, b: int) -> None:
        self.cur = ((self.cur << 1) | (1 if b else 0)) & MASK64
        self.btg -= 1
        if self.btg == 0:
            self.words.append(self.cur)
            self.cur = 0
            self.btg = 64

    def unary(self, n: int) -> None:
        for _ in range(n):
            self.bit(0)
        self.bit(1)

    def finish(self) -> bytes:
        words = list(self.words)
        if self.btg != 64:
            words.append((self.cur << self.btg) & MASK64)
        return np.asarray(words, dtype="<u8").tobytes()


class _Reader:
    def __init__(self, buf):
        raw = bytes(buf)
        pad = (-len(raw)) % 8
        # the reference decoder prefetches up to two words past the
        # last consumed bit; anything beyond that is corruption
        self.words = np.frombuffer(raw + b"\0" * (pad + 16),
                                   dtype="<u8")
        self.limit = len(self.words)
        self.widx = 0
        self.btg = 64

    def _word(self) -> int:
        if self.widx >= self.limit:
            raise ValueError("corrupt shuff stream (truncated)")
        return int(self.words[self.widx])

    def ulong(self, length: int) -> int:
        if length <= 0:
            return 0
        w = self._word()
        if self.btg == 64:
            n = w >> (64 - length)
        else:
            n = ((w << (64 - self.btg)) & MASK64) >> (64 - length)
        if length < self.btg:
            self.btg -= length
        else:
            length -= self.btg
            self.widx += 1
            self.btg = 64
            if length > 0:
                n |= self._word() >> (64 - length)
                self.btg -= length
        if self.btg == 0:
            self.widx += 1
            self.btg = 64
        return n

    def bit(self) -> int:
        w = self._word()
        self.btg -= 1
        b = (w >> self.btg) & 1
        if self.btg == 0:
            self.widx += 1
            self.btg = 64
        return int(b)

    def unary(self) -> int:
        n = 0
        while not self.bit():
            n += 1
            if n > 64:
                raise ValueError("corrupt shuff stream (unary runaway)")
        return n


# --------------------------------------------------------------------------
# centered minimal binary + interpolative code (shuff.hpp:277-390)
# --------------------------------------------------------------------------

def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _binary_encode(w: _Writer, x: int, b: int) -> None:
    logofb = _ceil_log2(b)
    thresh = (1 << logofb) - b
    x -= 1
    if x < thresh:
        w.ulong(x, logofb - 1)
    else:
        w.ulong(x + thresh, logofb)


def _binary_decode(r: _Reader, b: int) -> int:
    if b == 1:
        return 1
    logofb = _ceil_log2(b)
    thresh = (1 << logofb) - b
    x = r.ulong(logofb - 1)
    if x >= thresh:
        x = x * 2 + r.bit()
        x -= thresh
    return x + 1


def _interp_encode(w: _Writer, A: list[int], n: int) -> None:
    A = list(A[:n]) + [0]
    A[0] = 0
    A[n] = MAX_SYMBOL
    st = [(0, n)]
    while st:
        lo, hi = st.pop()
        rng = A[hi] - A[lo] - (hi - lo - 1)
        mid = lo + ((hi - lo) >> 1)
        _binary_encode(w, A[mid] - (A[lo] + (mid - lo - 1)), rng)
        if hi - mid > 1 and A[hi] - A[mid] > hi - mid:
            st.append((mid, hi))
        if mid - lo > 1 and A[mid] - A[lo] > mid - lo:
            st.append((lo, mid))


def _interp_decode(r: _Reader, n: int) -> list[int]:
    A = [0] * (n + 1)
    A[n] = MAX_SYMBOL
    st = [(0, n)]
    while st:
        lo, hi = st.pop()
        rng = A[hi] - A[lo] - (hi - lo - 1)
        if rng < 1:
            raise ValueError("corrupt shuff prelude (interp range)")
        mid = lo + ((hi - lo) >> 1)
        A[mid] = _binary_decode(r, rng) + A[lo] + (mid - lo - 1)
        if A[hi] - A[mid] == hi - mid:
            for j in range(mid + 1, hi):
                A[j] = A[j - 1] + 1
        elif hi - mid > 1:
            st.append((mid, hi))
        if A[mid] - A[lo] == mid - lo:
            for j in range(lo + 1, mid):
                A[j] = A[j - 1] + 1
        elif mid - lo > 1:
            st.append((lo, mid))
    return A[:n]


# --------------------------------------------------------------------------
# the reference's exact quicksort + in-place code-length algorithm
# --------------------------------------------------------------------------

def _indirect_sort(freq: dict, syms: list[int], a0: int, n: int) -> None:
    """Bentley-McIlroy 3-way quicksort over syms[a0:a0+n] keyed by
    freq[sym], operation-for-operation (shuff_indirect_sort:549-609):
    equal-key ORDER feeds the length algorithm, so the exact pivot and
    swap sequence is wire format."""
    a = syms  # flat list; indices are element offsets from a0

    def cmp(i, j):
        return freq[a[i]] - freq[a[j]]

    def med3(i, j, k):
        if cmp(i, j) < 0:
            return j if cmp(j, k) < 0 else (k if cmp(i, k) < 0 else i)
        return j if cmp(j, k) > 0 else (i if cmp(i, k) < 0 else k)

    if n < 7:
        for pm in range(a0 + 1, a0 + n):
            pl = pm
            while pl > a0 and cmp(pl - 1, pl) > 0:
                a[pl - 1], a[pl] = a[pl], a[pl - 1]
                pl -= 1
        return
    pm = a0 + n // 2
    pl = a0
    pn = a0 + n - 1
    if n > 40:
        d = n // 8
        pl = med3(pl, pl + d, pl + 2 * d)
        pm = med3(pm - d, pm, pm + d)
        pn = med3(pn - 2 * d, pn - d, pn)
    pm = med3(pl, pm, pn)
    a[a0], a[pm] = a[pm], a[a0]
    pa = pb = a0 + 1
    pc = pd = a0 + n - 1
    while True:
        while pb <= pc and (r := cmp(pb, a0)) <= 0:
            if r == 0:
                a[pa], a[pb] = a[pb], a[pa]
                pa += 1
            pb += 1
        while pb <= pc and (r := cmp(pc, a0)) >= 0:
            if r == 0:
                a[pc], a[pd] = a[pd], a[pc]
                pd -= 1
            pc -= 1
        if pb > pc:
            break
        a[pb], a[pc] = a[pc], a[pb]
        pb += 1
        pc -= 1
    pn_end = a0 + n
    r = min(pa - a0, pb - pa)
    for i in range(r):
        a[a0 + i], a[pb - r + i] = a[pb - r + i], a[a0 + i]
    r = min(pd - pc, pn_end - pd - 1)
    for i in range(r):
        a[pb + i], a[pn_end - r + i] = a[pn_end - r + i], a[pb + i]
    r = pb - pa
    if r > 1:
        _indirect_sort(freq, syms, a0, r)
    r = pd - pc
    if r > 1:
        _indirect_sort(freq, syms, pn_end - r, r)


def _min_redundancy(freq: dict, syms: list[int], n: int) -> None:
    """Moffat-Katajainen in-place minimum-redundancy code lengths
    (shuff_calculate_minimum_redundancy:455-512); freq[sym] becomes the
    codeword length."""
    if n == 0:
        return
    if n == 1:
        freq[syms[0]] = 0
        return
    freq[syms[0]] += freq[syms[1]]
    root, leaf = 0, 2
    for nxt in range(1, n - 1):
        if leaf >= n or freq[syms[root]] < freq[syms[leaf]]:
            freq[syms[nxt]] = freq[syms[root]]
            freq[syms[root]] = nxt
            root += 1
        else:
            freq[syms[nxt]] = freq[syms[leaf]]
            leaf += 1
        if leaf >= n or (root < nxt
                         and freq[syms[root]] < freq[syms[leaf]]):
            freq[syms[nxt]] += freq[syms[root]]
            freq[syms[root]] = nxt
            root += 1
        else:
            freq[syms[nxt]] += freq[syms[leaf]]
            leaf += 1
    freq[syms[n - 2]] = 0
    for nxt in range(n - 3, -1, -1):
        freq[syms[nxt]] = freq[syms[freq[syms[nxt]]]] + 1
    avbl, used, dpth = 1, 0, 0
    root, nxt = n - 2, n - 1
    while avbl > 0:
        while root >= 0 and freq[syms[root]] == dpth:
            used += 1
            root -= 1
        while avbl > used:
            freq[syms[nxt]] = dpth
            nxt -= 1
            avbl -= 1
        avbl = 2 * used
        dpth += 1
        used = 0


def _canonical_arrays(cw_lens: list[int], max_len: int):
    """offset / min_code / lj_base (shuff_build_canonical_arrays)."""
    offset = [0] * max_len
    for i in range(1, max_len):
        offset[i] = offset[i - 1] + cw_lens[i]
    min_code = [0] * max_len
    for i in range(max_len - 2, -1, -1):
        min_code[i] = (min_code[i + 1] + cw_lens[i + 2]) >> 1
    lj_base = [0] * max_len
    left_shift = 63
    for i in range(max_len):
        if cw_lens[i + 1] == 0:
            lj_base[i] = lj_base[i - 1] if i else 0
        else:
            lj_base[i] = (min_code[i] << left_shift) & MASK64
        left_shift -= 1
    for i in range(max_len):
        if cw_lens[i + 1]:
            break
        lj_base[i] = MASK64
    return offset, min_code, lj_base


# --------------------------------------------------------------------------
# public codec
# --------------------------------------------------------------------------

class ShuffCompat:
    """Reference-wire shuff.  encode returns the complete bitstream
    (see module docstring on the reference's truncated size)."""

    name = "shuff"

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        if int(values.max()) + 1 > MAX_SYMBOL:
            raise ValueError(f"shuff symbols must be < {MAX_SYMBOL - 1}")
        biased = values.astype(np.int64) + 1
        # distinct symbols in FIRST-OCCURRENCE order, then symbol 0
        # (shuff_one_pass_freq_count:393-417)
        counts = np.bincount(biased)
        uniq, first_idx = np.unique(biased, return_index=True)
        syms = uniq[np.argsort(first_idx)].tolist()
        freq = {int(s): int(counts[s]) for s in syms}
        freq[0] = 1
        syms = [int(s) for s in syms] + [0]
        n = len(syms)

        _indirect_sort(freq, syms, 0, n)
        _min_redundancy(freq, syms, n)
        cw_lens = [0] * (L + 1)
        max_len = 0
        for s in syms:
            ln = freq[s]
            if ln > max_len:
                max_len = ln
            cw_lens[ln] += 1
        offset, min_code, _lj = _canonical_arrays(cw_lens, max_len)

        w = _Writer()
        w.ulong(n, LOG2_MAX_SYMBOL)
        w.ulong(max_len, LOG2_L)
        syms.sort()
        for s in syms:
            w.unary(max_len - freq[s])
        _interp_encode(w, syms, n)
        # canonical ordinals (shuff_generate_mapping:663-674)
        cum = [0] * (max_len + 1)
        for i in range(1, max_len + 1):
            cum[i] = cum[i - 1] + cw_lens[i]
        mapping = {}
        for i in range(n - 1, -1, -1):
            s = syms[i]
            mapping[s] = cum[freq[s] - 1]
            cum[freq[s] - 1] += 1
        for v in biased.tolist():
            ln = freq[v]
            cw = min_code[ln - 1] + (mapping[v] - offset[ln - 1])
            w.ulong(cw, ln)
        return w.finish()

    def decode(self, buf, n: int) -> np.ndarray:
        r = _Reader(buf)
        nsym = r.ulong(LOG2_MAX_SYMBOL)
        max_len = r.ulong(LOG2_L)
        if not 1 <= nsym <= MAX_SYMBOL or not 1 <= max_len <= L:
            raise ValueError("corrupt shuff prelude (header)")
        cw_lens = [0] * (max_len + 2)
        lens = []
        for _ in range(nsym):
            u = r.unary()
            if u >= max_len:
                raise ValueError("corrupt shuff prelude (length)")
            lens.append(max_len - u)
            cw_lens[max_len - u] += 1
        offset, min_code, lj_base = _canonical_arrays(cw_lens, max_len)
        mapping = _interp_decode(r, nsym)
        # code-index order (shuff_decompress:839-862 permutation)
        cum = [0] * (max_len + 1)
        for i in range(1, max_len + 1):
            cum[i] = cum[i - 1] + cw_lens[i]
        by_code = [0] * nsym
        for i in range(nsym - 1, -1, -1):
            by_code[cum[lens[i] - 1]] = mapping[i]
            cum[lens[i] - 1] += 1
        min_len = 1
        while cw_lens[min_len] == 0:
            min_len += 1

        out = np.empty(n, dtype=np.uint32)
        code = 0
        bits_needed = 64
        for k in range(n):
            code |= r.ulong(bits_needed)
            # canonical length: first lj_base[len-1] <= code
            ln = min_len
            while ln <= max_len and code < lj_base[ln - 1]:
                ln += 1
            if ln > max_len:
                raise ValueError("corrupt shuff stream (code)")
            cidx = (code >> (64 - ln)) - min_code[ln - 1] + offset[ln - 1]
            if not 0 <= cidx < nsym:
                raise ValueError("corrupt shuff stream (symbol index)")
            s = by_code[cidx]
            if s == 0:
                raise ValueError("corrupt shuff stream (EOF symbol)")
            out[k] = s - 1
            code = (code << ln) & MASK64
            bits_needed = ln
        return out
