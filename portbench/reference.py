"""The plain reference of the benchmark: the lane-format blob (fmt 2) and the
blocked container (ATFB v2) of an input, written again in NumPy and plain
Python from docs/FORMAT.md sections 2-3 and the reference coder's model
(include/ans_util.hpp, ans_fold.hpp, ans_int.hpp).  `encode` and
`lossy_values` are the reference side of the codec `lane`
(portbench/manifest.py); another codec's reference side,
references/<codec>.py, may build on this module's pieces (the model, the
lanes, the interpolative code, the blobs).

It imports nothing of the program under test and takes nothing it made:
the benchmark hands it the same input values it hands the program, and it
derives the model, the frame, the tail-escape plan, the lane states, the
byte stream and the section cut itself.  Its blob is held byte for byte
against the program's.  A lossless decode must return the input itself,
so the input is the reference of every decoded value.

Floating-point steps (the frame search and its entropies, the escape plan)
follow the reference coder's evaluation order, left to right in IEEE
double, so that frame sizes, and hence bytes, agree.

`lossy_values` is the benchmark's control: each value less the low bytes
that a byte fold strips (of fidelity 2: below 2^9 a value is whole), as a
codec that keeps only each value's high part returns it.  Encoded by
this reference, its blob, streams and values break the lossless
guarantee, and the checks must refuse them.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

A_L = 1 << 23                 # lane state lower bound: states in [L, 2^31)
LANE_FRAME_LIMIT = 1 << 22    # the lane format's largest frame
GROUPED_MIN_SIGMA = (1 << 13) + 1
SECTION_CAP = 3 << 20         # a section of a lane stream holds <= 3 MiB
SECTION_QUANTUM = 32          # t_sec is a multiple of 32 steps
FMT_LOCKSTEP = 2
ATFB_MAGIC = 0x41544642
ATFB_VERSION = 2
ATFB_HEADER = struct.Struct("<IBBBBII")
ATFB_KINDS = {"int": 0, "fold": 2}

# tail escape of the identity coder (docs/FORMAT.md "Tail-escape
# recoding"): format constants
ESCAPE_MIN_SIGMA = (1 << 13) + 1
ESCAPE_K_GRID = (1 << 10, 1 << 11, 1 << 12, (1 << 13) - (1 << 12) // 4,
                 1 << 14, 1 << 15, 1 << 16)
ESCAPE_MAX_VARIANTS = 1 << 12
ESCAPE_LOSS_BUDGET = 1.5e-3


def parse_method(method: str):
    """(kind, fidelity) of the methods this reference codes: ANS (the
    identity coder, h_approx 1) and ANSfold-f."""
    if method == "ANS":
        return "int", 0
    if method.startswith("ANSfold-"):
        f = int(method[len("ANSfold-"):])
        if 1 <= f <= 8:
            return "fold", f
    raise ValueError(f"the reference codes ANS and ANSfold-1..8, not "
                     f"{method!r}")


# --------------------------------------------------------------------------
# the byte fold (ans_fold.hpp:38-50)
# --------------------------------------------------------------------------

def fold_threshold(f: int) -> int:
    return 1 << (f + 7)


def fold_map(x: np.ndarray, f: int):
    """(symbol, stripped byte count) of each u32 value: strip low bytes
    while the value is at least 2^(f+7), then add 255 * 2^(f-1) a byte."""
    x = np.asarray(x, dtype=np.uint32)
    thres = np.uint32(fold_threshold(f))
    k = np.zeros(x.shape, dtype=np.uint32)
    for i in range(3):
        k += (x >> np.uint32(8 * i)) >= thres
    step = np.uint32((1 << (f - 1)) * 255)
    return ((x >> (np.uint32(8) * k)) + step * k).astype(np.uint32), k


# --------------------------------------------------------------------------
# the model: frame search (ans_util.hpp:77-157) and prelude (:46-63)
# --------------------------------------------------------------------------

def _next_pow2(x: int) -> int:
    return 1 if x == 0 else 1 << x.bit_length()


def _scale(fs: list, M: int, freq_sum: int):
    """One rescale pass of the frequencies `fs` (increasing (freq, symbol)
    order) onto a frame of M: the scaled list, or None to retry with a
    larger frame."""
    out = []
    for f in fs:
        s = int(0.5 + (M / freq_sum) * f)
        if s == 0:
            s = 1
        out.append(s)
        M -= s
        freq_sum -= f
        if M < 0:
            return None
    return out if M == 0 else None


def adjust_freqs(freqs: np.ndarray, require_u16: bool,
                 max_frame: int = LANE_FRAME_LIMIT) -> np.ndarray:
    """The scaled frequencies (u32, one per symbol up to the largest
    present one) on the smallest power-of-two frame whose cross entropy
    is within 1/1000 of H0, doubling from next_pow2(sigma) and stopping
    at max_frame.  require_u16: a frame whose largest frequency reaches
    2^16 - 1 falls back to the previous frame."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    nz = np.flatnonzero(freqs)
    if nz.size == 0:
        raise ValueError("no symbol to model")
    largest = int(nz[-1])
    sigma = int(nz.size)
    live = freqs[nz].tolist()                  # index order
    freq_sum = sum(live)
    order = nz[np.lexsort((nz, freqs[nz]))]    # (freq, symbol) increasing
    fs = freqs[order].tolist()
    n = float(freq_sum)
    h = 0.0
    for f in live:
        p = f / n
        h += p * math.log2(p)
    threshold = -h * (1.0 + 1 / 1000.0)
    target = sigma if sigma & (sigma - 1) == 0 else _next_pow2(sigma)
    prev = None
    while True:
        s = _scale(fs, target, freq_sum)
        if s is None:
            target *= 2
            continue
        scaled = np.zeros(largest + 1, dtype=np.uint32)
        scaled[order] = s
        if require_u16 and max(s) >= 0xFFFF:
            return (prev if prev is not None
                    else np.zeros(largest + 1, dtype=np.uint32))
        m = float(target)
        xh = 0.0
        for p_, q_ in zip(live, scaled[nz].tolist()):
            xh += (p_ / n) * math.log2(q_ / m)
        xh = -xh
        if xh < threshold or xh == 0.0:
            return scaled
        if target >= max_frame:
            return scaled
        target *= 2
        prev = scaled


def _vbyte(x: int) -> bytes:
    out = bytearray()
    while True:
        b, x = x & 0x7F, x >> 7
        if not x:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _interp(seq: list, u: int) -> bytes:
    """Binary interpolative code of the strictly increasing `seq` over
    [0, u) (interp.hpp:25-119): values shifted by one, each middle
    element a centred minimal binary code, left half first; bits fill
    little-endian u32 words from the least significant bit."""
    words, cur, off = [], 0, 0
    stack = [(0, len(seq), 1, u + 1)]
    while stack:
        start, cnt, low, high = stack.pop()
        if cnt == 0:
            continue
        h = (cnt + 1) >> 1
        n1, n2 = h - 1, cnt - h
        v = seq[start + h - 1] + 1
        val = v - low - n1 + 1
        uu = high - n2 - low - n1 + 1
        stack.append((start + h, n2, v + 1, high))
        stack.append((start, n1, low, v - 1))
        if uu == 1:
            continue
        b = (uu - 1).bit_length()
        d = 2 * uu - (1 << b)
        val += uu - (d >> 1)
        if val > uu:
            val -= uu
        m = (1 << b) - uu
        if val <= m:
            code, nbits = (val - 1) & ((1 << (b - 1)) - 1), b - 1
        else:
            val += m
            code = ((((val - 1) >> 1) & ((1 << (b - 1)) - 1))
                    | (((val - 1) & 1) << (b - 1)))
            nbits = b
        cur |= code << off
        off += nbits
        while off >= 32:
            words.append(cur & 0xFFFFFFFF)
            cur >>= 32
            off -= 32
    if off:
        words.append(cur & 0xFFFFFFFF)
    return np.asarray(words, dtype="<u4").tobytes()


def prelude(nfreqs: np.ndarray) -> bytes:
    """vbyte(largest symbol) | u8 log2(M) | interp of the cumulative
    (freq + 1) sums less one, over M + sigma + 1."""
    nfreqs = np.asarray(nfreqs, dtype=np.uint64)
    M = int(nfreqs.sum())
    k = len(nfreqs)
    inc = (np.cumsum(nfreqs + np.uint64(1)) - np.uint64(1)).tolist()
    return (_vbyte(k - 1) + bytes((M.bit_length() - 1,))
            + _interp(inc, M + k + 1))


# --------------------------------------------------------------------------
# the identity coder's tail escape (docs/FORMAT.md)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Escape:
    K: int
    nb: int
    var_highs: np.ndarray   # (V,) i64 tail value >> 8 nb, ascending
    frame_freqs: np.ndarray  # (K + V,) i64
    rank_of: np.ndarray     # value -> rank, u32


def escape_plan(nfreqs: np.ndarray):
    """The (K, nb) cut of the frame's ranks (frequency descending, value
    ascending) whose exact expected loss stays within 0.15% of the cross
    entropy, preferring the smallest folded alphabet in 1024-symbol
    buckets, then the smaller loss; None below 2^13 + 1 live symbols or
    when no cut qualifies."""
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    nz = np.flatnonzero(nf)
    sigma = len(nz)
    if sigma < ESCAPE_MIN_SIGMA:
        return None
    fz = nf[nz]
    order = np.lexsort((nz, -fz))
    vals, fs = nz[order], fz[order]
    p = fs.astype(np.float64) / M
    budget = ESCAPE_LOSS_BUDGET * float((p * -np.log2(p)).sum())
    best_key = best = None
    for K in ESCAPE_K_GRID:
        if K >= sigma:
            continue
        tv, tf, tp = vals[K:], fs[K:], p[K:]
        log2_tf = np.log2(tf.astype(np.float64))
        for nb in (1, 2, 3):
            var_highs, inv = np.unique(tv >> (8 * nb), return_inverse=True)
            if len(var_highs) > ESCAPE_MAX_VARIANTS:
                continue
            fesc = np.bincount(inv, weights=tf.astype(np.float64)).astype(
                np.int64)
            delta = float((tp * (8.0 * nb + log2_tf - np.log2(
                fesc.astype(np.float64))[inv])).sum())
            if delta > budget:
                continue
            key = ((K + len(var_highs) + 1023) // 1024, delta, K, nb)
            if best_key is None or key < best_key:
                best_key, best = key, (K, nb, var_highs, fesc)
    if best is None:
        return None
    K, nb, var_highs, fesc = best
    rank_of = np.zeros(len(nf), dtype=np.uint32)
    rank_of[vals] = np.arange(sigma, dtype=np.uint32)
    return Escape(K=K, nb=nb, var_highs=var_highs,
                  frame_freqs=np.concatenate([fs[:K], fesc]),
                  rank_of=rank_of)


def escape_map(plan: Escape, x: np.ndarray):
    """(symbol, exception byte count) of each value under the plan: a hot
    rank codes itself, a tail value its high part's escape symbol."""
    r = plan.rank_of[x]
    hot = r < plan.K
    vid = np.searchsorted(plan.var_highs,
                          (x >> np.uint32(8 * plan.nb)).astype(np.int64))
    sym = np.where(hot, r, np.uint32(plan.K) + vid.astype(np.uint32))
    return (sym.astype(np.uint32),
            np.where(hot, 0, plan.nb).astype(np.uint32))


# --------------------------------------------------------------------------
# the model of an input: the symbols the lanes code and the prelude
# --------------------------------------------------------------------------

@dataclass
class Model:
    prelude: bytes
    sym: np.ndarray          # (n,) u32 frame symbols
    nb: np.ndarray           # (n,) u32 exception bytes of each value
    frame_freqs: np.ndarray  # frequencies of the frame's symbols
    grouped: bool            # the frequency-grouped slot layout


def model(kind: str, fidelity: int, x: np.ndarray,
          counts: np.ndarray | None = None) -> Model:
    """The frame and prelude of `x` as the coder derives them: the byte
    fold's histogram (its frames keep every frequency under 2^16 - 1), or
    the values' own, whose large live alphabets take the tail escape.
    `counts`: the raw-value histogram the model is built from (default:
    x's own; a shard's is that of every shard)."""
    if kind == "fold":
        sym, nb = fold_map(x, fidelity)
        if counts is None:
            hist = np.bincount(sym)
        else:
            live = np.flatnonzero(counts)
            hist = np.bincount(fold_map(live, fidelity)[0],
                               weights=counts[live]).astype(np.int64)
        nfreqs = adjust_freqs(hist, True)
        frame = nfreqs
    else:
        nfreqs = adjust_freqs(np.bincount(x) if counts is None else counts,
                              False)
        plan = escape_plan(nfreqs)
        if plan is None:
            sym, nb = x, np.zeros(len(x), dtype=np.uint32)
            frame = nfreqs
        else:
            sym, nb = escape_map(plan, x)
            frame = plan.frame_freqs
    frame = np.asarray(frame, dtype=np.int64)
    live = np.flatnonzero(frame)
    if len(live) >= GROUPED_MIN_SIGMA:
        # the frequency-grouped slot layout: slots go to the live symbols
        # in rank order (frequency descending, value ascending), so the
        # lanes code each symbol's rank over the frame in that order
        order = live[np.lexsort((live, -frame[live]))]
        rank_of = np.zeros(len(frame), dtype=np.uint32)
        rank_of[order] = np.arange(len(order), dtype=np.uint32)
        sym, frame = rank_of[sym], frame[order]
    return Model(prelude(nfreqs), sym, nb, frame,
                 len(live) >= GROUPED_MIN_SIGMA)


# --------------------------------------------------------------------------
# the lanes: reverse rANS over S lanes, bytes placed in decode order
# --------------------------------------------------------------------------

def lane_scan(sym: np.ndarray, valid: np.ndarray, freq: np.ndarray,
              base: np.ndarray, log2m: int):
    """The reverse scan of D streams of (T, S) staged symbols: (renorm
    byte count (D, T, S) u8, the three candidate renorm bytes, each
    (D, T, S) u8, final states (D, S) u32).  A lane's step t renormalises
    while its state is at least freq << (31 - log2 M), emitting the low
    byte each time, then state = (state // f) * M + state % f + base."""
    D, T, S = sym.shape
    f_tab = np.maximum(freq.astype(np.int64), 1)
    b_tab = base.astype(np.int64)
    state = np.full((D, S), A_L, dtype=np.int64)
    rc = np.zeros((D, T, S), dtype=np.uint8)
    rb = [np.zeros((D, T, S), dtype=np.uint8) for _ in range(3)]
    for t in range(T - 1, -1, -1):
        s = sym[:, t]
        v = valid[:, t]
        f = f_tab[s]
        ub = f << (31 - log2m)
        st = state
        cnt = rc[:, t]
        for i in range(3):
            e = v & (st >= ub)
            rb[i][:, t] = st & 0xFF
            cnt += e
            st = np.where(e, st >> 8, st)
        q = st // f
        state = np.where(v, (q << log2m) + (st - q * f) + b_tab[s], state)
    return rc, rb, state.astype(np.uint32)


def _round_bytes(count: np.ndarray, b0, b1, b2):
    """The bytes of the three rounds of a lane that emitted `count` of
    b0, b1, b2 (in that order): read back last first."""
    return (np.where(count == 1, b0, np.where(count == 2, b1, b2)),
            np.where(count == 2, b0, b1), b0)


def lane_place(rc: np.ndarray, rb: list, nb: np.ndarray, low: np.ndarray,
               block: int = 256):
    """One stream's bytes in decode order and each step's offset in it:
    step after step, six rounds a step (renorm bytes 1-3, then exception
    bytes 1-3, each read high byte first), in a round the lanes that read
    a byte, in lane order.  rc, nb, low and the three planes of rb are
    (T, S)."""
    T, S = rc.shape
    parts, counts = [], []
    for t0 in range(0, T, block):
        sl = slice(t0, t0 + block)
        c, k, lw = rc[sl], nb[sl].astype(np.uint8), low[sl]
        lb = [((lw >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8)
              for i in range(3)]
        byte = np.stack([*_round_bytes(c, rb[0][sl], rb[1][sl], rb[2][sl]),
                         *_round_bytes(k, *lb)], axis=1)
        mask = np.stack([c > 0, c > 1, c > 2, k > 0, k > 1, k > 2], axis=1)
        parts.append(byte[mask])
        counts.append(mask.reshape(len(c), -1).sum(axis=1))
    counts = np.concatenate(counts)
    step_base = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
    return np.concatenate(parts), step_base


def choose_sections(step_base: np.ndarray, total: int, T: int):
    """(t_sec, section lengths): the largest multiple of 32 steps, halved
    from T, whose aligned sections hold at most 3 MiB each."""
    t_sec, (lens,) = choose_sections_joint([step_base], [total], T)
    return t_sec, lens


def choose_sections_joint(step_bases, totals, T: int):
    """One t_sec for several streams (each stream's sections <= 3 MiB),
    halving from T: (t_sec, [section lengths of each stream])."""
    q = SECTION_QUANTUM
    t_sec = -(-T // q) * q
    bounds = [np.append(b, int(tot)) for b, tot in zip(step_bases, totals)]
    while True:
        cuts = np.arange(0, T, t_sec)
        ends = np.minimum(cuts + t_sec, T)
        lens = [b[ends] - b[cuts] for b in bounds]
        if max(int(ln.max()) for ln in lens) <= SECTION_CAP or t_sec <= q:
            return t_sec, [ln.astype(np.int64) for ln in lens]
        t_sec = max(q, (t_sec // 2 // q) * q)


def lane_blob(states: np.ndarray, stream: np.ndarray, t_sec: int,
              sec_len: np.ndarray) -> bytes:
    """u8 fmt 2 | u8 log2 S | u16 sections | u32 stream length | u32 t_sec
    | u32 section lengths | u32 states | the stream."""
    S = len(states)
    return (bytes((FMT_LOCKSTEP, S.bit_length() - 1))
            + struct.pack("<HII", len(sec_len), len(stream), t_sec)
            + np.asarray(sec_len, dtype="<u4").tobytes()
            + np.asarray(states, dtype="<u4").tobytes()
            + stream.tobytes())


# --------------------------------------------------------------------------
# what the benchmark compares
# --------------------------------------------------------------------------

@dataclass
class Encoded:
    blob: bytes
    streams: list            # (L_d,) u8 of each section (one: the stream)
    states: np.ndarray       # (D, S) u32
    sigma: int               # symbols of the coded frame
    exception_bytes: int     # bytes of the exception channel


def encode(method: str, x: np.ndarray, lanes: int, sections: int = 0,
           counts: np.ndarray | None = None) -> Encoded:
    """The blob of `x` under `method` at `lanes` lanes: one lane-format
    stream after the prelude (sections=0), or the ATFB container of
    `sections` sections of ceil(n / D) values.  `counts`: the raw-value
    histogram of the model (default: x's own), such as the sum over the
    shards of one array, each shard coded under the model of all."""
    kind, fidelity = parse_method(method)
    x = np.ascontiguousarray(x, dtype=np.uint32)
    n = len(x)
    mdl = model(kind, fidelity, x, counts)
    nb = mdl.nb
    frame = mdl.frame_freqs
    M = int(frame.sum())
    log2m = M.bit_length() - 1
    base = np.concatenate(([0], np.cumsum(frame)[:-1]))
    D = max(sections, 1)
    B = -(-n // D)
    T = -(-B // lanes)
    n_sec = np.clip(n - B * np.arange(D), 0, B)

    def staged(a):
        flat = np.zeros(D * B, dtype=np.uint32)
        flat[:n] = a
        out = np.zeros((D, T * lanes), dtype=np.uint32)
        out[:, :B] = flat.reshape(D, B)
        return out.reshape(D, T, lanes)

    pos = np.arange(T * lanes).reshape(T, lanes)
    valid = pos[None] < n_sec[:, None, None]
    rc, rb, states = lane_scan(staged(mdl.sym).astype(np.int64), valid,
                               frame, base, log2m)
    kst, low = staged(nb), staged(x & np.uint32(0xFFFFFF))
    streams, bases = [], []
    for d in range(D):
        s, b = lane_place(rc[d], [p[d] for p in rb], kst[d], low[d])
        streams.append(s)
        bases.append(b)
    totals = [len(s) for s in streams]
    if sections == 0:
        t_sec, sec_len = choose_sections(bases[0], totals[0], T)
        blob = mdl.prelude + lane_blob(states[0], streams[0], t_sec, sec_len)
    else:
        if _joint_cut(frame, lanes, mdl.grouped):
            t_sec, lens = choose_sections_joint(bases, totals, T)
            cuts = [(t_sec, ln) for ln in lens]
        else:
            cuts = [choose_sections(b, tot, T)
                    for b, tot in zip(bases, totals)]
        out = bytearray(ATFB_HEADER.pack(ATFB_MAGIC, ATFB_VERSION,
                                         ATFB_KINDS[kind], fidelity, 1, n, D))
        out += struct.pack("<I", len(mdl.prelude)) + mdl.prelude
        for d, (t_sec, sec_len) in enumerate(cuts):
            sec = lane_blob(states[d], streams[d], t_sec, sec_len)
            out += struct.pack("<I", len(sec)) + sec
        blob = bytes(out)
    return Encoded(blob=blob, streams=streams, states=states,
                   sigma=int(np.count_nonzero(frame)),
                   exception_bytes=int(nb.sum(dtype=np.int64)))


def _joint_cut(frame: np.ndarray, S: int, grouped: bool) -> bool:
    """Whether the container cuts all its sections with one t_sec (the
    production engine's cut: S a power-of-two multiple of 128, 2 <= M <=
    2^22, a grouped frame or a value-ordered one of <= 2^13 symbols, no
    symbol owning the whole frame); else each section is cut on its
    own."""
    M = int(frame.sum())
    return (S >= 128 and S % 128 == 0 and (S // 128) & (S // 128 - 1) == 0
            and 2 <= M <= (1 << 22) and (grouped or len(frame) <= (1 << 13))
            and int(frame.max()) < M)


def lossy_values(x: np.ndarray) -> np.ndarray:
    """The control's values: each value less the low bytes the byte fold
    of fidelity 2 strips from it."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    _, k = fold_map(x, 2)
    keep = ~((np.uint64(1) << (np.uint64(8) * k.astype(np.uint64)))
             - np.uint64(1))
    return (x.astype(np.uint64) & keep).astype(np.uint32)
