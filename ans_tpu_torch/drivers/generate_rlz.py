"""RLZ (relative Lempel-Ziv) factor extraction for dataset preparation.

Counterpart of reference src/generate_rlz.cpp, which depends on the
external rlz-store project and is not even wired into the reference's
CMakeLists (SURVEY.md section 2.5: "unbuildable as-shipped"; the paper's
rlz-d64 datasets are downloaded pre-made).  This implementation is
self-contained: greedy longest-match factorization of a text against a
dictionary prefix, using the framework's suffix array with binary-search
matching.  Outputs the two streams the experiments consume: factor
lengths and factor offsets (.u32), literals encoded as (offset=byte,
len=0) like classic RLZ.
"""

from __future__ import annotations

import numpy as np

from ..utils import bwt, io, timing
from . import _cli


def rlz_factorize(text: np.ndarray, dict_bytes: np.ndarray):
    """Greedy RLZ of `text` against dictionary `dict_bytes`.

    Returns (lengths u32, offsets u32): length >= 1 factors copy
    dict[offset : offset+length]; length == 0 emits the literal stored
    in `offset`.
    """
    D = np.asarray(dict_bytes, dtype=np.uint8)
    T = np.asarray(text, dtype=np.uint8)
    sa = bwt.suffix_array(D)
    nd = len(D)
    Di = D.astype(np.int32)

    def lower_bound(lo, hi, depth, c):
        # suffixes in [lo, hi) share a depth-length prefix, so their
        # depth-th chars are sorted; exhausted suffixes sort first
        while lo < hi:
            mid = (lo + hi) >> 1
            p = int(sa[mid]) + depth
            key = int(D[p]) if p < nd else -1
            if key < c:
                lo = mid + 1
            else:
                hi = mid
        return lo

    # maintain [lo, hi) of suffixes matching the current factor prefix;
    # wide ranges narrow by O(log) binary search (a full-range scan per
    # depth step is quadratic on run-heavy dictionaries), small ranges
    # by one vectorized compare
    lens, offs = [], []
    i = 0
    n = len(T)
    while i < n:
        lo, hi = 0, nd
        depth = 0
        best = 0
        best_suf = -1
        while i + depth < n and lo < hi:
            c = int(T[i + depth])
            if hi - lo > 64:
                lo2 = lower_bound(lo, hi, depth, c)
                hi2 = lower_bound(lo2, hi, depth, c + 1)
            else:
                pos = sa[lo:hi] + depth
                keys = np.where(pos < nd,
                                Di[np.minimum(pos, nd - 1)], -1)
                inner = np.flatnonzero(keys == c)
                if len(inner) == 0:
                    break
                lo2, hi2 = lo + int(inner[0]), lo + int(inner[-1]) + 1
            if lo2 >= hi2:
                break
            lo, hi = lo2, hi2
            depth += 1
            best = depth
            best_suf = int(sa[lo])
        if best == 0:
            lens.append(0)
            offs.append(int(T[i]))
            i += 1
        else:
            lens.append(best)
            offs.append(best_suf)
            i += best
    return (np.asarray(lens, dtype=np.uint32),
            np.asarray(offs, dtype=np.uint32))


def rlz_reconstruct(lens, offs, dict_bytes) -> np.ndarray:
    D = np.asarray(dict_bytes, dtype=np.uint8)
    out = []
    for ln, of in zip(np.asarray(lens).tolist(), np.asarray(offs).tolist()):
        if ln == 0:
            out.append(np.array([of], dtype=np.uint8))
        else:
            out.append(D[of:of + ln])
    return np.concatenate(out) if out else np.empty(0, np.uint8)


def main(argv=None):
    p = _cli.make_parser("RLZ factor extraction", output_arg=True)
    p.add_argument("--dict-frac", type=float, default=0.1,
                   help="fraction of the input used as the dictionary")
    args = p.parse_args(argv)
    raw = np.frombuffer(open(args.input, "rb").read(), dtype=np.uint8)
    d = max(1, int(len(raw) * args.dict_frac))
    with timing.timer("rlz"):
        lens, offs = rlz_factorize(raw[d:], raw[:d])
    io.write_file_u32(args.output + ".lens.u32", lens)
    io.write_file_u32(args.output + ".offsets.u32", offs)
    print(f"{len(lens)} factors; mean len "
          f"{float(lens.mean()) if len(lens) else 0:.2f}")


if __name__ == "__main__":
    main()
