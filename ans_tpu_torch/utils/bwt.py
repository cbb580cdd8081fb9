"""Suffix array, BWT and move-to-front transforms for data preparation.

Counterpart of reference src/generate_bwtmtf.cpp (which uses the vendored
qsufsort, include/qsufsort.hpp): here the suffix array is prefix-doubling
(Manber-Myers) on NumPy argsorts — O(n log^2 n), fully vectorized — and
MTF is a small-alphabet vectorized rank transform.

A copy of ans_tpu/utils/bwt.py: `mtf` runs in the port's host library
through the module global `_native` (native.deferred); its Python loop is
the plain version, run when `_native` is None.
"""

from __future__ import annotations

import numpy as np

from ..native import deferred as _native


def suffix_array(seq: np.ndarray) -> np.ndarray:
    """Suffix array of an integer sequence (no sentinel needed: shorter
    suffixes sort first via rank padding with -1)."""
    s = np.asarray(seq, dtype=np.int64)
    n = len(s)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = np.unique(s, return_inverse=True)[1].astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        key2 = np.where(idx + k < n, rank[np.minimum(idx + k, n - 1)], -1)
        order = np.lexsort((key2, rank))
        r2 = np.where(order + k < n,
                      rank[np.minimum(order + k, n - 1)], -1)
        new_rank = np.zeros(n, dtype=np.int64)
        pair_prev = (rank[order[1:]] != rank[order[:-1]]) | \
            (r2[1:] != r2[:-1])
        new_rank[order[1:]] = np.cumsum(pair_prev)
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2


def bwt(seq: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over the suffix-array order (reference generate_bwtmtf.cpp:
    152-158: bwt[i] = seq[sa[i]-1], with the first-suffix position
    recorded).  Returns (transformed, primary_index)."""
    s = np.asarray(seq)
    if len(s) == 0:
        raise ValueError("cannot BWT an empty sequence")
    sa = suffix_array(s)
    primary = int(np.flatnonzero(sa == 0)[0])
    return s[(sa - 1) % len(s)], primary


def mtf(seq: np.ndarray, sigma: int | None = None) -> np.ndarray:
    """Move-to-front ranks (reference generate_bwtmtf.cpp:111-118,
    164-174).  Sequential by nature; runs in the host library
    (ans_native.cpp ans_mtf), the Python loop when `_native` is None."""
    s = np.asarray(seq, dtype=np.int64)
    if sigma is None:
        sigma = int(s.max()) + 1 if len(s) else 0
    elif len(s) and int(s.max()) >= sigma:
        # the native path would index past its sigma-sized tables
        raise ValueError(f"mtf: symbol {int(s.max())} out of range for "
                         f"sigma={sigma}")
    if _native is not None and len(s):
        return _native.mtf(s.astype(np.uint32), sigma)
    table = list(range(sigma))
    pos = {v: i for i, v in enumerate(table)}
    out = np.empty(len(s), dtype=np.uint32)
    for i, v in enumerate(s.tolist()):
        r = pos[v]
        out[i] = r
        if r:
            moved = table[:r]
            table[1:r + 1] = moved
            table[0] = v
            for j, m in enumerate(moved):
                pos[m] = j + 1
            pos[v] = 0
    return out


def mtf_inverse(ranks: np.ndarray, sigma: int) -> np.ndarray:
    table = list(range(sigma))
    out = np.empty(len(ranks), dtype=np.uint32)
    for i, r in enumerate(np.asarray(ranks).tolist()):
        v = table[r]
        out[i] = v
        if r:
            del table[r]
            table.insert(0, v)
    return out
