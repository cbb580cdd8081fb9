"""Entropy and throughput metrics (reference: include/util.hpp:250-311).

A copy of ans_tpu/utils/metrics.py.
"""

from __future__ import annotations

import numpy as np


def compute_entropy(values) -> float:
    """Zero-order entropy H0 of a sequence in bits/symbol
    (util.hpp:250-269)."""
    values = np.asarray(values)
    counts = np.unique(values, return_counts=True)[1]
    p = counts / len(values)
    return float(-(p * np.log2(p)).sum())


def compute_sigma(values) -> int:
    """Number of distinct symbols."""
    return int(len(np.unique(np.asarray(values))))


def entropy_of_freqs(freqs) -> float:
    """H0 of a frequency vector (util.hpp:271-282)."""
    f = np.asarray(freqs, dtype=np.float64)
    f = f[f > 0]
    p = f / f.sum()
    return float(-(p * np.log2(p)).sum())


def cross_entropy_of_freqs(P, Q) -> float:
    """Cross entropy of model Q against empirical P (util.hpp:284-298)."""
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    k = min(len(P), len(Q))
    m = (P[:k] > 0) & (Q[:k] > 0)
    return float(-(P[:k][m] / P.sum() * np.log2(Q[:k][m] / Q.sum())).sum())


def compute_ips(n: int, seconds: float) -> float:
    """Integers per second (util.hpp:300-305)."""
    return n / seconds if seconds > 0 else float("inf")


def compute_mips(n: int, seconds: float) -> float:
    return compute_ips(n, seconds) / 1e6
