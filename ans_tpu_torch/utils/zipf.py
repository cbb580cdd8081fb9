"""Zipf sampler via rejection-inversion (Hörmann & Derflinger 1996).

Behavioral equivalent of the reference's sampler
(reference: include/zipf_dist.hpp:30-114): draw u uniform on
[H(1.5)-1, H(n+0.5)], invert x = H^{-1}(u), accept k = round(x) when
u >= H(k+0.5) - h(k).  Vectorized: batches of candidates are drawn and
filtered en masse instead of the scalar retry loop, so the distribution
matches but the random stream differs (the reference consumes
std::mt19937 scalars).

A copy of ans_tpu/utils/zipf.py: it draws the same values under numpy
2.0.2 and 2.3.5 (rng.zipf does not), so the card scripts' inputs
(ans_tpu_torch/inputs.py) are drawn with it.
"""

from __future__ import annotations

import numpy as np


def _H(x, q: float):
    # H(x) = (x^(1-q) - 1) / (1-q); log(x) in the q -> 1 limit
    if abs(q - 1.0) < 1e-8:
        return np.log(x)
    return (np.power(x, 1.0 - q) - 1.0) / (1.0 - q)


def _H_inv(u, q: float):
    if abs(q - 1.0) < 1e-8:
        return np.exp(u)
    return np.power(np.maximum(1.0 + u * (1.0 - q), 1e-300),
                    1.0 / (1.0 - q))


def zipf(rng: np.random.Generator, size: int, N: int, q: float = 1.0
         ) -> np.ndarray:
    """`size` samples from Zipf(q) over {1..N} (reference default q=1)."""
    H_x1 = float(_H(1.5, q)) - 1.0
    H_n = float(_H(N + 0.5, q))
    out = np.empty(size, dtype=np.uint32)
    filled = 0
    while filled < size:
        m = max(1024, int((size - filled) * 1.25))
        u = H_x1 + rng.random(m) * (H_n - H_x1)
        x = _H_inv(u, q)
        k = np.clip(np.round(x), 1.0, float(N))
        accept = u >= _H(k + 0.5, q) - np.power(k, -q)
        got = k[accept].astype(np.uint32)[: size - filled]
        out[filled:filled + len(got)] = got
        filled += len(got)
    return out
