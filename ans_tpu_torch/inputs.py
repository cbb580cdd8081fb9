"""The full-width inputs the card scripts draw (chip_smoke.py,
profile_idle.py), made with NumPy from fixed seeds.

  * bench:   bench.py make_data(), zipf(1.25) clipped to 2^28 - 1, the
             main path's input;
  * zipf20:  tools/bench_grouped.py's zipf20, Zipf(1) over 2^20 values
             (seed 0), the grouped path's input;
  * dense22: every value of 0..2^16-1 (the even ones twice) tiled over
             n/2 values, then n/2 Zipf(1.5) draws over the same range
             (seed 8): tail frequencies alternating 1/2 make the tail
             escape decline, so ANS codes a 2^16-symbol grouped frame;
  * zipf125: Zipf(1.25) over 2^28 values less one (seed 42), drawn by
             `zipf_sample`: bench's distribution, the same under both
             numpys (the pseudo-adaptive path's input beside zipf20).

`zipf_sample` is a copy of ans_tpu/utils/zipf.py (rejection-inversion on
`rng.random`, held equal to it by tests/test_torch_slice.py): it draws
the same values under numpy 2.0.2 and 2.3.5, where `rng.zipf` (bench)
does not.  tests/fixtures/lane/make_fixtures.py writes the reference
blobs of these inputs with ans_tpu.
"""

from __future__ import annotations

import numpy as np


def zipf_sample(rng: np.random.Generator, size: int, N: int,
                q: float = 1.0) -> np.ndarray:
    """`size` samples of Zipf(q) over {1..N}."""
    def H(x):
        if abs(q - 1.0) < 1e-8:
            return np.log(x)
        return (np.power(x, 1.0 - q) - 1.0) / (1.0 - q)

    def H_inv(u):
        if abs(q - 1.0) < 1e-8:
            return np.exp(u)
        return np.power(np.maximum(1.0 + u * (1.0 - q), 1e-300),
                        1.0 / (1.0 - q))

    H_x1 = float(H(1.5)) - 1.0
    H_n = float(H(N + 0.5))
    out = np.empty(size, dtype=np.uint32)
    filled = 0
    while filled < size:
        m = max(1024, int((size - filled) * 1.25))
        u = H_x1 + rng.random(m) * (H_n - H_x1)
        k = np.clip(np.round(H_inv(u)), 1.0, float(N))
        accept = u >= H(k + 0.5) - np.power(k, -q)
        got = k[accept].astype(np.uint32)[: size - filled]
        out[filled:filled + len(got)] = got
        filled += len(got)
    return out


def bench_input(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.25, size=n) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def zipf20_input(n: int) -> np.ndarray:
    return zipf_sample(np.random.default_rng(0), n, 1 << 20)


def zipf125_input(n: int) -> np.ndarray:
    return zipf_sample(np.random.default_rng(42), n, 1 << 28, 1.25) - 1


def dense_input(n: int) -> np.ndarray:
    head = np.concatenate([np.arange(1 << 16), np.arange(0, 1 << 16, 2)])
    head = np.tile(head, -(-(n // 2) // len(head)))[: n // 2]
    tail = zipf_sample(np.random.default_rng(8), n - n // 2, 1 << 16,
                       1.5) - 1
    return np.concatenate([head.astype(np.uint32), tail])
