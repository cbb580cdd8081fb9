"""Model-quality study: rescaling inefficiency vs frame factor.

reference: src/rescale_freqs.cpp:63-139 — for frame_factor 1..31, rescale
the sorted histogram onto frame next_pow2(sigma*factor) with the blended
ratio schedule, then report XH, prelude BPI and total inefficiency vs H0.
"""

from __future__ import annotations

import numpy as np

from ..models.config import next_pow2
from ..reference_model import interp
from ..utils import metrics
from . import _cli


def rescale_study(values: np.ndarray, name: str):
    m = len(values)
    h0 = metrics.compute_entropy(values)
    max_sym = int(values.max())
    counts = np.bincount(values, minlength=max_sym + 1)
    present = np.flatnonzero(counts)
    sigma = len(present)
    # decreasing-count order, ties by symbol: the reference sorts
    # pairs (-count, sym) ascending (rescale_freqs.cpp:75-81); the
    # blend ratio is index-asymmetric, so the order changes every row
    order = np.lexsort((present, -counts[present]))
    F = counts[present][order].astype(np.int64)
    syms = present[order]

    rows = []
    for frame_factor in range(1, 32):
        frame_size = sigma * frame_factor
        if frame_size & (frame_size - 1):
            frame_size = next_pow2(frame_size)
        init_m = frame_size
        S = np.zeros(sigma, dtype=np.int64)
        fs, in_len = frame_size, m
        fratio = frame_size / m
        for i in range(sigma - 1, -1, -1):
            aratio = fs / in_len
            ratio = (i * fratio + (sigma - i) * aratio) / sigma
            s = int(0.5 + ratio * F[i])
            S[i] = max(s, 1)
            fs -= S[i]
            in_len -= F[i]
        prelude = np.zeros(max_sym + 1, dtype=np.int64)
        prelude[syms] = S
        increasing = np.cumsum(prelude + 1) - 1
        pre_bytes = len(interp.encode(increasing, max_sym + 1,
                                      init_m + max_sym)) + 8
        prelude_bpi = pre_bytes * 8 / m
        xh = metrics.cross_entropy_of_freqs(counts, prelude)
        ineff = 100.0 * (xh - h0) / h0
        total = xh + prelude_bpi
        ineff2 = 100.0 * (total - h0) / h0
        print(f"{name:<15s}\tM={init_m:<12d}\tH0={h0:2.2f}\tXH={xh:2.2f}\t"
              f"INEFF={ineff:2.2f}\tPRELUDE_BPI={prelude_bpi:2.2f}\t"
              f"TOTAL_BPI={total:2.2f}\tTOTAL_INEFF={ineff2:2.2f}",
              flush=True)
        rows.append(dict(frame=init_m, xh=xh, prelude_bpi=prelude_bpi,
                         total=total))
    return rows


def main(argv=None):
    p = _cli.make_parser("rescale inefficiency study")
    args = p.parse_args(argv)
    for name, values in _cli.load_inputs(args):
        rescale_study(values, name)


if __name__ == "__main__":
    main()
