"""Fold-bucket skew analysis (paper section on fold entropy loss).

reference: src/bucket_skew.cpp:62-149 — for each used bucket of the fold
mapping at fidelity f=1..6: min/max value, size, usage, cumulative usage,
and the per-symbol entropy loss (bits_uniform - bits_real) of coding the
in-bucket offsets uniformly.  Output: `;`-separated lines.
"""

from __future__ import annotations

import numpy as np

from ..reference_model import mappings
from . import _cli


def compute_skew(values: np.ndarray, name: str, fidelity: int):
    buckets = mappings.fold_map(values, fidelity)
    high, nb = mappings.fold_unmap_high(
        np.arange(int(buckets.max()) + 1, dtype=np.uint32), fidelity)
    # bucket b covers [high[b], high[b] + 256**nb[b] - 1]
    bucket_min = high.astype(np.int64)
    bucket_size = np.int64(1) << (8 * nb.astype(np.int64))
    bucket_max = bucket_min + bucket_size - 1

    order = np.argsort(buckets, kind="stable")
    sb = buckets[order]
    sv = values[order].astype(np.int64)
    uniq, start = np.unique(sb, return_index=True)
    usage = np.diff(np.append(start, len(sb)))
    rows = []
    cum = 0
    for b, s, u in zip(uniq.tolist(), start.tolist(), usage.tolist()):
        vals = sv[s:s + u] - bucket_min[b]
        cnt = np.unique(vals, return_counts=True)[1].astype(np.float64)
        p = cnt / u
        bits_real = float(-(p * np.log2(p)).sum())
        bits_uniform = float(np.log2(bucket_size[b]))
        cum += u
        rows.append((name, int(b), fidelity, int(bucket_min[b]),
                     int(bucket_max[b]), int(bucket_size[b]), int(u), cum,
                     len(values), bits_uniform - bits_real))
        print(";".join(str(x) if not isinstance(x, float) else f"{x:g}"
                       for x in rows[-1]), flush=True)
    return rows


def main(argv=None):
    p = _cli.make_parser("per-bucket fold skew")
    args = p.parse_args(argv)
    for input_name, values in _cli.load_inputs(args):
        for fidelity in range(1, 7):
            compute_skew(values, input_name, fidelity)


if __name__ == "__main__":
    main()
