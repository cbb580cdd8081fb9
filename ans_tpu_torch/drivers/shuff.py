"""Standalone shuff round-trip + BPI on a single file.

reference: src/shuff.cpp:1-49 — encode, decode, verify, report bits/int.
"""

from __future__ import annotations

import numpy as np

from ..models.shuff import Shuff
from ..utils import io, metrics
from . import _cli


def main(argv=None):
    p = _cli.make_parser("shuff round-trip on one file")
    args = p.parse_args(argv)
    values = io.read_input(args.input)
    codec = Shuff()
    blob = codec.encode(values)
    out = codec.decode(blob, len(values))
    np.testing.assert_array_equal(out, values)
    print(f"n={len(values)} sigma={metrics.compute_sigma(values)} "
          f"H0={metrics.compute_entropy(values):.4f} "
          f"bpi={8 * len(blob) / len(values):.4f}")


if __name__ == "__main__":
    main()
