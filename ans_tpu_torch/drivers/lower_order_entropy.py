"""H0 and sigma of inputs masked to their low k bits, k = 1..32.

reference: src/lower_order_entropy.cpp:154-164; output name;sigma;k;H0.
"""

from __future__ import annotations

import numpy as np

from ..utils import metrics
from . import _cli


def run(values: np.ndarray, name: str):
    for k in range(1, 33):
        mask = np.uint32((1 << k) - 1) if k < 32 else np.uint32(0xFFFFFFFF)
        v = values & mask
        sigma = metrics.compute_sigma(v)
        h0 = metrics.compute_entropy(v)
        print(f"{name};{sigma};{k};{h0:2.4f}", flush=True)


def main(argv=None):
    p = _cli.make_parser("lower-order entropy sweep")
    args = p.parse_args(argv)
    for name, values in _cli.load_inputs(args):
        run(values, name)


if __name__ == "__main__":
    main()
