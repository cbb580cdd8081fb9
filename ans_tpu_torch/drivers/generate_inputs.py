"""Synthetic dataset generation (reference: src/generate_inputs.cpp).

Same families as the reference: uniform over 2^8/2^12/2^16/2^20,
geometric p in {.01,.1,.2,.4,.6,.8,.9,.99}, zipf over 2^12 and 2^20
universes.  Fixed seed 0 like the reference (generate_inputs.cpp:70);
the RNG is numpy's PCG64 rather than std::mt19937, so sample streams
differ while the distributions match (documented deviation).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import io, zipf
from . import _cli


def generate_all(output: str, n: int, text: bool = False,
                 seed: int = 0) -> list[str]:
    os.makedirs(output, exist_ok=True)
    written = []

    def emit(name, values):
        ext = ".txt" if text else ".u32"
        path = os.path.join(output, name + ext)
        print(f"generating file {path}")
        (io.write_file_text if text else io.write_file_u32)(path, values)
        written.append(path)

    for bits in (8, 12, 16, 20):
        rng = np.random.default_rng(seed)
        emit(f"uniform{bits:02d}",
             rng.integers(0, 1 << bits, size=n, dtype=np.uint32))
    for p in (0.01, 0.1, 0.2, 0.4, 0.6, 0.8, 0.9, 0.99):
        rng = np.random.default_rng(seed)
        # std::geometric_distribution counts failures before success (>= 0)
        emit(f"geom{p}", (rng.geometric(p, size=n) - 1).astype(np.uint32))
    for bits in (12, 20):
        rng = np.random.default_rng(seed)
        emit(f"zipf{bits}", zipf.zipf(rng, n, 1 << bits))
    return written


def main(argv=None):
    p = _cli.make_parser("generate synthetic inputs", input_arg=False,
                         output_arg=True, num_arg=True)
    p.add_argument("-t", "--text", action="store_true")
    args = p.parse_args(argv)
    generate_all(args.output, args.num, args.text)


if __name__ == "__main__":
    main()
