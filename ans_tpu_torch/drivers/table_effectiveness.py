"""Paper Table 9: bits-per-integer per method per dataset.

reference: src/table_effectiveness.cpp (encode-only; LaTeX-ish rows).
"""

from __future__ import annotations

from ..utils import metrics
from . import _cli

DEFAULT_METHODS = [
    "huffzero", "fse", "vbyte", "optpfor", "shuff", "arith", "vbytefse",
    "vbytehuffzero", "vbyteANS", "ANS", "ANSmsb", "entropy_only",
]


def run(inputs, methods):
    for name, codec in methods:
        print(f"\\method{{{name}}}  &")
        bpis = []
        for _, values in inputs:
            blob = codec.encode(values)
            bpis.append(8.0 * len(blob) / len(values))
        for i, bpi in enumerate(bpis):
            pad = " " * (4 * i)
            tail = "\\\\ \n" if i + 1 == len(bpis) else "&"
            print(f"{pad}{bpi:15.4f}  {tail}")


def main(argv=None):
    p = _cli.make_parser("bits/int per method per dataset",
                         methods_arg=True)
    args = p.parse_args(argv)
    inputs = _cli.load_inputs(args)
    for name, values in inputs:
        print(f"% {name}: n={len(values)} sigma={metrics.compute_sigma(values)} "
              f"H0={metrics.compute_entropy(values):.4f}")
    run(inputs, _cli.select_methods(args, DEFAULT_METHODS))


if __name__ == "__main__":
    main()
