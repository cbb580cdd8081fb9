"""Paper Table 10: encode/decode integers-per-second per method.

reference: src/table_efficiency.cpp:64-121 — min of NUM_RUNS timings of
the full encode()/decode() calls, round-trip verified after decode
(REQUIRE_EQUAL, cutil.hpp:30-50).
"""

from __future__ import annotations

import time

import numpy as np

from . import _cli

NUM_RUNS = 5

DEFAULT_METHODS = [
    "vbyte", "vbytehuffzero", "vbytefse", "optpfor", "shuff", "arith",
    "ANS", "ANSfold-1", "ANSfold-5", "ANSrfold-1", "ANSrfold-5",
]


def _min_time(fn, runs=NUM_RUNS):
    best = float("inf")
    result = None
    for _ in range(runs):
        t0 = time.perf_counter()
        result = fn()
        best = min(best, time.perf_counter() - t0)
    return best, result


def run(inputs, methods, num_runs=NUM_RUNS):
    rows = {}
    for name, codec in methods:
        print(f"\\method{{{name}}}  &")
        speeds = []
        for dname, values in inputs:
            codec.encode(values)  # warmup (jit compile)
            enc_t, blob = _min_time(lambda: codec.encode(values), num_runs)
            codec.decode(blob, len(values))  # warmup
            dec_t, out = _min_time(lambda: codec.decode(blob, len(values)),
                                   num_runs)
            np.testing.assert_array_equal(
                np.asarray(out, dtype=np.uint32), values,
                err_msg=f"{name} round-trip failed on {dname}")
            speeds.append((len(values) / enc_t, len(values) / dec_t))
        for i, (e, d) in enumerate(speeds):
            pad = " " * (4 * i)
            tail = "\\\\ \n" if i + 1 == len(speeds) else "&"
            print(f"{pad}{e:15.4f}  &  {d:15.4f}  {tail}")
        rows[name] = speeds
    return rows


def main(argv=None):
    p = _cli.make_parser("encode/decode ints per second", methods_arg=True)
    p.add_argument("--runs", type=int, default=NUM_RUNS)
    args = p.parse_args(argv)
    inputs = _cli.load_inputs(args)
    run(inputs, _cli.select_methods(args, DEFAULT_METHODS), args.runs)


if __name__ == "__main__":
    main()
