"""General method sweep: name, n, sigma, H0, BPI, ns/int per method.

reference: src/benchmark.cpp — NUM_RUNS=3, full ANSsint/ANSsmsb H_approx
grid {1,5,10,20,40,80,160,320}, ANSfold f=1..8, ANSrfold f=1..4, plus
baselines; round-trip verified each run.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils import metrics
from . import _cli

NUM_RUNS = 3

DEFAULT_METHODS = (
    [f"ANSsmsb-{h}" for h in (1, 5, 10, 20, 40, 80, 160, 320)]
    + [f"ANSsint-{h}" for h in (1, 5, 10, 20, 40, 80, 160, 320)]
    + ["ANSmsb", "ANS", "shuff", "arith"]
    + [f"ANSfold-{f}" for f in (1, 2, 3, 4)]
    + [f"ANSrfold-{f}" for f in (1, 2, 3, 4)]
    + [f"ANSfold-{f}" for f in (5, 6, 7, 8)]
    + ["vbyte", "optpfor", "streamvbyte", "huffzero", "fse", "vbytefse",
       "streamvbytefse", "vbytehuffzero", "streamvbyteANS", "vbyteANS"]
)


def run_one(name, codec, values, input_name, num_runs=NUM_RUNS):
    h0 = metrics.compute_entropy(values)
    sigma = metrics.compute_sigma(values)
    codec.encode(values)  # warmup/compile
    enc_t, blob = float("inf"), None
    for _ in range(num_runs):
        t0 = time.perf_counter()
        blob = codec.encode(values)
        enc_t = min(enc_t, time.perf_counter() - t0)
    codec.decode(blob, len(values))  # warmup
    dec_t, out = float("inf"), None
    for _ in range(num_runs):
        t0 = time.perf_counter()
        out = codec.decode(blob, len(values))
        dec_t = min(dec_t, time.perf_counter() - t0)
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint32), values,
                                  err_msg=f"{name} failed on {input_name}")
    bpi = 8.0 * len(blob) / len(values)
    print(f"{input_name:>25.25s}\t\t{len(values):15d}\t\t{sigma:15d}\t\t"
          f"{name:>18.18s}\t\t{h0:2.4f}\t\t{bpi:2.4f}\t\t"
          f"{enc_t * 1e9 / len(values):2.3f}\t\t"
          f"{dec_t * 1e9 / len(values):2.3f}\t\t", flush=True)
    return dict(name=name, input=input_name, n=len(values), sigma=sigma,
                h0=h0, bpi=bpi, enc_ips=len(values) / enc_t,
                dec_ips=len(values) / dec_t)


def main(argv=None):
    p = _cli.make_parser("general benchmark sweep", methods_arg=True)
    p.add_argument("--runs", type=int, default=NUM_RUNS)
    args = p.parse_args(argv)
    inputs = _cli.load_inputs(args)
    methods = _cli.select_methods(args, DEFAULT_METHODS)
    for input_name, values in inputs:
        for name, codec in methods:
            run_one(name, codec, values, input_name, args.runs)


if __name__ == "__main__":
    main()
