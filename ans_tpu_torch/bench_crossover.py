"""Time the decode engines against each other on one CUDA card: the
measurements behind models/engine.py's `choose_decode_engine`.

    python3 -m ans_tpu_torch.bench_crossover [--out FILE] [--quick]

For each frame it stages one blob once per eligible engine ("search" K3
or "grouped" K5, the layout's own, and "direct" K4 where the per-slot
table fits shared memory), checks that every engine decodes the input
exactly, and times the prepared decode with CUDA events (min of 5 after
a warm-up); each engine is timed in the instance its wrapper picks (the
stream staged in a shared-memory ring where it fits beside the tables)
and, as "<engine>/global", forced onto global loads.  Frames:

  * the codecs' own, at full width (n = 2^25, S = 4096): AnsByte on the
    vbyte split stream of zipf20 (M <= 4096, <= 256 symbols), ANSfold-2
    on the main path's input (M = 2^15), ANSfold-7 on zipf20 (M = 2^17,
    grouped: the per-slot table does not fit, which the script reports);
  * synthetic frames over a (sigma, M) grid, Zipf(1) frequencies, values
    drawn from the frame's own distribution (n = 2^23), at S = 4096 and
    S = 32, including frequency-grouped frames small enough for K4 and
    one (sigma 5500, M = 2^16) whose per-slot tables leave K4's ring no
    room, so that K4 on global loads meets K3 with its ring.

Prints one line per (frame, engine) with the card's name and power limit,
then one JSON object; --out also writes it to FILE.  Fails without a CUDA
card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .inputs import bench_input, zipf20_input
from .models import ans, bytes as byte_models, engine, framing
from .ops import decode, lane_codec, tables

RUNS = 5
DEVICE = "cuda"


def cuda_ms(fn, runs: int = RUNS) -> float:
    fn()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def zipf_frame(sigma: int, log2m: int) -> np.ndarray:
    """sigma live symbols with Zipf(1) frequencies summing to 2^log2m."""
    M = 1 << log2m
    w = 1.0 / np.arange(1, sigma + 1)
    nf = 1 + np.floor((M - sigma) * w / w.sum()).astype(np.int64)
    nf[0] += M - int(nf.sum())
    return nf.astype(np.uint64)


def time_engines(label: str, table, payload, states, n: int, S: int,
                 sec_len, want: torch.Tensor) -> dict:
    """Decode under every eligible engine, check, and time."""
    T = lane_codec.lane_steps(n, S)
    sigma, M = tables._frame_of(table)
    rec = {"frame": label, "n": n, "S": S, "sigma": sigma, "M": M,
           "direct_table_bytes": tables.direct_table_bytes(table),
           "eligible": list(engine.eligible_engines(table)),
           "chosen": engine.choose_decode_engine(table, S), "ms": {}}
    for name in rec["eligible"]:
        pd = engine.PreparedDecoder(payload, states, table, n, S=S, T=T,
                                    sec_len=sec_len, device=DEVICE,
                                    engine=name)
        counts = decode.instance_launches[f"decode_{name}"]
        before = dict(counts)
        got = pd().reshape(-1)[:n]
        if not torch.equal(got, want):
            raise RuntimeError(f"{label}: engine {name} decodes wrongly")
        rec["ms"][name] = cuda_ms(pd)
        rec.setdefault("instance", {})[name] = (
            "ring" if counts["ring"] > before["ring"] else "global")
        # once more on the staged tensors, forced onto global loads
        kernel = {"search": decode.decode_search,
                  "grouped": decode.decode_grouped,
                  "direct": decode.decode_direct}[name]

        def forced():
            return kernel(pd.stream, pd.states[0], pd.table, n, T,
                          instance="global")

        if not torch.equal(forced().reshape(-1)[:n], want):
            raise RuntimeError(f"{label}: engine {name} on global loads "
                               f"decodes wrongly")
        rec["ms"][f"{name}/global"] = cuda_ms(forced)
        del pd
    return rec


def codec_frame(label: str, codec, blob: bytes, n: int,
                want: torch.Tensor) -> dict:
    table, off = codec._dec_table(blob)
    S, states, payload, _, sec_len = framing.parse(blob, off)
    return time_engines(label, table, payload, states, n, S, sec_len, want)


def synthetic_frame(sigma: int, log2m: int, n: int, S: int) -> dict:
    nf = zipf_frame(sigma, log2m)
    rng = np.random.default_rng(sigma * 64 + log2m)
    cum = np.cumsum(nf) / float(nf.sum())
    x = np.minimum(np.searchsorted(cum, rng.random(n), side="right"),
                   sigma - 1).astype(np.int32)
    xt = torch.from_numpy(x).to(DEVICE)
    zero = torch.zeros_like(xt)
    enc, staged = ans._stage(xt, zero, zero, n, nf, True, S)
    blob = engine.encode(*staged, n, enc)
    _, states, payload, _, sec_len = framing.parse(blob, 0)
    return time_engines(f"synthetic sigma={sigma} M=2^{log2m}",
                        tables.build_dec_table(nf), payload, states, n, S,
                        sec_len, xt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--quick", action="store_true",
                    help="n = 2^20 everywhere: a check, not a measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_crossover: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    full_n = 1 << (20 if args.quick else 25)
    syn_n = 1 << (20 if args.quick else 23)
    recs = []

    def emit(rec):
        recs.append(rec)
        times = ", ".join(f"{k} {v:.3f} ms" for k, v in rec["ms"].items())
        why = ("" if "direct" in rec["eligible"] else
               f"; direct not eligible ({rec['direct_table_bytes']} bytes of "
               f"tables > {tables.DIRECT_TABLE_BYTES})")
        print(f"{card} {rec['frame']} n={rec['n']} S={rec['S']} "
              f"sigma={rec['sigma']} M={rec['M']}: {times}; rule picks "
              f"{rec['chosen']}{why}", flush=True)

    def as_tensor(x):
        return torch.from_numpy(x.view(np.int32)).to(DEVICE)

    z20 = zipf20_input(full_n)
    split = byte_models.Vbyte(device=DEVICE).split(as_tensor(z20))
    ab = byte_models.AnsByte(device=DEVICE)
    emit(codec_frame("AnsByte on vbyte(zipf20)", ab, ab.encode_tensor(split),
                     split.numel(), split.to(torch.int32)))
    del split
    for label, codec, x in (
            ("ANSfold-2 on the main path's input",
             ans.AnsFold(2, lanes=4096, device=DEVICE), bench_input(full_n)),
            ("ANSfold-7 on zipf20",
             ans.AnsFold(7, lanes=4096, device=DEVICE), z20)):
        emit(codec_frame(label, codec, codec.encode(x), len(x),
                         as_tensor(x)))
    del z20

    grid = [(16, 8), (16, 12), (256, 10), (256, 12), (256, 16), (1546, 15),
            (2048, 12), (2048, 16), (5500, 16), (8192, 14), (8192, 16),
            (9000, 14), (10000, 15), (12000, 14)]
    for sigma, log2m in grid:
        emit(synthetic_frame(sigma, log2m, syn_n, 4096))
    for sigma, log2m in ((256, 12), (1546, 15), (9000, 14)):
        emit(synthetic_frame(sigma, log2m, syn_n >> 3, 32))

    result = {"card": smi, "runs": RUNS, "frames": recs}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
