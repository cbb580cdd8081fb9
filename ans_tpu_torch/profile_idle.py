"""Device idle share of the prepared encoder and decoder on one GPU.

    python3 -m ans_tpu_torch.profile_idle [--method ANSfold-2]
        [--input bench|zipf20|zipf125] [--n N] [--lanes S] [--seed 42]
        [--sections D] [--calls 5] [--trace DIR]

Stages an input (bench.py's zipf(1.25), or zipf20 for the grouped path;
ans_tpu_torch/inputs.py; n = 2^25 values by default) with
`models.prepare_encoder` / `models.prepare_decoder` (ANSfold-2 by
default) on cuda, then runs each `--calls` times under torch.profiler.
`--sections D` stages the blocked container instead
(`parallel.BlockCodec(method, D)`: its prepared encoder and decoder, one
launch a kernel for all D sections).  `--method pseudo_adaptive-int`
or `pseudo_adaptive-msb` stages the pseudo-adaptive container at its
defaults (models/pseudo_adaptive.py: blocks of 2^17, their default lane
count, a model each; one launch a kernel a batch of blocks; `--lanes`
does not apply).  `--method vbyte` or `streamvbyte`
runs the splitter's wrappers instead
(ops/bytesplit.py: K7, then K9 or K8) on the input on the card.  Each call is
one `record_function` span that ends with `torch.cuda.synchronize()`,
so the span's length is the call's wall time.  Its busy time is the
union of the device intervals (kernels, copies, memsets) inside the
span, so device work that overlaps is counted once.  The idle share is
1 - busy / wall over all calls.  The host's time in a span splits into
the outermost torch operations and CUDA API calls (by name) and the rest
(Python between them).  Prints the card's name and power limit, each
call kind's wall, busy and idle share, the device time per operation
name and the host's split (per call), then one JSON line with the same
numbers.
`--trace DIR` keeps the Chrome traces.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def outermost(events):
    """The host events that no other of `events` contains (one thread)."""
    out, reach = [], float("-inf")
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= reach:
            out.append(e)
            reach = e["ts"] + e["dur"]
    return out


def idle_share(events, label: str) -> dict:
    """Wall, busy and per-operation device time (us, summed over the
    spans named `label`) from Chrome trace events, and the host's time:
    inside the outermost torch operations and CUDA API calls, by name,
    and outside them (Python between the calls)."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == label]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    wall = busy = in_calls = 0.0
    ops, host_ops = defaultdict(float), defaultdict(float)
    for w0, w1 in spans:
        inside = [e for e in device
                  if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
        busy += union_length((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                             for e in inside)
        wall += w1 - w0
        for e in inside:
            ops[e["name"]] += e["dur"]
        for e in outermost([e for e in host if w0 <= e["ts"]
                            and e["ts"] + e["dur"] <= w1]):
            in_calls += e["dur"]
            host_ops[e["name"]] += e["dur"]
    if not spans or not busy:
        raise RuntimeError(f"the trace holds no device work for {label}")
    k = len(spans)
    return {"calls": k, "wall_us": wall / k, "busy_us": busy / k,
            "idle_share": 1.0 - busy / wall,
            "ops_us": {name: t / k for name, t in
                       sorted(ops.items(), key=lambda kv: -kv[1])},
            "host_us": {"in_calls": in_calls / k,
                        "outside_calls": (wall - in_calls) / k,
                        "calls": {name: t / k for name, t in sorted(
                            host_ops.items(), key=lambda kv: -kv[1])}}}


def profile(fns: dict, calls: int, trace_dir: Path) -> dict:
    """Run each fn `calls` times in its own span under the profiler."""
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for fn in fns.values():  # warm-up: builds, caches, allocator
        fn()
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for label, fn in fns.items():
            for _ in range(calls):
                with record_function(label):
                    fn()
                    torch.cuda.synchronize()
    path = trace_dir / "profile_idle.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {label: idle_share(events, label) for label in fns}


def split_calls(method: str, x: np.ndarray) -> dict:
    """The splitter's encode and decode on the card (K7, then K9 for vbyte
    or K8 for streamvbyte), the round trip checked."""
    from .ops import bytesplit
    xt = torch.from_numpy(x.view(np.int32)).to("cuda")
    if method == "vbyte":
        stream = bytesplit.vbyte_encode(xt)
        calls = {"split_encode": lambda: bytesplit.vbyte_encode(xt),
                 "split_decode": lambda: bytesplit.vbyte_decode(
                     stream, len(x))}
    else:
        ctrl, data = bytesplit.svb_encode(xt)
        calls = {"split_encode": lambda: bytesplit.svb_encode(xt),
                 "split_decode": lambda: bytesplit.svb_decode(
                     ctrl, data, len(x))}
    if not torch.equal(calls["split_decode"](), xt):
        raise RuntimeError(f"{method}: the split does not round-trip")
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="ANSfold-2")
    ap.add_argument("--input", choices=("bench", "zipf20", "zipf125"),
                    default="bench")
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the bench input")
    ap.add_argument("--sections", type=int, default=None,
                    help="stage the blocked container of D sections")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--trace", type=Path, default=None,
                    help="directory to keep the Chrome trace in")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_idle: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from . import models
    from .inputs import bench_input, zipf20_input, zipf125_input

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    x = {"bench": lambda: bench_input(args.n, args.seed),
         "zipf20": lambda: zipf20_input(args.n),
         "zipf125": lambda: zipf125_input(args.n)}[args.input]()
    if args.method in ("vbyte", "streamvbyte"):
        fns, engine = split_calls(args.method, x), None
    elif args.method.startswith("pseudo_adaptive-"):
        from .models.pseudo_adaptive import PseudoAdaptive
        pa = PseudoAdaptive(kind=args.method.split("-")[1], device="cuda")
        pe = pa.prepare_encoder(x)
        pd = pa.prepare_decoder(pe.to_bytes(pe()))
        if not np.array_equal(pd.to_host(pd()), x):
            print("profile_idle: the pseudo-adaptive decoder does not "
                  "return the input", file=sys.stderr)
            return 1
        fns = {"prepared_encode": pe, "prepared_decode": pd}
        engine = ",".join(sorted(set(pd.engines)))
    elif args.sections:
        from .parallel import BlockCodec
        bc = BlockCodec(args.method, args.sections, args.lanes,
                        device="cuda")
        pe = bc.prepare_encoder(x)
        pd = bc.prepare_decoder(pe.to_bytes(*pe()))
        if not np.array_equal(pd.to_host(pd()), x):
            print("profile_idle: the blocked decoder does not return the "
                  "input", file=sys.stderr)
            return 1
        fns, engine = {"prepared_encode": pe, "prepared_decode": pd}, pd.engine
    else:
        pe = models.prepare_encoder(args.method, x, lanes=args.lanes,
                                    device="cuda")
        blob = pe.prelude + pe.to_bytes(*pe())
        pd = models.prepare_decoder(args.method, blob, args.n, device="cuda")
        if not np.array_equal(pd.to_host(pd()), x):
            print("profile_idle: the prepared decoder does not return the "
                  "input", file=sys.stderr)
            return 1
        fns, engine = {"prepared_encode": pe, "prepared_decode": pd}, pd.engine
    if args.trace is None:
        with tempfile.TemporaryDirectory() as d:
            res = profile(fns, args.calls, Path(d))
    else:
        args.trace.mkdir(parents=True, exist_ok=True)
        res = profile(fns, args.calls, args.trace)
    for label, r in res.items():
        where = f", D={args.sections}" if args.sections else ""
        print(f"[{card}] {args.method} on {args.input}, {label} "
              f"(n={args.n}, S={args.lanes}{where}, engine {engine}): wall "
              f"{r['wall_us']:.1f} us, busy {r['busy_us']:.1f} us per call, "
              f"idle share {r['idle_share']:.4f} over {r['calls']} calls")
        for name, us in r["ops_us"].items():
            print(f"    {us:10.1f} us  {name[:100]}")
        h = r["host_us"]
        print(f"  host: {h['in_calls']:.1f} us in torch operations and "
              f"CUDA calls, {h['outside_calls']:.1f} us outside them")
        for name, us in list(h["calls"].items())[:12]:
            print(f"    {us:10.1f} us  {name[:100]}")
    print(json.dumps({"card": card, "method": args.method,
                      "input": args.input, "engine": engine, "n": args.n,
                      "lanes": args.lanes, "sections": args.sections,
                      **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
