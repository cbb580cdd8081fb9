"""End-to-end time of the pseudo-adaptive container (ATFP) on one GPU, and
the host's share of it: the model build that the host library
(ans_tpu_torch/native) takes over.

    python3 -m ans_tpu_torch.bench_host [--cells zipf20-int,zipf20-msb,
        zipf125-int] [--n N] [--device cuda] [--out FILE]

Each cell is an input of ans_tpu_torch/inputs.py (n = 2^25 by default)
and a kind.  PseudoAdaptive(kind) at its defaults (blocks of 2^17, a
model each) codes it as its encode() and decode() do: prepare_encoder
(every block's model build and staging), one call, the bytes; then
prepare_decoder (every block's prelude and tables), one call, the values
on the host.  Host clock, the device synchronised before each reading;
the kernels and the host library are built, and a small cell run, before
any clock.
Prints the card's name and power limit, then for each cell the e2e encode
and decode seconds, the staging seconds in them and per block, and the
container's sha256 against tests/fixtures/lane/fullwidth_pseudo.json;
then one JSON line.  The file also runs in a tree without the host
library, copied into it: to compare the two, run both trees in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CELLS = {"zipf20-int": ("zipf20", "int"), "zipf20-msb": ("zipf20", "msb"),
         "zipf125-int": ("zipf125", "int")}
RECORDS = (Path(__file__).resolve().parent.parent / "tests" / "fixtures"
           / "lane" / "fullwidth_pseudo.json")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def record_sha(x: np.ndarray, kind: str) -> str | None:
    """The recorded container sha256 for this input and kind, if any."""
    sha = hashlib.sha256(x.tobytes()).hexdigest()
    for e in json.loads(RECORDS.read_text())["inputs"]:
        if e["kind"] == kind and e["input_sha256"] == sha:
            return e["blob_sha256"]
    return None


def warm_up(x: np.ndarray, kind: str, device: str) -> None:
    """Build the kernels (and the host library, in a tree that has it) and
    run one small cell, so that no clock below counts a build."""
    if torch.device(device).type == "cuda":
        from .csrc import build
        build.load_all()
    try:
        from . import native
    except ImportError:  # a tree without the host library
        pass
    else:
        native.lib()
    run_cell(x[:1 << 18], kind, device)


def run_cell(x: np.ndarray, kind: str, device: str) -> dict:
    from .models.pseudo_adaptive import PseudoAdaptive
    codec = PseudoAdaptive(kind=kind, device=device)
    cuda = torch.device(device).type == "cuda"

    def now() -> float:
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = now()
    pe = codec.prepare_encoder(x)
    t1 = now()
    blob = pe.to_bytes(pe())
    t2 = now()
    pd = codec.prepare_decoder(blob)
    t3 = now()
    out = pd.to_host(pd())
    t4 = now()
    blocks = -(-len(x) // codec.block_size)
    sha = hashlib.sha256(blob).hexdigest()
    return {"n": len(x), "blocks": blocks, "bytes": len(blob),
            "e2e_encode_s": t2 - t0, "stage_encode_s": t1 - t0,
            "stage_encode_s_per_block": (t1 - t0) / blocks,
            "e2e_decode_s": t4 - t2, "stage_decode_s": t3 - t2,
            "stage_decode_s_per_block": (t3 - t2) / blocks,
            "sha256": sha, "exact": bool(np.array_equal(out, x)),
            "matches_record": sha == record_sha(x, kind)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    from . import inputs
    card = card_line() if torch.device(args.device).type == "cuda" else \
        args.device
    print(card)
    res, data = {}, {}
    for cell in args.cells.split(","):
        name, kind = CELLS[cell]
        if name not in data:
            data[name] = getattr(inputs, f"{name}_input")(args.n)
        if not res:
            warm_up(data[name], kind, args.device)
        r = res[cell] = run_cell(data[name], kind, args.device)
        print(f"[{card}] {cell}: e2e "
              f"encode {r['e2e_encode_s']:.3f} s (staging "
              f"{r['stage_encode_s']:.3f} s, "
              f"{r['stage_encode_s_per_block']:.4f} s a block of "
              f"{r['blocks']}), decode {r['e2e_decode_s']:.3f} s (staging "
              f"{r['stage_decode_s']:.3f} s, "
              f"{r['stage_decode_s_per_block']:.4f} s a block); "
              f"{r['bytes']} bytes, sha256 {r['sha256'][:12]}, record "
              f"{'matched' if r['matches_record'] else 'NOT matched'}, "
              f"decode {'exact' if r['exact'] else 'NOT exact'}", flush=True)
    line = json.dumps({"card": card, "cells": res})
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if all(r["exact"] for r in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
