"""File CLI over the port's codec registry (the self-describing ATFC
container), with ans_tpu's verbs and flags:

    python -m ans_tpu_torch compress   in.u32 out.atfc [-m ANSfold-2]
                                       [--engine lane|compat] [-t]
                                       [--blocked [-D N]] [-S LANES]
                                       [--device cuda]
    python -m ans_tpu_torch decompress in.atfc out.u32 [--device cuda]
    python -m ans_tpu_torch info       in.atfc
    python -m ans_tpu_torch methods

Input .u32 files are little-endian u32 streams; -t parses
whitespace-separated text integers instead.  The lane codecs run on
`--device`, the GPU unless the CPU is asked for (`--device cpu` runs
each kernel's plain version); the compat engine codes on the host.
`--blocked` writes the ATFB container in D sections (-D), one batch of
streams a kernel launch; `decompress` and `info` tell ATFB from ATFC by
its magic.  `-S` (not in ans_tpu's CLI) sets the lanes of a lane stream
or section; without it the codec picks its default lane count, as
ans_tpu's CLI does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import container, models


def _read_values(path: str, text: bool) -> np.ndarray:
    if text:
        with open(path) as f:
            return np.array(f.read().split(), dtype=np.uint32)
    return np.fromfile(path, dtype="<u4")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ans_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="u32 file -> ATFC container")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("-m", "--method", default="ANSfold-2")
    c.add_argument("--engine", default="lane",
                   choices=("lane", "compat"))
    c.add_argument("-t", "--text", action="store_true",
                   help="parse whitespace-separated text integers")
    c.add_argument("--blocked", action="store_true",
                   help="ATFB container: D sections under one model, "
                        "decoded as one batch of streams (ANS-family "
                        "methods)")
    c.add_argument("-D", "--devices", type=int, default=1,
                   help="section count for --blocked (default 1).  In "
                        "ans_tpu -D is the mesh size, one section a "
                        "device; here the D sections run on one GPU, and "
                        "the container's bytes are the same")
    c.add_argument("-S", "--lanes", type=int, default=None,
                   help="lanes of a lane stream, or of a section with "
                        "--blocked (default: the codec's default lane "
                        "count of the input or section)")

    d = sub.add_parser("decompress", help="ATFC container -> u32 file")
    d.add_argument("infile")
    d.add_argument("outfile")

    for p in (c, d):
        p.add_argument("--device", default="cuda",
                       help="torch device of the lane codecs (default "
                            "cuda; cpu runs each kernel's plain version)")

    i = sub.add_parser("info", help="print container metadata")
    i.add_argument("infile")

    sub.add_parser("methods", help="list registry methods")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "methods":
        for name in models.available():
            print(name)
        return 0
    from .parallel import block_runtime as br
    if args.cmd == "compress":
        values = _read_values(args.infile, args.text)
        if values.size == 0:
            sys.exit("empty input")
        if args.blocked:
            bc = br.BlockCodec(args.method, args.devices, args.lanes,
                               device=args.device)
            out = bc.encode(values)
            desc = f"{args.method}, blocked D={args.devices}"
        else:
            out = container.compress(values, args.method, args.engine,
                                     device=args.device, lanes=args.lanes)
            desc = f"{args.method}, {args.engine}"
        with open(args.outfile, "wb") as f:
            f.write(out)
        print(f"{values.size} ints -> {len(out)} bytes "
              f"({8 * len(out) / values.size:.4f} bpi, {desc})")
        return 0
    with open(args.infile, "rb") as f:
        buf = f.read()
    blocked = (len(buf) >= 4
               and int.from_bytes(buf[:4], "little") == br.MAGIC)
    if args.cmd == "info":
        if blocked:
            method, n, D = br.describe_container(buf)
            print(f"method={method} container=ATFB n={n} D={D} "
                  f"({8 * len(buf) / max(n, 1):.4f} bpi)")
        else:
            method, engine, n, blob = container.unpack(buf)
            print(f"method={method} engine={engine} n={n} "
                  f"payload={len(blob)} bytes "
                  f"({8 * len(blob) / max(n, 1):.4f} bpi)")
        return 0
    if blocked:
        method, n, D = br.describe_container(buf)
        values = br.BlockCodec(method, D, device=args.device).decode(buf)
    else:
        values = container.decompress(buf, device=args.device)
    values = np.ascontiguousarray(values, dtype=np.uint32)
    values.astype("<u4").tofile(args.outfile)
    print(f"{len(buf)} bytes -> {values.size} ints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
