"""Paper Figure 11: BPI vs fold fidelity (encode-only).

reference: src/fold_effectiveness.cpp:132-148 — ANSfold and ANSrfold at
f = 1..8 per dataset.
"""

from __future__ import annotations

from .. import models
from . import _cli


def run(inputs, engine="lane", methods=None, device="cuda"):
    names = [f"{fam}-{f}" for fam in ("ANSfold", "ANSrfold")
             for f in range(1, 9)]
    if methods:
        names = [n for n in names if n in methods]
    rows = []
    for input_name, values in inputs:
        for name in names:
            fam, f = name.rsplit("-", 1)
            codec = models.get(name, engine=engine, device=device)
            blob = codec.encode(values)
            bpi = 8.0 * len(blob) / len(values)
            print(f"{input_name};{fam};{f};{bpi:.4f}", flush=True)
            rows.append((input_name, fam, int(f), bpi))
    return rows


def main(argv=None):
    p = _cli.make_parser("BPI vs fold fidelity", methods_arg=True)
    args = p.parse_args(argv)
    methods = set(args.methods.split(",")) if args.methods else None
    run(_cli.load_inputs(args), getattr(args, "engine", "lane"), methods,
        args.device)


if __name__ == "__main__":
    main()
