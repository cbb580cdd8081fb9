"""Shared CLI scaffolding for the experiment drivers.

Uniform flags mirror the reference's Boost program_options setup
(reference: src/table_efficiency.cpp:34-62): -i/--input <dir|file>,
-t/--text, -o/--output, -n/--num; plus ans_tpu extras --engine and
--methods, and the port's --device (the torch device the codecs run on,
default cuda; "cpu" runs each kernel's plain version).
"""

from __future__ import annotations

import argparse

from .. import models
from ..utils import io


def make_parser(desc: str, *, input_arg=True, output_arg=False,
                num_arg=False, methods_arg=False,
                device_arg=False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    if input_arg:
        p.add_argument("-i", "--input", required=True,
                       help="input directory or file")
        p.add_argument("-t", "--text", action="store_true",
                       help="inputs are .txt (one integer per line)")
    if output_arg:
        p.add_argument("-o", "--output", required=True,
                       help="output directory")
    if num_arg:
        p.add_argument("-n", "--num", type=int, default=1_000_000,
                       help="number of integers to generate")
    if methods_arg:
        p.add_argument("--methods", default=None,
                       help="comma-separated method subset")
        p.add_argument("--engine", default="lane",
                       choices=("lane", "compat"),
                       help="wire format / engine (default: lane)")
    if methods_arg or device_arg:
        p.add_argument("--device", default="cuda",
                       help="torch device of the codecs (default: cuda)")
    return p


def load_inputs(args):
    """[(short_name, values), ...] for the -i argument."""
    files = io.collect_inputs(args.input, getattr(args, "text", False))
    out = []
    for f in files:
        name = f.rsplit("/", 1)[-1]
        name = name[: name.rfind(".")] if "." in name else name
        out.append((name, io.read_input(f)))
    return out


def select_methods(args, default_list):
    names = (args.methods.split(",") if getattr(args, "methods", None)
             else default_list)
    engine = getattr(args, "engine", "lane")
    device = getattr(args, "device", "cuda")
    out = []
    for n in names:
        try:
            out.append((n, models.get(n, engine=engine, device=device)))
        except KeyError:
            try:
                out.append((n, models.get(n, engine="compat",
                                          device=device)))
            except KeyError:
                print(f"% skipping unknown method {n}")
    return out
