"""Paper Figure 13: BPI vs block size for block-based ANS.

reference: src/pseudo_adaptive.cpp:225-236 — block sizes 128 * 2^i,
i = 0..20, methods ANSint and ANSmsb; output name;method;block_size;bpi.
Unlike the reference (encode-only), each configuration is round-trip
verified.
"""

from __future__ import annotations

import numpy as np

from ..models.pseudo_adaptive import PseudoAdaptive
from . import _cli


def run(inputs, max_i: int = 20, verify: bool = True,
        lanes: int | None = None, kinds=("int", "msb"), device="cuda"):
    """lanes: pin the per-block lane count (ans_tpu pins it to bound its
    XLA compile space, one scan per (S, T, log2m) triple; the port's
    kernels take any S, so here it only picks the lane format); device:
    where the blocks are coded."""
    rows = []
    for name, values in inputs:
        for kind in kinds:
            for i in range(max_i + 1):
                bs = 128 * (1 << i)
                if bs > 4 * len(values):
                    break
                codec = PseudoAdaptive(bs, kind, lanes=lanes, device=device)
                blob = codec.encode(values)
                if verify:
                    np.testing.assert_array_equal(
                        codec.decode(blob, len(values)), values)
                bpi = 8.0 * len(blob) / len(values)
                print(f"{name};ANS{kind};{bs};{bpi:.4f}", flush=True)
                rows.append((name, kind, bs, bpi))
    return rows


def main(argv=None):
    p = _cli.make_parser("block-based ANS sweep", device_arg=True)
    p.add_argument("--max-i", type=int, default=20)
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--lanes", type=int, default=None)
    p.add_argument("--kinds", default="int,msb", help="comma list")
    args = p.parse_args(argv)
    from .. import runtime
    runtime.enable_compilation_cache()
    run(_cli.load_inputs(args), args.max_i, not args.no_verify,
        lanes=args.lanes, kinds=tuple(args.kinds.split(",")),
        device=args.device)


if __name__ == "__main__":
    main()
