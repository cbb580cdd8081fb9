"""Real-data preparation: byte- or word-parse text, BWT, MTF ranks.

reference: src/generate_bwtmtf.cpp — parse (:68-109), suffix sort +
BWT (:149-158), MTF (:164-174); outputs .u32 rank streams.
"""

from __future__ import annotations

import numpy as np

from ..utils import bwt as bwt_mod, io, timing
from . import _cli


def parse_bytes(text: bytes) -> np.ndarray:
    return np.frombuffer(text, dtype=np.uint8).astype(np.uint32)


def parse_words(text: bytes) -> np.ndarray:
    """Word ids in first-occurrence order (generate_bwtmtf.cpp:82-109)."""
    words = text.decode("utf-8", errors="replace").split()
    ids = {}
    out = np.empty(len(words), dtype=np.uint32)
    for i, w in enumerate(words):
        out[i] = ids.setdefault(w, len(ids))
    return out


def bwtmtf(seq: np.ndarray) -> np.ndarray:
    with timing.timer("bwt"):
        transformed, _ = bwt_mod.bwt(seq)
    with timing.timer("mtf"):
        return bwt_mod.mtf(transformed)


def main(argv=None):
    p = _cli.make_parser("BWT+MTF data prep", output_arg=True)
    p.add_argument("-w", "--words", action="store_true",
                   help="word-parse instead of byte-parse")
    args = p.parse_args(argv)
    raw = open(args.input, "rb").read()
    seq = parse_words(raw) if args.words else parse_bytes(raw)
    ranks = bwtmtf(seq)
    io.write_file_u32(args.output, ranks)
    print(f"wrote {len(ranks)} ranks to {args.output}")


if __name__ == "__main__":
    main()
