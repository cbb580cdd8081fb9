"""Prelude statistics per input: max symbol, prelude vs stream bytes,
and the model-build vs stream-coding TIME split.

reference: src/prelude.cpp (the only driver that defines RECORD_STATS)
prints max_sym per file; here the prelude/stream byte split is always
available from the blob structure, and the codecs report their time
split through the stats singleton (utils/stats.py, the P7 counterpart
of the reference's RECORD_STATS build, stats.hpp:20-41).
"""

from __future__ import annotations

from ..reference_model.model import load_prelude
from ..utils.stats import recording
from .. import models
from . import _cli


def run(values, name: str, engine: str = "lane", methods=None,
        device="cuda"):
    max_sym = int(values.max())
    print(f"processing {name}")
    print(f"\tmax_sym = {max_sym}")
    for method in methods or ("ANS", "ANSmsb", "ANSfold-2"):
        codec = models.get(method, engine=engine, device=device)
        with recording() as st:
            blob = codec.encode(values)
        if st.prelude_bytes or st.encode_bytes:
            # codec-reported split (covers non-ANS preludes too)
            plen = st.prelude_bytes
        else:
            _, plen = load_prelude(blob)
        total = len(blob)
        print(f"\t{method}: prelude_bytes={plen} stream_bytes={total - plen} "
              f"prelude_bpi={8 * plen / len(values):.4f} "
              f"total_bpi={8 * total / len(values):.4f} "
              f"prelude_ns={st.prelude_time_ns} "
              f"encode_ns={st.encode_time_ns}")


def main(argv=None):
    p = _cli.make_parser("prelude statistics", methods_arg=True)
    args = p.parse_args(argv)
    methods = tuple(args.methods.split(",")) if args.methods else None
    for name, values in _cli.load_inputs(args):
        run(values, name, getattr(args, "engine", "lane"), methods,
            args.device)


if __name__ == "__main__":
    main()
