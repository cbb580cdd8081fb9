"""Write the golden lane-format fixtures with the JAX reference package.

    JAX_PLATFORMS=cpu python tests/fixtures/lane/make_fixtures.py \
        [--full-width] [--full-width-input FILE --numpy VERSION]

Writes, next to this file:
  * zipf20k.u32, wide5k.u32   inputs (little-endian u32), made from fixed
                              seeds;
  * *.lane                    ans_tpu lane-engine blobs of those inputs;
  * manifest.json             for each blob: input, method, lanes, n, sha256;
  * fullwidth.json            (--full-width) the record of the full-width
                              case of bench.py: ANSfold-2 on zipf(1.25),
                              n = 2^25, seed 42, S = 4096, honest frame.

numpy's zipf sampler is not stable across numpy releases (2.0.2 and 2.3.5
draw different values from one seed), so fullwidth.json keeps one entry
per input stream.  --full-width adds the stream of the numpy running the
script; --full-width-input FILE --numpy VERSION adds the stream another
numpy drew, read from FILE (lzma-compressed little-endian u32, e.g.
`lzma.compress(make_data().tobytes())` on that machine).

Every ans_tpu_torch build must encode each input to the same bytes and
decode each blob back to its input (tests/test_torch_slice.py on the
CPU, chip_smoke.py on the GPU).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

# (blob file, input file, fidelity, lanes; None = the default lane count)
BLOBS = (
    ("zipf20k.fold2.s32.lane", "zipf20k.u32", 2, 32),
    ("zipf20k.fold2.s128.lane", "zipf20k.u32", 2, 128),
    ("zipf20k.fold2.s4096.lane", "zipf20k.u32", 2, 4096),
    ("zipf20k.fold1.lane", "zipf20k.u32", 1, None),
    ("zipf20k.fold4.lane", "zipf20k.u32", 4, None),
    ("wide5k.fold2.lane", "wide5k.u32", 2, None),
)

FULL_N, FULL_SEED, FULL_LANES = 1 << 25, 42, 4096


def zipf20k() -> np.ndarray:
    rng = np.random.default_rng(2024)
    return (rng.zipf(1.25, size=20000) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def wide5k() -> np.ndarray:
    """Small zipf values mixed with values >= 2^24 (up to 3 exception
    bytes under ANSfold-2) and the edge values 0, 2^31, 2^32-1."""
    rng = np.random.default_rng(2025)
    small = (rng.zipf(1.4, size=5000) - 1).clip(0, 1 << 20)
    big = rng.integers(1 << 24, 1 << 32, size=5000, dtype=np.uint64)
    x = np.where(rng.random(5000) < 0.3, big, small).astype(np.uint32)
    x[:3] = (0, 1 << 31, (1 << 32) - 1)
    return x


def full_width_input() -> np.ndarray:
    """bench.py make_data(): zipf(1.25) over n = 2^25 values, seed 42."""
    rng = np.random.default_rng(FULL_SEED)
    return (rng.zipf(1.25, size=FULL_N) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def lane_record(blob: bytes) -> dict:
    """Frame, live alphabet and section cut of an ANSfold lane blob."""
    from ans_tpu.models import framing
    from ans_tpu.reference_model.model import load_prelude
    nfreqs, plen = load_prelude(blob)
    S, _, payload, t_sec, sec_len = framing.parse(blob, plen)
    return {"M": int(nfreqs.sum()), "sigma": int(np.count_nonzero(nfreqs)),
            "lanes": S, "t_sec": int(t_sec), "sections": len(sec_len),
            "stream_len": len(payload)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-width", action="store_true",
                    help="add this numpy's full-width input stream to "
                         "fullwidth.json (n = 2^25)")
    ap.add_argument("--full-width-input", metavar="FILE",
                    help="add the full-width input stream in FILE "
                         "(lzma-compressed little-endian u32)")
    ap.add_argument("--numpy", default="unknown",
                    help="numpy version that drew --full-width-input")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ans_tpu.models.ans import AnsFold

    inputs = {"zipf20k.u32": zipf20k(), "wide5k.u32": wide5k()}
    for name, x in inputs.items():
        x.astype("<u4").tofile(HERE / name)
    manifest = []
    for blob_name, inp, f, lanes in BLOBS:
        x = inputs[inp]
        blob = AnsFold(f, lanes=lanes).encode(x)
        (HERE / blob_name).write_bytes(blob)
        manifest.append({"blob": blob_name, "input": inp,
                         "method": f"ANSfold-{f}", "lanes": lanes,
                         "n": len(x), "sha256": sha256(blob),
                         **lane_record(blob)})
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")

    if args.full_width:
        add_full_width(full_width_input(), np.__version__)
    if args.full_width_input:
        import lzma
        raw = lzma.decompress(Path(args.full_width_input).read_bytes())
        add_full_width(np.frombuffer(raw, dtype="<u4").astype(np.uint32),
                       args.numpy)


def add_full_width(x: np.ndarray, numpy_version: str) -> None:
    """Encode one full-width input stream and merge its entry into
    fullwidth.json (keyed by the input's sha256)."""
    from ans_tpu.models.ans import AnsFold
    if len(x) != FULL_N:
        raise ValueError(f"full-width input has {len(x)} values")
    path = HERE / "fullwidth.json"
    rec = (json.loads(path.read_text()) if path.exists() else
           {"generator": "bench.py make_data(): np.random.default_rng(42)"
                         ".zipf(1.25, 2**25) - 1, clipped to 2**28 - 1",
            "method": "ANSfold-2", "n": FULL_N, "seed": FULL_SEED,
            "lanes": FULL_LANES, "max_frame": None, "inputs": []})
    blob = AnsFold(2, lanes=FULL_LANES, max_frame=None).encode(x)
    entry = {"numpy": numpy_version, "input_sha256": sha256(x.tobytes()),
             "blob_len": len(blob), "blob_sha256": sha256(blob),
             **lane_record(blob)}
    rec["inputs"] = [e for e in rec["inputs"]
                     if e["input_sha256"] != entry["input_sha256"]]
    rec["inputs"].append(entry)
    path.write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
