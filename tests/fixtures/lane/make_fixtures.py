"""Write the golden lane-format fixtures with the JAX reference package.

    JAX_PLATFORMS=cpu python tests/fixtures/lane/make_fixtures.py \
        [--full-width] [--grouped-full-width] [--bytes-full-width]
        [--msb-full-width] [--blocked-full-width] [--pseudo-full-width]
        [--full-width-input FILE --numpy VERSION [--kind KIND]]

Writes, next to this file:
  * *.u32                     inputs (little-endian u32), made from fixed
                              seeds;
  * *.lane                    ans_tpu lane-engine blobs of those inputs:
                              ANSfold-1/2/4, ANSmsb, ANSrfold-2 (the
                              reorder taken), and the large-alphabet routes
                              (ANS with the tail escape onto the pivot
                              search, ANS and ANSfold-7 on the grouped
                              layout, ANSsint-80);
  * manifest.json             for each blob: input, method, lanes, n, sha256
                              and its frame;
  * *.atfb, blocked.json      ans_tpu BlockCodec containers (ATFB, its
                              portable engine on a CPU mesh) and their
                              record: method, sections, lanes, n, sha256;
  * fullwidth.json            (--full-width) the record of the full-width
                              case of bench.py: ANSfold-2 on zipf(1.25),
                              n = 2^25, seed 42, S = 4096, honest frame;
  * fullwidth_zipf20.json     (--grouped-full-width) the records of the
                              grouped path at full width, S = 4096:
                              ANSfold-7 and ANS on zipf20 (Zipf(1) over
                              2^20 values, n = 2^25, seed 0) and ANS on
                              dense22 (n = 2^22, an alphabet of 2^16 the
                              tail escape declines);
  * fullwidth_bytes.json      (--bytes-full-width) the records of the byte
                              path at full width on zipf20 (n = 2^25):
                              the vbyte and streamvbyte split streams and
                              the vbyteANS and streamvbyteANS blobs
                              (default lane count of the split stream);
                              (--msb-full-width) ANSmsb and ANSrfold-2 on
                              zipf20, into fullwidth_zipf20.json;
  * fullwidth_blocked.json    (--blocked-full-width) BlockCodec containers
                              of ANSfold-2 and ANSfold-7 on zipf20 in
                              D = 32 sections of S = 4096 lanes, written by
                              the portable engine on a CPU mesh of 32
                              devices (every section stays under the 3 MB
                              section cap, so the production engine writes
                              the same bytes);
  * *.atfp, pseudo.json       ans_tpu PseudoAdaptive containers (ATFP) of
                              the small inputs, lane and compat engines,
                              and their record: block size, kind, lanes,
                              engine, n, sha256;
  * fullwidth_pseudo.json     (--pseudo-full-width) PseudoAdaptive
                              containers at the default block size 2^17
                              and lane count (S = 32): int and msb on
                              zipf20, int on zipf125 (Zipf(1.25) over
                              2^28 values less one, n = 2^25, seed 42).

numpy's zipf sampler is not stable across numpy releases (2.0.2 and 2.3.5
draw different values from one seed), so the full-width records keep one
entry per input stream.  --full-width / --grouped-full-width add the
streams of the numpy running the script; --full-width-input FILE --numpy
VERSION --kind KIND adds the stream another numpy drew of input KIND
(bench, zipf20 or dense22), read from FILE (lzma-compressed little-endian
u32, e.g. `lzma.compress(make_data().tobytes())` on that machine).

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

# the blocked containers' CPU mesh: as many virtual devices as sections
# (read once, when JAX is first imported)
BLOCKED_D = 32
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        f"{_flags} --xla_force_host_platform_device_count={BLOCKED_D}"
    ).strip()

# (blob file, input file, method, lanes; None = the default lane count)
BLOBS = (
    ("zipf20k.fold2.s32.lane", "zipf20k.u32", "ANSfold-2", 32),
    ("zipf20k.fold2.s128.lane", "zipf20k.u32", "ANSfold-2", 128),
    ("zipf20k.fold2.s4096.lane", "zipf20k.u32", "ANSfold-2", 4096),
    ("zipf20k.fold1.lane", "zipf20k.u32", "ANSfold-1", None),
    ("zipf20k.fold4.lane", "zipf20k.u32", "ANSfold-4", None),
    ("wide5k.fold2.lane", "wide5k.u32", "ANSfold-2", None),
    ("twice16k.ans.lane", "twice16k.u32", "ANS", None),
    ("dense48k.ans.lane", "dense48k.u32", "ANS", 256),
    ("dense48k.sint80.lane", "dense48k.u32", "ANSsint-80", None),
    ("zipf60k.fold7.lane", "zipf60k.u32", "ANSfold-7", None),
    ("zipf20k.msb.lane", "zipf20k.u32", "ANSmsb", None),
    ("zipf60k.rfold2.lane", "zipf60k.u32", "ANSrfold-2", None),
)

# (container file, input file, method, sections, lanes)
CONTAINERS = (
    ("zipf20k.fold2.d2.atfb", "zipf20k.u32", "ANSfold-2", 2, None),
)

# (container file, input file, block size, kind, lanes, engine)
PSEUDO = (
    ("zipf20k.pa.int.compat.atfp", "zipf20k.u32", 4096, "int", None,
     "auto"),
    ("zipf20k.pa.msb.lane.atfp", "zipf20k.u32", 4096, "msb", 32, "lane"),
    ("zipf60k.pa.int.lane.atfp", "zipf60k.u32", 1 << 16, "int", None,
     "auto"),
)

FULL_N, FULL_SEED, FULL_LANES = 1 << 25, 42, 4096
DENSE_N = 1 << 22


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


def twice16k() -> np.ndarray:
    """Each value of 0..2^14-1 twice, shuffled: ANS takes the tail escape
    (K = 1024, one exception byte) onto the pivot search."""
    rng = np.random.default_rng(6)
    return rng.permutation(np.repeat(np.arange(1 << 14), 2)).astype(np.uint32)


def dense48k() -> np.ndarray:
    """Every value of 0..11999 (the even ones twice) and 30000 Zipf(1.5)
    draws over the same range: ANS stays on the grouped layout (the tail
    escape declines), ANSsint-80 takes the escape."""
    from ans_tpu.utils.zipf import zipf
    head = np.concatenate([np.arange(12000), np.arange(0, 12000, 2)])
    tail = zipf(np.random.default_rng(5), 30000, 12000, 1.5) - 1
    return np.concatenate([head, tail]).astype(np.uint32)


def zipf60k() -> np.ndarray:
    """60000 Zipf(1) draws over 2^20 values: ANSfold-7 maps them to ~11k
    live symbols, a grouped frame."""
    from ans_tpu.utils.zipf import zipf
    return zipf(np.random.default_rng(3), 60000, 1 << 20)


def zipf20_input() -> np.ndarray:
    """tools/bench_grouped.py's zipf20 at n = 2^25."""
    from ans_tpu.utils.zipf import zipf
    return zipf(np.random.default_rng(0), FULL_N, 1 << 20)


def dense22_input() -> np.ndarray:
    """n = 2^22: every value of 0..2^16-1 (the even ones twice) tiled over
    n/2 values, then n/2 Zipf(1.5) draws over the same range (seed 8).
    The tail frequencies alternate 1/2, so the tail escape declines and
    ANS codes a 2^16-symbol grouped frame."""
    from ans_tpu.utils.zipf import zipf
    n = DENSE_N
    head = np.concatenate([np.arange(1 << 16), np.arange(0, 1 << 16, 2)])
    head = np.tile(head, -(-(n // 2) // len(head)))[: n // 2]
    tail = zipf(np.random.default_rng(8), n - n // 2, 1 << 16, 1.5) - 1
    return np.concatenate([head.astype(np.uint32), tail])


def zipf125_input() -> np.ndarray:
    """n = 2^25 Zipf(1.25) draws over 2^28 values less one (seed 42),
    drawn by rejection-inversion, the same under numpy 2.0.2 and 2.3.5."""
    from ans_tpu.utils.zipf import zipf
    return zipf(np.random.default_rng(FULL_SEED), FULL_N, 1 << 28,
                1.25) - 1


def full_width_input() -> np.ndarray:
    """bench.py make_data(): zipf(1.25) over n = 2^25 values, seed 42."""
    rng = np.random.default_rng(FULL_SEED)
    return (rng.zipf(1.25, size=FULL_N) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def lane_record(codec, blob: bytes) -> dict:
    """Frame, live alphabet, slot layout and section cut of a lane blob
    (sigma counts the prelude's live symbols, before any tail escape)."""
    from ans_tpu.models import framing
    from ans_tpu.reference_model.model import load_prelude
    # rfold's reorder header stands in front of the prelude
    reorder = getattr(codec, "name", "").startswith("ANSrfold-")
    skip = 0
    if reorder and int.from_bytes(blob[:4], "little") == 1:
        from ans_tpu.constants import fold_threshold
        skip = 4 * fold_threshold(codec.fidelity)
    nfreqs, _ = load_prelude(blob[4 + skip:] if reorder else blob)
    dt, off = codec._dec_table(blob)
    S, _, payload, t_sec, sec_len = framing.parse(blob, off)
    return {"M": int(nfreqs.sum()), "sigma": int(np.count_nonzero(nfreqs)),
            "grouped": dt.layout is not None, "lanes": S,
            "t_sec": int(t_sec), "sections": len(sec_len),
            "stream_len": len(payload)}


def codec_of(method: str, lanes=None):
    """ans_tpu's lane codec `method` with `lanes` lanes."""
    from ans_tpu.models import ans
    kind, _, arg = method.partition("-")
    if kind == "ANSfold":
        return ans.AnsFold(int(arg), lanes=lanes)
    if kind == "ANSsint":
        return ans.AnsSint(int(arg), lanes=lanes)
    if kind == "ANSrfold":
        return ans.AnsReorderFold(int(arg), lanes=lanes)
    if method == "ANS":
        return ans.AnsInt(lanes=lanes)
    if method == "ANSmsb":
        return ans.AnsMsb(lanes=lanes)
    raise ValueError(f"no fixture codec for {method!r}")


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
    ap.add_argument("--kind", default="bench", choices=sorted(KINDS),
                    help="which input --full-width-input holds")
    ap.add_argument("--grouped-full-width", action="store_true",
                    help="add this numpy's zipf20 and dense22 streams to "
                         "fullwidth_zipf20.json")
    ap.add_argument("--bytes-full-width", action="store_true",
                    help="add this numpy's zipf20 stream under vbyte, "
                         "streamvbyte, vbyteANS and streamvbyteANS to "
                         "fullwidth_bytes.json")
    ap.add_argument("--msb-full-width", action="store_true",
                    help="add this numpy's zipf20 stream under ANSmsb and "
                         "ANSrfold-2 to fullwidth_zipf20.json")
    ap.add_argument("--blocked-full-width", action="store_true",
                    help="add this numpy's zipf20 stream's BlockCodec "
                         "containers (ANSfold-2, ANSfold-7; D = 32) to "
                         "fullwidth_blocked.json")
    ap.add_argument("--pseudo-full-width", action="store_true",
                    help="add this numpy's zipf20 and zipf125 streams' "
                         "PseudoAdaptive containers (int and msb on zipf20, "
                         "int on zipf125) to fullwidth_pseudo.json")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    inputs = {"zipf20k.u32": zipf20k(), "wide5k.u32": wide5k(),
              "twice16k.u32": twice16k(), "dense48k.u32": dense48k(),
              "zipf60k.u32": zipf60k()}
    for name, x in inputs.items():
        x.astype("<u4").tofile(HERE / name)
    manifest = []
    for blob_name, inp, method, lanes in BLOBS:
        x = inputs[inp]
        codec = codec_of(method, lanes)
        blob = codec.encode(x)
        (HERE / blob_name).write_bytes(blob)
        manifest.append({"blob": blob_name, "input": inp,
                         "method": method, "lanes": lanes,
                         "n": len(x), "sha256": sha256(blob),
                         **lane_record(codec, blob)})
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    containers = []
    for blob_name, inp, method, D, lanes in CONTAINERS:
        x = inputs[inp]
        blob = blocked_codec(method, D, lanes).encode(x)
        (HERE / blob_name).write_bytes(blob)
        containers.append({"blob": blob_name, "input": inp,
                           "method": method, "sections": D, "lanes": lanes,
                           "n": len(x), "sha256": sha256(blob),
                           **container_record(blob)})
    (HERE / "blocked.json").write_text(json.dumps(containers, indent=1)
                                       + "\n")

    pseudo = []
    for blob_name, inp, bs, kind, lanes, engine in PSEUDO:
        from ans_tpu.models.pseudo_adaptive import PseudoAdaptive
        x = inputs[inp]
        blob = PseudoAdaptive(bs, kind, lanes, engine).encode(x)
        (HERE / blob_name).write_bytes(blob)
        pseudo.append({"blob": blob_name, "input": inp, "block_size": bs,
                       "kind": kind, "lanes": lanes, "engine": engine,
                       "n": len(x), "sha256": sha256(blob)})
    (HERE / "pseudo.json").write_text(json.dumps(pseudo, indent=1) + "\n")

    if args.full_width:
        add_full_width("bench", full_width_input(), np.__version__)
    if args.grouped_full_width:
        add_full_width("zipf20", zipf20_input(), np.__version__)
        add_full_width("dense22", dense22_input(), np.__version__)
    if args.bytes_full_width:
        add_bytes_full_width(zipf20_input(), np.__version__)
    if args.msb_full_width:
        add_full_width("zipf20", zipf20_input(), np.__version__,
                       ("ANSmsb", "ANSrfold-2"))
    if args.blocked_full_width:
        add_blocked_full_width(zipf20_input(), np.__version__)
    if args.pseudo_full_width:
        add_pseudo_full_width({"zipf20": zipf20_input(),
                               "zipf125": zipf125_input()}, np.__version__)
    if args.full_width_input:
        import lzma
        raw = lzma.decompress(Path(args.full_width_input).read_bytes())
        add_full_width(args.kind,
                       np.frombuffer(raw, dtype="<u4").astype(np.uint32),
                       args.numpy)


# input kind -> (record file, its header, the methods recorded, n)
KINDS = {
    "bench": ("fullwidth.json", {
        "generator": "bench.py make_data(): np.random.default_rng(42)"
                     ".zipf(1.25, 2**25) - 1, clipped to 2**28 - 1",
        "method": "ANSfold-2", "n": FULL_N, "seed": FULL_SEED,
        "lanes": FULL_LANES, "max_frame": None}, ("ANSfold-2",), FULL_N),
    "zipf20": ("fullwidth_zipf20.json", None,
               ("ANSfold-7", "ANS", "ANSmsb", "ANSrfold-2"), FULL_N),
    "dense22": ("fullwidth_zipf20.json", None, ("ANS",), DENSE_N),
}

ZIPF20_HEADER = {
    "generators": {
        "zipf20": "ans_tpu.utils.zipf.zipf(np.random.default_rng(0), "
                  "2**25, 2**20)",
        "dense22": "n = 2**22: np.arange(2**16) then np.arange(0, 2**16, "
                   "2), tiled to n/2 values, then ans_tpu.utils.zipf.zipf("
                   "np.random.default_rng(8), n/2, 2**16, 1.5) - 1"},
    "lanes": FULL_LANES, "max_frame": None}


def add_full_width(kind: str, x: np.ndarray, numpy_version: str,
                   methods=None) -> None:
    """Encode one full-width input stream with each of its methods (or
    `methods`) and merge the entries into the kind's record file (keyed by
    the input's sha256 and the method)."""
    fname, header, kind_methods, n = KINDS[kind]
    methods = methods or kind_methods
    if len(x) != n:
        raise ValueError(f"{kind} input has {len(x)} values, not {n}")
    path = HERE / fname
    rec = (json.loads(path.read_text()) if path.exists()
           else {**(header or ZIPF20_HEADER), "inputs": []})
    input_sha = sha256(x.tobytes())
    for method in methods:
        codec = codec_of(method, FULL_LANES)
        blob = codec.encode(x)
        entry = {"numpy": numpy_version, "input_sha256": input_sha,
                 "blob_len": len(blob), "blob_sha256": sha256(blob),
                 **lane_record(codec, blob)}
        if kind == "dense22":
            # the cell exists to run ANS on the grouped layout: the tail
            # escape must decline it
            from ans_tpu.ops.escape import plan_from_freqs
            from ans_tpu.reference_model.model import load_prelude
            assert plan_from_freqs(load_prelude(blob)[0]) is None
            assert entry["grouped"]
        if header is None:
            entry = {"input": kind, "method": method, **entry}
        rec["inputs"] = [e for e in rec["inputs"]
                         if (e["input_sha256"], e.get("method", method))
                         != (input_sha, method)]
        rec["inputs"].append(entry)
    path.write_text(json.dumps(rec, indent=1) + "\n")


def blocked_codec(method: str, D: int, lanes=None):
    """ans_tpu's BlockCodec of `method` over a CPU mesh of D devices, on
    its portable engine."""
    from ans_tpu.parallel import BlockCodec, make_mesh
    return BlockCodec(method, make_mesh(D), lanes=lanes, engine="xla")


def container_record(blob: bytes) -> dict:
    """Each section's lane count, cut and stream length in an ATFB
    container (its header as parallel.block_runtime writes it)."""
    import struct
    from ans_tpu.models import framing
    from ans_tpu.parallel.block_runtime import describe_container
    method, _, D = describe_container(blob)
    pos = 16
    if method.startswith("ANSrfold-"):
        from ans_tpu.constants import fold_threshold
        flag = int.from_bytes(blob[pos:pos + 4], "little")
        pos += 4 + (4 * fold_threshold(int(method.split("-")[1]))
                    if flag == 1 else 0)
    (plen,) = struct.unpack_from("<I", blob, pos)
    pos += 4 + plen
    secs = []
    for _ in range(D):
        (slen,) = struct.unpack_from("<I", blob, pos)
        S, _, payload, t_sec, sec_len = framing.parse(
            blob[pos + 4:pos + 4 + slen], 0)
        secs.append((S, int(t_sec), len(sec_len), len(payload)))
        pos += 4 + slen
    return {"lanes_of_sections": sorted({s[0] for s in secs}),
            "t_sec": [s[1] for s in secs],
            "cuts": [s[2] for s in secs],
            "stream_lens": [s[3] for s in secs]}


BLOCKED_METHODS = ("ANSfold-2", "ANSfold-7")


def add_blocked_full_width(x: np.ndarray, numpy_version: str) -> None:
    """The containers of zipf20 in BLOCKED_D sections of FULL_LANES lanes
    under BLOCKED_METHODS, merged into fullwidth_blocked.json (keyed as
    add_full_width keys them)."""
    path = HERE / "fullwidth_blocked.json"
    rec = (json.loads(path.read_text()) if path.exists() else {
        "generators": {"zipf20": ZIPF20_HEADER["generators"]["zipf20"]},
        "sections": BLOCKED_D, "lanes": FULL_LANES,
        "engine": "ans_tpu BlockCodec(engine='xla') on a CPU mesh of "
                  f"{BLOCKED_D} devices", "inputs": []})
    input_sha = sha256(x.tobytes())
    for method in BLOCKED_METHODS:
        blob = blocked_codec(method, BLOCKED_D, FULL_LANES).encode(x)
        entry = {"input": "zipf20", "method": method,
                 "numpy": numpy_version, "input_sha256": input_sha,
                 "blob_len": len(blob), "blob_sha256": sha256(blob),
                 **container_record(blob)}
        rec["inputs"] = [e for e in rec["inputs"]
                         if (e["input_sha256"], e["method"])
                         != (input_sha, method)]
        rec["inputs"].append(entry)
    path.write_text(json.dumps(rec, indent=1) + "\n")


# (input, kind) of the full-width ATFP records
PSEUDO_CELLS = (("zipf20", "int"), ("zipf20", "msb"), ("zipf125", "int"))


def add_pseudo_full_width(xs: dict, numpy_version: str) -> None:
    """The PseudoAdaptive containers of PSEUDO_CELLS at the default block
    size and lane count, merged into fullwidth_pseudo.json (keyed by the
    input's sha256 and the kind)."""
    import struct
    from ans_tpu.models.pseudo_adaptive import PseudoAdaptive
    path = HERE / "fullwidth_pseudo.json"
    rec = (json.loads(path.read_text()) if path.exists() else {
        "generators": {
            "zipf20": ZIPF20_HEADER["generators"]["zipf20"],
            "zipf125": "ans_tpu.utils.zipf.zipf(np.random.default_rng(42), "
                       "2**25, 2**28, 1.25) - 1"},
        "block_size": 1 << 17, "lanes": None, "engine": "auto",
        "inputs": []})
    for name, kind in PSEUDO_CELLS:
        x = xs[name]
        input_sha = sha256(x.tobytes())
        blob = PseudoAdaptive(kind=kind).encode(x)
        blocks = struct.unpack_from("<IBBBBII", blob)
        entry = {"input": name, "kind": kind, "numpy": numpy_version,
                 "input_sha256": input_sha, "blob_len": len(blob),
                 "blob_sha256": sha256(blob), "n": int(blocks[5]),
                 "block_size": int(blocks[6])}
        rec["inputs"] = [e for e in rec["inputs"]
                         if (e["input_sha256"], e["kind"])
                         != (input_sha, kind)]
        rec["inputs"].append(entry)
        path.write_text(json.dumps(rec, indent=1) + "\n")


BYTE_METHODS = ("vbyte", "streamvbyte", "vbyteANS", "streamvbyteANS")

BYTES_HEADER = {
    "generators": {"zipf20": ZIPF20_HEADER["generators"]["zipf20"]},
    "lanes": None, "note": "vbyte / streamvbyte blobs are the split "
    "streams; the composites are a u32 count of split bytes, then the "
    "AnsByte blob at the default lane count of the split stream"}


def add_bytes_full_width(x: np.ndarray, numpy_version: str) -> None:
    """Encode zipf20 with the four byte-path methods of ans_tpu's registry
    and merge the entries into fullwidth_bytes.json (keyed as
    add_full_width keys them).  The composites' entries also record the
    AnsByte frame behind the 4-byte count."""
    from ans_tpu import models
    from ans_tpu.models import framing
    from ans_tpu.reference_model.rans_compat import byte_prelude_decode
    path = HERE / "fullwidth_bytes.json"
    rec = (json.loads(path.read_text()) if path.exists()
           else {**BYTES_HEADER, "inputs": []})
    input_sha = sha256(x.tobytes())
    for method in BYTE_METHODS:
        blob = models.get(method).encode(x)
        entry = {"input": "zipf20", "method": method, "numpy": numpy_version,
                 "input_sha256": input_sha, "blob_len": len(blob),
                 "blob_sha256": sha256(blob)}
        if method.endswith("ANS"):
            nfreqs, off = byte_prelude_decode(blob[4:])
            S, _, payload, t_sec, sec_len = framing.parse(blob[4:], off)
            entry.update(split_len=int.from_bytes(blob[:4], "little"),
                         M=int(nfreqs.sum()),
                         sigma=int(np.count_nonzero(nfreqs)), lanes=S,
                         t_sec=int(t_sec), sections=len(sec_len),
                         stream_len=len(payload))
        rec["inputs"] = [e for e in rec["inputs"]
                         if (e["input_sha256"], e["method"])
                         != (input_sha, method)]
        rec["inputs"].append(entry)
    path.write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
