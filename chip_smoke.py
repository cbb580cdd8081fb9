#!/usr/bin/env python3
"""Smoke test of ans_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, at full
width, and checks them against the reference's bytes: the main path,
ANSfold-2 on zipf(1.25) data at n = 2^25 with S = 4096 lanes (the
headline of bench.py), and the frequency-grouped path, ANSfold-7 on
zipf-2^20 data (n = 2^25, S = 4096), with ANS on the same input (tail
escape onto the pivot search) and on a 2^16-symbol input the escape
declines (n = 2^22); the inputs are ans_tpu_torch/inputs.py's:

  0. device: the card's name and power limit;
  1. build: nvcc compiles the five kernels from ans_tpu_torch/csrc, all at
     once;
  2. kernels: each kernel's wrapper on the card against its plain PyTorch
     version on the same inputs (n = 2^20, S in {32, 4096}: K1-K3 on
     ANSfold-2, K5/K6 on ANSfold-7 (in-kernel symbol -> rank map, high/nb
     table), on ANS without the escape (ranks, value table) and on a frame
     whose ranks are its values; then K1-K3 on the main path's arrays);
     all integer, so the tolerance is zero.  Kernel and plain times at the
     full-width shapes (CUDA events, min of 5 for the kernels, 2 for the
     plain versions);
  3. golden fixtures (tests/fixtures/lane, written by ans_tpu): encode
     equals the blob byte for byte, decode equals the input;
  4. the main path at full width: the input's sha256 and the blob's length
     and sha256 equal tests/fixtures/lane/fullwidth.json; decode is exact;
     the prepared encoder/decoder write and read the same bytes; K1-K3 were
     launched by this phase;
  5. the grouped path at full width (records in fullwidth_zipf20.json):
     ANSfold-7 as phase 4, with the prepared decoder on the "grouped"
     engine and K6, K2, K5 launched by this phase;
  6. ANS on the same input: as phase 4, the escape taking it onto the
     "search" engine (K1-K3 launched by this phase);
  7. ANS on the escape-declining input: as phase 5 on the "grouped"
     engine (K6 fed ranks, K5 with a value table).
  Phases 5-7 then hold their kernels against the plain versions at their
  own shapes and time both (min of 5 and of 2).

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}.  Any failure exits non-zero and prints
no result; so does a machine without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LANE_FIXTURES = ROOT / "tests" / "fixtures" / "lane"
FULL_N, FULL_SEED, FULL_LANES = 1 << 25, 42, 4096
DENSE_N = 1 << 22
RUNS, PLAIN_RUNS = 5, 2
DEVICE = "cuda"

# kernel name -> (source, TPU kernel it replaces, its wrapper's counter)
KERNELS = {
    "encode_scan": ("ans_tpu_torch/csrc/encode_scan.cu",
                    "ans_tpu/ops/pallas_encode.py:101", "encode.launches"),
    "encode_scan_grouped": ("ans_tpu_torch/csrc/encode_scan_grouped.cu",
                            "ans_tpu/ops/pallas_encode.py:137",
                            "encode.grouped_launches"),
    "place": ("ans_tpu_torch/csrc/place.cu",
              "ans_tpu/ops/pallas_place.py:141", "place.launches"),
    "decode_search": ("ans_tpu_torch/csrc/decode_search.cu",
                      "ans_tpu/ops/pallas_decode.py:377", "decode.launches"),
    "decode_grouped": ("ans_tpu_torch/csrc/decode_grouped.cu",
                       "ans_tpu/ops/pallas_decode.py:852",
                       "decode.grouped_launches"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Min over `runs` of one call's time between CUDA events (after a
    warm-up call)."""
    fn()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def max_abs_err(a, b) -> int:
    require(a.shape == b.shape, f"shapes differ: {a.shape} vs {b.shape}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class Stage:
    """One input staged for the kernels on the card through a codec's own
    mapping and tables: the scan's table and (T, S) inputs as encode()
    builds them, the decode table as decode() builds it from the
    prelude's frequencies."""

    def __init__(self, codec, values: np.ndarray, lanes: int):
        from ans_tpu_torch.models.ans import _stage
        from ans_tpu_torch.ops import lane_codec, tables
        mapped, k, low, pfreqs, ffreqs, raw = codec._enc_inputs(values)
        self.n = len(values)
        self.S = lanes
        self.T = lane_codec.lane_steps(self.n, lanes)
        self.enc, (self.mapped, self.nb, self.excw) = _stage(
            mapped, k, low, self.n, ffreqs, raw, lanes)
        self.dec = tables.to_device(codec._table(pfreqs), DEVICE)


class IdentityStage(Stage):
    """A grouped frame whose ranks are its values (frequencies falling
    with the value over 2^14 symbols, M = 2^17): K6 fed ranks, K5 with no
    table."""

    def __init__(self, n: int, lanes: int):
        from ans_tpu_torch.models.ans import _stage_ts
        from ans_tpu_torch.ops import grouped, lane_codec, tables
        v = np.arange(1 << 14)
        nf = (1 + (v < 1 << 13) + 2 * (v < 1 << 11) + 5 * (v < 64)).astype(
            np.uint64)
        nf[0] += (1 << 17) - int(nf.sum())
        x = np.random.default_rng(5).choice(len(nf), size=n,
                                            p=nf / nf.sum())
        xt = torch.from_numpy(x.astype(np.int32)).to(DEVICE)
        zero = torch.zeros_like(xt)
        self.n, self.S = n, lanes
        self.T = lane_codec.lane_steps(n, lanes)
        self.enc = tables.grouped_enc_to_device(
            grouped.build_group_layout(nf), DEVICE, rank_of=False)
        self.mapped, self.nb, self.excw = _stage_ts(xt, zero, zero, n, lanes,
                                                    self.T)
        self.dec = tables.to_device(tables.build_grouped_table(nf), DEVICE)
        require(self.dec.table.numel() == 0, "the identity frame has a table")


def ptxas_report(log: str):
    """(kernel instance, resource line) pairs of an `nvcc -Xptxas -v`
    log: each instance's stack frame and spills, then its registers."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # mangled: <length><name>, then ILi<n>E for a template int
            # and Lb<0|1>E for a template bool
            k = re.search(
                r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E(?:Lb(\d)E)?)?",
                m.group(1))
            args = [a for a in (k.group(2), k.group(3)) if a] if k else []
            fn = (k.group(1) + (f"<{','.join(args)}>" if args else "")
                  if k else m.group(1))
        elif "registers" in line or "spill" in line:
            yield fn, line.replace("ptxas info    :", "").strip()


def check_kernels(st: Stage, timed: bool, plain_runs: int = RUNS) -> dict:
    """The scan (K1 or K6), K2 and the decode (K3 or K5) of st against
    their plain versions; returns per-kernel max_abs_err (and ms /
    plain_ms when timed: CUDA events, min of RUNS for a kernel and of
    plain_runs for a plain version)."""
    from ans_tpu_torch.ops import decode, encode, lane_codec, place, tables
    grouped = isinstance(st.enc, tables.GroupedEncDevice)
    if grouped:
        scan = ("encode_scan_grouped", encode.encode_scan_grouped,
                lane_codec.encode_scan_grouped_plain)
        dec = ("decode_grouped", decode.decode_grouped,
               lane_codec.decode_grouped_plain)
    else:
        scan = ("encode_scan", encode.encode_scan,
                lane_codec.encode_scan_plain)
        dec = ("decode_search", decode.decode_search,
               lane_codec.decode_search_plain)
    res = {}
    sargs = (st.mapped, st.n, st.enc)
    packed, states = scan[1](*sargs)
    packed_p, states_p = scan[2](*sargs)
    torch.cuda.synchronize()
    err = max(max_abs_err(packed, packed_p),
              max_abs_err(states, states_p))
    require(err == 0, f"{scan[0]} differs from its plain version at "
                      f"S={st.S} (max abs err {err})")
    res[scan[0]] = {"max_abs_err": err}

    round_base, total = lane_codec.encode_totals(packed, st.nb, st.n)
    total = int(total)
    args = (packed, st.nb, st.excw, st.n, round_base, total)
    stream = place.place(*args)
    stream_p = lane_codec.place_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(stream, stream_p)
    require(err == 0, f"place differs from its plain version at S={st.S}")
    res["place"] = {"max_abs_err": err}

    dargs = (stream, states, st.dec, st.n, st.T)
    out = dec[1](*dargs)
    out_p = dec[2](*dargs)
    torch.cuda.synchronize()
    err = max_abs_err(out, out_p)
    require(err == 0, f"{dec[0]} differs from its plain version at "
                      f"S={st.S} (max abs err {err})")
    res[dec[0]] = {"max_abs_err": err}

    if timed:
        pairs = {scan[0]: (lambda: scan[1](*sargs), lambda: scan[2](*sargs)),
                 "place": (lambda: place.place(*args),
                           lambda: lane_codec.place_plain(*args)),
                 dec[0]: (lambda: dec[1](*dargs), lambda: dec[2](*dargs))}
        for name, (kern, plain) in pairs.items():
            res[name]["ms"] = cuda_ms(kern)
            res[name]["plain_ms"] = cuda_ms(plain, plain_runs)
    return res


def merge_errs(total: dict, res: dict) -> None:
    for name, r in res.items():
        total[name] = max(total.get(name, 0), r["max_abs_err"])


def print_timed(card: str, where: str, res: dict) -> None:
    for name, r in res.items():
        print(f"{card} {name} at the shapes of {where}, S=4096: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, max_abs_err "
              f"{r['max_abs_err']}")


def check_fixtures() -> int:
    from ans_tpu_torch import models
    manifest = json.loads((LANE_FIXTURES / "manifest.json").read_text())
    for rec in manifest:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        require(sha256(blob) == rec["sha256"], f"{rec['blob']} changed")
        codec = models.get(rec["method"], lanes=rec["lanes"], device=DEVICE)
        require(codec.encode(x) == blob,
                f"encode of {rec['input']} differs from {rec['blob']}")
        require(np.array_equal(codec.decode(blob, len(x)), x),
                f"decode of {rec['blob']} differs from {rec['input']}")
    return len(manifest)


def find_record(path: Path, method: str, x: np.ndarray) -> dict:
    """The entry of a full-width record file for (method, this input
    stream); fails naming the drift when this machine drew another
    stream."""
    input_sha = sha256(x.tobytes())
    recs = [e for e in json.loads(path.read_text())["inputs"]
            if e.get("method", method) == method
            and e["input_sha256"] == input_sha]
    require(len(recs) == 1,
            f"{method}: the input (numpy {np.__version__}, sha256 "
            f"{input_sha[:12]}) is not in {path.name}: numpy's RNG drifted; "
            f"add it with tests/fixtures/lane/make_fixtures.py "
            f"--full-width-input")
    return recs[0]


def reset_launches() -> None:
    from ans_tpu_torch.ops import decode, encode, place
    for mod in (encode, place, decode):
        for attr in ("launches", "grouped_launches"):
            if hasattr(mod, attr):
                setattr(mod, attr, 0)


def read_launches() -> dict:
    from ans_tpu_torch.ops import decode, encode, place
    mods = {"encode": encode, "place": place, "decode": decode}
    out = {}
    for name, (_, _, counter) in KERNELS.items():
        mod, attr = counter.split(".")
        out[name] = getattr(mods[mod], attr)
    return out


SEARCH_PATH = ("encode_scan", "place", "decode_search")
GROUPED_PATH = ("encode_scan_grouped", "place", "decode_grouped")


def run_codec(card: str, name: str, x: np.ndarray, rec: dict,
              engine: str, prepared: bool = False) -> dict:
    """encode/decode of `name` on x through the user's entry points: the
    blob equals the record, decode is exact, the prepared decoder takes
    `engine` and every kernel of that engine's path (SEARCH_PATH or
    GROUPED_PATH) was launched by this run; with `prepared`, the prepared
    encoder reproduces the bytes and both prepared calls are timed.
    Returns the launches of this run and its numbers."""
    from ans_tpu_torch import models
    n = len(x)
    reset_launches()
    codec = models.get(name, lanes=FULL_LANES, device=DEVICE)
    t0 = time.perf_counter()
    blob = codec.encode(x)
    e2e_enc = time.perf_counter() - t0
    require(len(blob) == rec["blob_len"] and sha256(blob)
            == rec["blob_sha256"],
            f"{name}: blob differs from the record: {len(blob)} bytes")
    t0 = time.perf_counter()
    out = codec.decode(blob, n)
    e2e_dec = time.perf_counter() - t0
    require(np.array_equal(out, x), f"{name}: decode is not exact")
    pd = models.prepare_decoder(name, blob, n, device=DEVICE)
    require(pd.engine == engine,
            f"{name}: prepared decoder engine {pd.engine}, not {engine}")
    r = {"blob": blob, "e2e_enc": e2e_enc, "e2e_dec": e2e_dec}
    if prepared:
        pe = models.prepare_encoder(name, x, lanes=FULL_LANES, device=DEVICE)
        require(pe.prelude + pe.to_bytes(*pe()) == blob,
                f"{name}: prepared encoder bytes differ from encode()")
        require(np.array_equal(pd.to_host(pd()), x),
                f"{name}: prepared decoder output differs from the input")
        r["enc_ms"] = cuda_ms(pe)
        r["dec_ms"] = cuda_ms(pd)
    torch.cuda.synchronize()
    r["launches"] = read_launches()
    for kernel in SEARCH_PATH if engine == "search" else GROUPED_PATH:
        require(r["launches"][kernel] > 0,
                f"{name} on the {engine} engine never launched {kernel}")
    print(f"{card} {name}: {len(blob)} bytes, {8 * len(blob) / n:.4f} bpi, "
          f"sha256 {sha256(blob)[:12]}, engine {pd.engine}; e2e (host "
          f"clock, host data) encode {e2e_enc:.3f} s, decode "
          f"{e2e_dec:.3f} s")
    if prepared:
        print(f"{card} {name}: prepared encode "
              f"{n / r['enc_ms'] / 1e3:.1f}M ints/s ({r['enc_ms']:.3f} ms), "
              f"prepared decode {n / r['dec_ms'] / 1e3:.1f}M ints/s "
              f"({r['dec_ms']:.3f} ms)")
    return r


def main() -> int:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from ans_tpu_torch.csrc import build
    from ans_tpu_torch.inputs import bench_input, dense_input, zipf20_input
    from ans_tpu_torch.models.ans import AnsFold, AnsInt

    # 0. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")

    # 1. build
    t0 = time.perf_counter()
    build.load_all(tuple(KERNELS))
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(KERNELS)} "
          f"kernels in parallel ({build.NVCC_FLAGS[0]})")
    for name, log in build.build_log.items():
        for fn, line in ptxas_report(log):
            print(f"  {name}: {fn}: {line}")

    # 2. kernels against their plain versions
    errs = {}
    z20 = zipf20_input(1 << 20)
    for lanes in (32, 4096):
        for what, st in (
                ("ANSfold-2", lambda: Stage(AnsFold(2, device=DEVICE),
                                            bench_input(1 << 20, 7), lanes)),
                ("ANSfold-7", lambda: Stage(AnsFold(7, device=DEVICE), z20,
                                            lanes)),
                ("ANS (no escape)", lambda: Stage(AnsInt(device=DEVICE),
                                                  dense_input(1 << 20),
                                                  lanes)),
                ("identity frame", lambda: IdentityStage(1 << 20, lanes))):
            res = check_kernels(st(), timed=False)
            merge_errs(errs, res)
            print(f"kernels == plain, {what} at n=2^20, S={lanes}: "
                  + ", ".join(f"{k} max_abs_err {v['max_abs_err']}"
                              for k, v in res.items()))
    full = bench_input(FULL_N, FULL_SEED)
    rec = find_record(LANE_FIXTURES / "fullwidth.json", "ANSfold-2", full)
    kres = check_kernels(Stage(AnsFold(2, device=DEVICE), full, FULL_LANES),
                         timed=True)
    merge_errs(errs, kres)
    print_timed(card, "the main path, n=2^25", kres)
    torch.cuda.synchronize()

    # 3. golden fixtures
    print(f"golden fixtures: {check_fixtures()} blobs re-encoded and "
          f"decoded exactly")
    torch.cuda.synchronize()

    # 4. the main path at full width, through the user's entry points
    main_run = run_codec(card, "ANSfold-2", full, rec, "search",
                         prepared=True)
    plain_enc = kres["encode_scan"]["plain_ms"] + kres["place"]["plain_ms"]
    plain_dec = kres["decode_search"]["plain_ms"]
    print(f"{card} plain versions: encode scan + place "
          f"{FULL_N / plain_enc / 1e3:.1f}M ints/s, decode "
          f"{FULL_N / plain_dec / 1e3:.1f}M ints/s")
    del full

    # 5. the grouped path at full width: ANSfold-7 on zipf20
    z20 = zipf20_input(FULL_N)
    zrec = LANE_FIXTURES / "fullwidth_zipf20.json"
    grouped_run = run_codec(card, "ANSfold-7", z20,
                            find_record(zrec, "ANSfold-7", z20), "grouped",
                            prepared=True)
    gres = check_kernels(Stage(AnsFold(7, device=DEVICE), z20, FULL_LANES),
                         timed=True, plain_runs=PLAIN_RUNS)
    merge_errs(errs, gres)
    print_timed(card, "ANSfold-7, zipf20, n=2^25", gres)

    # 6. ANS on zipf20: the tail escape onto the pivot search (depth 13,
    # NR = 3, one exception round)
    run_codec(card, "ANS", z20, find_record(zrec, "ANS", z20), "search",
              prepared=True)
    ares = check_kernels(Stage(AnsInt(device=DEVICE), z20, FULL_LANES),
                         timed=True, plain_runs=PLAIN_RUNS)
    merge_errs(errs, ares)
    print_timed(card, "ANS, zipf20, n=2^25", ares)
    del z20

    # 7. ANS without the escape: K6 on ranks, K5 with a value table
    dense = dense_input(DENSE_N)
    run_codec(card, "ANS", dense, find_record(zrec, "ANS", dense), "grouped",
              prepared=True)
    dres = check_kernels(Stage(AnsInt(device=DEVICE), dense, FULL_LANES),
                         timed=True, plain_runs=PLAIN_RUNS)
    merge_errs(errs, dres)
    print_timed(card, "ANS, dense22, n=2^22", dres)

    launches = {name: main_run["launches"][name] for name in SEARCH_PATH}
    launches.update({name: grouped_run["launches"][name] for name in
                     ("encode_scan_grouped", "decode_grouped")})
    timed = {**gres, **kres}  # K2 keeps its main-path time
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"]}
        for name, (src, tpu, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, FileNotFoundError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
