#!/usr/bin/env python3
"""Smoke test of ans_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, ANSfold-2 on zipf(1.25) data at n = 2^25
with S = 4096 lanes (the headline of bench.py), through the entry points
a user calls, and checks it against the reference's bytes:

  0. device: the card's name and power limit;
  1. build: nvcc compiles the three kernels from ans_tpu_torch/csrc;
  2. kernels: each kernel's wrapper on the card against its plain PyTorch
     version on the same inputs (zipf, n = 2^20, S in {32, 4096}, then the
     full-width arrays); all integer, so the tolerance is zero.  Kernel
     and plain times at the full-width shapes (CUDA events, min of 5);
  3. golden fixtures (tests/fixtures/lane, written by ans_tpu): encode
     equals the blob byte for byte, decode equals the input;
  4. full width: the input's sha256 and the blob's length and sha256
     equal tests/fixtures/lane/fullwidth.json; decode is exact; the
     prepared encoder/decoder write and read the same bytes; every kernel
     was launched by this phase.

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
RUNS = 5
DEVICE = "cuda"

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "encode_scan": ("ans_tpu_torch/csrc/encode_scan.cu",
                    "ans_tpu/ops/pallas_encode.py:101"),
    "place": ("ans_tpu_torch/csrc/place.cu",
              "ans_tpu/ops/pallas_place.py:141"),
    "decode_search": ("ans_tpu_torch/csrc/decode_search.cu",
                      "ans_tpu/ops/pallas_decode.py:377"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def zipf_input(n: int, seed: int) -> np.ndarray:
    """bench.py make_data() at size n."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.25, size=n) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


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
    """One input staged for the kernels on the card, via the port's own
    mapping and tables (ANSfold-2): the encode table as encode() builds
    it, the search table as decode() builds it from the prelude."""

    def __init__(self, values: np.ndarray, lanes: int):
        from ans_tpu_torch.models.ans import AnsFold, _stage_ts
        from ans_tpu_torch.ops import lane_codec, tables
        codec = AnsFold(2, lanes=lanes, device=DEVICE)
        mapped, k, low, nfreqs = codec._enc_inputs(values)
        self.n = len(values)
        self.S = lanes
        self.T = lane_codec.lane_steps(self.n, lanes)
        self.mapped, self.nb, self.excw = _stage_ts(mapped, k, low, self.n,
                                                    lanes, self.T)
        self.enc = tables.to_device(tables.build_enc_table(nfreqs), DEVICE)
        self.dec = tables.to_device(codec._search_table(nfreqs), DEVICE)


def ptxas_report(log: str):
    """(kernel instance, resource line) pairs of an `nvcc -Xptxas -v`
    log: each instance's stack frame and spills, then its registers."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # mangled: <length><name>, then ILi<n>E for a template int
            k = re.search(r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?",
                          m.group(1))
            fn = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                  if k else m.group(1))
        elif "registers" in line or "spill" in line:
            yield fn, line.replace("ptxas info    :", "").strip()


def check_kernels(st: Stage, timed: bool) -> dict:
    """Each kernel against its plain version on st; returns per-kernel
    max_abs_err (and ms / plain_ms when timed)."""
    from ans_tpu_torch.ops import decode, encode, lane_codec, place
    res = {}
    packed, states = encode.encode_scan(st.mapped, st.n, st.enc)
    packed_p, states_p = lane_codec.encode_scan_plain(st.mapped, st.n,
                                                      st.enc)
    torch.cuda.synchronize()
    err = max(max_abs_err(packed, packed_p),
              max_abs_err(states, states_p))
    require(err == 0, f"encode_scan differs from its plain version at "
                      f"S={st.S} (max abs err {err})")
    res["encode_scan"] = {"max_abs_err": err}

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
    out = decode.decode_search(*dargs)
    out_p = lane_codec.decode_search_plain(*dargs)
    torch.cuda.synchronize()
    err = max_abs_err(out, out_p)
    require(err == 0,
            f"decode_search differs from its plain version at S={st.S}")
    res["decode_search"] = {"max_abs_err": err}

    if timed:
        pairs = {
            "encode_scan": (
                lambda: encode.encode_scan(st.mapped, st.n, st.enc),
                lambda: lane_codec.encode_scan_plain(st.mapped, st.n,
                                                     st.enc)),
            "place": (lambda: place.place(*args),
                      lambda: lane_codec.place_plain(*args)),
            "decode_search": (
                lambda: decode.decode_search(*dargs),
                lambda: lane_codec.decode_search_plain(*dargs)),
        }
        for name, (kern, plain) in pairs.items():
            res[name]["ms"] = cuda_ms(kern)
            res[name]["plain_ms"] = cuda_ms(plain)
    return res


def check_fixtures() -> int:
    from ans_tpu_torch import models
    from ans_tpu_torch.models.ans import AnsFold
    manifest = json.loads((LANE_FIXTURES / "manifest.json").read_text())
    for rec in manifest:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        require(sha256(blob) == rec["sha256"], f"{rec['blob']} changed")
        if rec["lanes"] is None:
            codec = models.get(rec["method"], device=DEVICE)
        else:
            codec = AnsFold(int(rec["method"].split("-")[1]),
                            lanes=rec["lanes"], device=DEVICE)
        require(codec.encode(x) == blob,
                f"encode of {rec['input']} differs from {rec['blob']}")
        require(np.array_equal(codec.decode(blob, len(x)), x),
                f"decode of {rec['blob']} differs from {rec['input']}")
    return len(manifest)


def main() -> int:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from ans_tpu_torch import models
    from ans_tpu_torch.csrc import build
    from ans_tpu_torch.ops import decode, encode, place

    # 0. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    for name in KERNELS:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(KERNELS)} "
          f"kernels ({build.NVCC_FLAGS[0]})")
    for name, log in build.build_log.items():
        for fn, line in ptxas_report(log):
            print(f"  {name}: {fn}: {line}")

    # 2. kernels against their plain versions
    for lanes in (32, 4096):
        res = check_kernels(Stage(zipf_input(1 << 20, 7),
                                         lanes), timed=False)
        print(f"kernels == plain at n=2^20, S={lanes}: "
              + ", ".join(f"{k} max_abs_err {v['max_abs_err']}"
                          for k, v in res.items()))
    full = zipf_input(FULL_N, FULL_SEED)
    record = json.loads((LANE_FIXTURES / "fullwidth.json").read_text())
    input_sha = sha256(full.tobytes())
    recs = [e for e in record["inputs"] if e["input_sha256"] == input_sha]
    require(len(recs) == 1,
            f"the full-width input (numpy {np.__version__}, sha256 "
            f"{input_sha[:12]}) is not in fullwidth.json: numpy's RNG "
            f"drifted; add it with tests/fixtures/lane/make_fixtures.py "
            f"--full-width-input")
    rec = recs[0]
    kres = check_kernels(Stage(full, FULL_LANES), timed=True)
    for name, r in kres.items():
        print(f"{card} {name} at the main-path shapes (n=2^25, S=4096): "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"max_abs_err {r['max_abs_err']}")
    torch.cuda.synchronize()

    # 3. golden fixtures
    print(f"golden fixtures: {check_fixtures()} blobs re-encoded and "
          f"decoded exactly")
    torch.cuda.synchronize()

    # 4. the main path at full width, through the user's entry points
    for mod in (encode, place, decode):
        mod.launches = 0
    codec = models.get("ANSfold-2", device=DEVICE)
    t0 = time.perf_counter()
    blob = codec.encode(full)
    e2e_enc = time.perf_counter() - t0
    require(len(blob) == rec["blob_len"] and sha256(blob)
            == rec["blob_sha256"],
            f"full-width blob differs from the record: {len(blob)} bytes")
    t0 = time.perf_counter()
    out = codec.decode(blob, FULL_N)
    e2e_dec = time.perf_counter() - t0
    require(np.array_equal(out, full), "full-width decode is not exact")
    pe = models.prepare_encoder("ANSfold-2", full, lanes=FULL_LANES,
                                device=DEVICE)
    require(pe.prelude + pe.to_bytes(*pe()) == blob,
            "prepared encoder bytes differ from encode()")
    pd = models.prepare_decoder("ANSfold-2", blob, FULL_N, device=DEVICE)
    require(np.array_equal(pd.to_host(pd()), full),
            "prepared decoder output differs from the input")
    enc_ms = cuda_ms(pe)
    dec_ms = cuda_ms(pd)
    torch.cuda.synchronize()
    launches = {"encode_scan": encode.launches, "place": place.launches,
                "decode_search": decode.launches}
    for name, count in launches.items():
        require(count > 0, f"the main path never launched {name}")
    plain_enc = kres["encode_scan"]["plain_ms"] + kres["place"]["plain_ms"]
    plain_dec = kres["decode_search"]["plain_ms"]
    print(f"{card} full width: {len(blob)} bytes, "
          f"{8 * len(blob) / FULL_N:.4f} bpi, sha256 {sha256(blob)[:12]}")
    print(f"{card} prepared encode {FULL_N / enc_ms / 1e3:.1f}M ints/s "
          f"({enc_ms:.3f} ms), prepared decode "
          f"{FULL_N / dec_ms / 1e3:.1f}M ints/s ({dec_ms:.3f} ms)")
    print(f"{card} plain versions: encode scan + place "
          f"{FULL_N / plain_enc / 1e3:.1f}M ints/s, decode "
          f"{FULL_N / plain_dec / 1e3:.1f}M ints/s")
    print(f"{card} e2e (host clock, host data): encode {e2e_enc:.3f} s "
          f"({FULL_N / e2e_enc / 1e6:.1f}M ints/s), decode {e2e_dec:.3f} s "
          f"({FULL_N / e2e_dec / 1e6:.1f}M ints/s)")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name, (src, tpu) in KERNELS.items()]}))
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
