#!/usr/bin/env python3
"""Smoke test of ans_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, at full
width, and checks them against the reference's bytes: the main path,
ANSfold-2 on zipf(1.25) data at n = 2^25 with S = 4096 lanes (the
headline of bench.py); the frequency-grouped path, ANSfold-7 on zipf-2^20
data (n = 2^25, S = 4096), with ANS on the same input (tail escape onto
the pivot search) and on a 2^16-symbol input the escape declines
(n = 2^22); the byte path, vbyteANS and streamvbyteANS on the zipf-2^20
data; and the blocked (ATFB) and pseudo-adaptive (ATFP) containers, whose
streams are one batch a kernel launch.  The inputs are
ans_tpu_torch/inputs.py's:

  0. device: the card's name and power limit;
  1. build: nvcc compiles the ten kernels from ans_tpu_torch/csrc, all at
     once; g++ the host library (ans_tpu_torch/native/ans_native.cpp),
     which the host model code of every later phase runs on;
  2. kernels: each kernel's wrapper on the card against its plain PyTorch
     version on the same inputs (S = 4096 at n = 2^20 and S = 32 at
     n = 2^17, 4096 steps: K1-K4 on
     ANSfold-2 and on AnsByte's frame, K5/K6 on ANSfold-7 (in-kernel symbol
     -> rank map, high/nb table), on ANS without the escape (ranks, value
     table), on a frame whose ranks are its values, and with K4 on a
     grouped frame small enough for its per-slot table; K7-K9 on values of
     every byte length; then K1-K4 on the main path's arrays); K3, K4 and
     K5 run in the instance their wrapper picks (the stream staged in a
     shared-memory ring) and once more forced onto global loads, and a
     frame whose tables leave the ring no room takes that instance by
     itself; K2's stream, step offsets and length, and the same bytes on
     five more runs, there and at S = 1 over 2^16 + 5 steps; all integer,
     so the tolerance is zero.  Kernel and plain times
     at the full-width shapes (CUDA events, min of 5 for the kernels; a
     plain version of the lane kernels runs once, for the comparison, and
     that run is its time);
  2b. the step probe (K10): every chain of csrc/op_probe.cu at 32 and 1024
     threads against its plain chain at a small depth (exact), then the
     probe's own entry point, `python3 -m ans_tpu_torch.probe`, at a
     reduced depth, which prints each chain's ns/op and clocks/op and must
     have launched the kernel;
  3. golden fixtures (tests/fixtures/lane, written by ans_tpu): encode
     equals the blob byte for byte, decode equals the input;
  4. the main path at full width: the input's sha256 and the blob's length
     and sha256 equal tests/fixtures/lane/fullwidth.json; decode is exact;
     the prepared encoder/decoder write and read the same bytes; the
     decoder runs the engine the rule picks ("direct", K4) and, forced,
     "search" (K3); K1-K4 were launched by this phase;
  5. the grouped path at full width (records in fullwidth_zipf20.json):
     ANSfold-7 as phase 4, with the prepared decoder on the "grouped"
     engine and K6, K2, K5 launched by this phase;
  6. ANS on the same input: as phase 4, the escape taking it onto the
     "search" engine (K1-K3 launched by this phase);
  7. ANS on the escape-declining input: as phase 5 on the "grouped"
     engine (K6 fed ranks, K5 with a value table);
  8. the byte path at full width (records in fullwidth_bytes.json): vbyte
     and streamvbyte split streams, vbyteANS and streamvbyteANS blobs equal
     to the records, decode exact; K7, K1, K2 launched on encode and K4 and
     K9 / K8 on decode; the AnsByte prepared decode timed under "direct"
     and under "search"; K7 (both formats), K8 and K9 give the same output
     on five more runs, K8's chunk count and ptxas report are printed, and
     each byte kernel's share of its byte bound.
  Phases 5-8 then hold their kernels against the plain versions at their
  own shapes (K5 in both instances) and time both;
  9. ANSmsb and ANSrfold-2 at full width on zipf20 (records in
     fullwidth_zipf20.json): blob equal to the record, decode exact, K1,
     K2 and the rule's decode kernel (K4) launched;
 10. the blocked container (ATFB) at full width: the golden container of
     tests/fixtures/lane/blocked.json first; BlockCodec("ANSfold-2") and
     BlockCodec("ANSfold-7") on zipf20 in D = 32 sections of S = 4096
     lanes, the container equal to fullwidth_blocked.json, decode exact,
     and each call one scan launch (K1 / K6), one placement launch (K2)
     and one decode launch (K4 / K5) for all 32 sections; each batched
     kernel (K1, K2, K3, K4 on ANSfold-2; K6, K2, K5 on ANSfold-7) on the
     container's own staging against its batched plain version, and
     timed; the prepared batched encode and decode timed beside the same
     n as one stream; then ANSfold-2 in D = 128 sections (T = 64): an
     exact round trip, K1, K2, K3 and K4 against their plain versions,
     and its times;
 11. the pseudo-adaptive container (ATFP) at full width: ans_tpu's golden
     containers of tests/fixtures/lane/pseudo.json through encode() and
     decode(); then PseudoAdaptive at its defaults (blocks of 2^17 values,
     S = 32, 256 blocks of n = 2^25, a model each) on zipf20 int (K6, K2,
     K5), zipf20 msb (K1, K2, K4) and zipf125 int (K1, K2, K3), through
     prepare_encoder / prepare_decoder: the container equal to
     fullwidth_pseudo.json, decode exact, each encode call one scan and one
     placement launch a scan batch and each decode call one decode launch
     a decode batch; each batched kernel against its batched plain version
     on the call's own staging (tolerance zero), timed, beside its bound;
     the prepared decode beside the 256 blocks' one-stream decodes;
 12. the host layer and the user's entry point: the host library against
     its plain versions (the host modules' `_native` set to None) on one
     zipf20 block of 2^17, byte for byte: adjust_freqs, serialize_prelude,
     interp.decode, and the compat engine's ANS and ANSfold-2 encode and
     decode, each timed both ways; phase 11's ATFP e2e and staging times,
     which ran on the library; then `python -m ans_tpu_torch`'s main() at
     full width on cuda: compress, info and decompress of bench.py's input
     (n = 2^25, a temporary .u32 file), the ATFC payload equal to
     fullwidth.json's blob and the output file to the input, K1, K2 and
     K4 launched by those calls; `--blocked -D 32 -S 4096` on zipf20, the
     file equal to fullwidth_blocked.json's ANSfold-2 container and
     decompressed exactly, the same kernels launched; and `-m ANSfold-2
     --engine compat` on zipf20 at n = 2^20, exact, timed, with no kernel
     launched (the compat engine codes on the host).

Prints the kernels' JSON line (each kernel's launches on its path, the
probe's on its own run; its time, its plain version's, and its bound: the
larger of the bytes it must move at 3.35 TB/s and its integer operations
at 67 T/s, the published rates of the H100 SXM; for the scans K1 and K6
also the chain bound, T times the probe's clocks of one warp's dependent
encode step at the SM's top clock), then as its last line {"ok": true,
"device": {...}}.  Any failure exits non-zero and prints no result; so
does a machine without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LANE_FIXTURES = ROOT / "tests" / "fixtures" / "lane"
FULL_N, FULL_SEED, FULL_LANES = 1 << 25, 42, 4096
DENSE_N = 1 << 22
BLOCK_D, BLOCK_D_WIDE = 32, 128  # sections of phase 10
# phase 11: PseudoAdaptive's default block size (S = 32 lanes by default)
# on (input, kind), and the scan and decode kernels each cell runs
PSEUDO_BLOCK = 1 << 17
PSEUDO_CELLS = (("zipf20", "int", "encode_scan_grouped", "decode_grouped"),
                ("zipf20", "msb", "encode_scan", "decode_direct"),
                ("zipf125", "int", "encode_scan", "decode_search"))
RUNS, PLAIN_RUNS = 5, 1
PLACE_REPEATS = 5  # K2 reruns that must write the same bytes
BYTE_REPEATS = 5  # K7, K8 and K9 reruns that must give the same output
DEVICE = "cuda"
# published rates of the H100 SXM: device memory, and 32-bit arithmetic
# outside the tensor cores
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12

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
    "decode_direct": ("ans_tpu_torch/csrc/decode_direct.cu",
                      "ans_tpu/ops/pallas_decode.py:207",
                      "decode.direct_launches"),
    "decode_grouped": ("ans_tpu_torch/csrc/decode_grouped.cu",
                       "ans_tpu/ops/pallas_decode.py:852",
                       "decode.grouped_launches"),
    "bytesplit_encode": ("ans_tpu_torch/csrc/bytesplit_encode.cu",
                         "ans_tpu/ops/pallas_bytesplit.py:141",
                         "bytesplit.encode_launches"),
    "svb_decode": ("ans_tpu_torch/csrc/svb_decode.cu",
                   "ans_tpu/ops/pallas_bytesplit.py:276",
                   "bytesplit.svb_decode_launches"),
    "vbyte_decode": ("ans_tpu_torch/csrc/vbyte_decode.cu",
                     "ans_tpu/ops/pallas_bytesplit.py:480",
                     "bytesplit.vbyte_decode_launches"),
    "op_probe": ("ans_tpu_torch/csrc/op_probe.cu", "tools/mosaic_probe.py:44",
                 "probe.launches"),
}
PROBE_COMPARE_ITERS, PROBE_RUN_ITERS = 2, 256
# phase 12: the CLI's blocked container (the sections and lanes of
# fullwidth_blocked.json) and the compat engine's input size
CLI_BLOCK_D, CLI_COMPAT_N = 32, 1 << 20
# ATFP's e2e encode at n = 2^25 on the pure-Python host code, before the
# host library (PERF.md section 6)
PLAIN_ATFP_ENCODE_S = "26.5-72.2"

# integer operations per item, counted from each kernel's source: per
# (lane, step) for the lane kernels (d: the probes of this frame's search:
# the full depth for K3 and K6, the levels behind the bucket load for K5),
# per element for K7 and K8, per stream byte for K9
# (the probe has no entry: it has no work bound)
OPS = {"encode_scan": lambda d: 30, "encode_scan_grouped": lambda d: 4 * d + 51,
       "place": lambda d: 30, "decode_search": lambda d: 4 * d + 30,
       "decode_direct": lambda d: 30, "decode_grouped": lambda d: 4 * d + 55,
       "bytesplit_encode": lambda d: 20, "svb_decode": lambda d: 15,
       "vbyte_decode": lambda d: 10}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def cuda_ms(fn, runs: int = RUNS, warm: bool = True) -> float:
    """Min over `runs` of one call's time between CUDA events (after a
    warm-up call, unless the caller has made one)."""
    if warm:
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(name: str, moved: int, items: int, depth: int = 0) -> dict:
    """The least time the card could take for a kernel's work: the bytes
    it must move (every input read once, every output written once) at the
    card's memory rate, or its integer operations at the card's 32-bit
    rate, whichever is larger."""
    by_bytes = moved / PEAK_BYTES_PER_S * 1e3
    by_ops = OPS[name](depth) * items / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


class Stage:
    """One input staged for the kernels on the card through a codec's own
    mapping and tables: the scan's table and (T, S) inputs as encode()
    builds them, the decode table as decode() builds it from the
    prelude's frequencies (and its per-slot form where that fits)."""

    def __init__(self, codec, values, lanes: int):
        from ans_tpu_torch.models.ans import _stage
        from ans_tpu_torch.ops import lane_codec
        mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(values)
        self.n = int(mapped.shape[0])
        self.S = lanes
        self.T = lane_codec.lane_steps(self.n, lanes)
        self.enc, (self.mapped, self.nb, self.excw) = _stage(
            mapped, k, low, self.n, ffreqs, raw, lanes)
        self.set_dec(codec._table(pfreqs))

    def set_dec(self, table) -> None:
        from ans_tpu_torch.ops import tables
        self.dec = tables.to_device(table, DEVICE)
        self.direct = (tables.to_device(tables.materialize_slots(table),
                                        DEVICE)
                       if tables.direct_fits(table) else None)


class FrameStage(Stage):
    """A hand-built grouped frame over 2^14 or fewer symbols, its values
    drawn from its own frequencies: K6 fed ranks, K5 with no table when
    the ranks are the values (`identity`)."""

    def __init__(self, nf: np.ndarray, n: int, lanes: int, identity: bool):
        from ans_tpu_torch.models.ans import _stage_ts
        from ans_tpu_torch.ops import grouped, lane_codec, tables
        x = np.random.default_rng(5).choice(len(nf), size=n,
                                            p=nf / nf.sum())
        layout = grouped.build_group_layout(nf)
        xt = torch.from_numpy(layout.rank_of[x].view(np.int32)).to(DEVICE)
        zero = torch.zeros_like(xt)
        self.n, self.S = n, lanes
        self.T = lane_codec.lane_steps(n, lanes)
        self.enc = tables.grouped_enc_to_device(layout, DEVICE,
                                                rank_of=False)
        self.mapped, self.nb, self.excw = _stage_ts(xt, zero, zero, n, lanes,
                                                    self.T)
        self.set_dec(tables.build_grouped_table(nf))
        require((self.dec.table.numel() == 0) == identity,
                "the frame's ranks are its values" if not identity else
                "the identity frame has a table")


def identity_frame() -> np.ndarray:
    """Frequencies falling with the value over 2^14 symbols, M = 2^17: the
    ranks are the values (K5 with no table); too large for K4."""
    v = np.arange(1 << 14)
    nf = (1 + (v < 1 << 13) + 2 * (v < 1 << 11) + 5 * (v < 64)).astype(
        np.uint64)
    nf[0] += (1 << 17) - int(nf.sum())
    return nf


def small_grouped_frame() -> np.ndarray:
    """9000 symbols of frequency 1 or 2 in no order, M = 2^14: a grouped
    frame whose per-slot table fits K4's shared memory."""
    f = np.ones(9000, np.int64)
    f[:7384] = 2
    return np.random.default_rng(6).permutation(f).astype(np.uint64)


def ptxas_report(log: str):
    """(kernel instance, resource line) pairs of an `nvcc -Xptxas -v`
    log: each instance's stack frame and spills, then its registers."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # mangled: <length><name>, then I, Li<n>E for each template
            # int and Lb<0|1>E for each template bool, E
            k = re.search(r"\d([a-z][a-z_]*_kernel)(I(?:L[ib]\d+E)+E)?",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
            fn = (k.group(1) + (f"<{','.join(args)}>" if args else "")
                  if k else m.group(1))
        elif "registers" in line or "spill" in line:
            yield fn, line.replace("ptxas info    :", "").strip()


def compare(name: str, where: str, got, want) -> int:
    """max_abs_err over one or more tensor pairs; fails unless 0."""
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = max(max_abs_err(a, b) for a, b in pairs)
    require(err == 0, f"{name} differs from its plain version {where} "
                      f"(max abs err {err})")
    return err


def check_kernels(st: Stage, timed: bool, plain_search: bool = True,
                  step_ns: float | None = None) -> dict:
    """The scan (K1 or K6), K2 (its stream, step offsets and length, and
    the same bytes on PLACE_REPEATS more runs), the layout's decode (K3 or
    K5) and, where the per-slot table fits, K4 of st against their plain
    versions; returns per-kernel max_abs_err (and ms / plain_ms and the
    bound when timed: CUDA events, min of RUNS for a kernel; a plain
    version runs once, for the comparison, and that run is timed; with
    step_ns, the probe's ns per dependent encode step, the scan's chain
    bound).  plain_search=False holds K3 against K4's output instead of its
    own plain version (the byte path's long streams)."""
    from ans_tpu_torch.ops import decode, encode, lane_codec, place, tables
    where = f"at S={st.S}"
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
    res, plain_ms = {}, {}

    def plain(name, fn, *args):
        """A plain version's result; its one run is also its timing."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        return out

    sargs = (st.mapped, st.n, st.enc)
    packed, states = scan[1](*sargs)
    res[scan[0]] = {"max_abs_err": compare(scan[0], where, (packed, states),
                                           plain(scan[0], scan[2], *sargs))}

    pargs = (packed, st.nb, st.excw, st.n)
    stream, step_base, total = place.place(*pargs)
    want = plain("place", lane_codec.place_plain, *pargs)
    require(total == want[2], f"place: {total} bytes, the plain version "
                              f"{want[2]} {where}")
    res["place"] = {"max_abs_err": compare("place", where,
                                           (stream, step_base), want[:2])}
    # the look-back orders only when blocks learn their offsets: the same
    # bytes on every run
    for _ in range(PLACE_REPEATS):
        require(torch.equal(place.place(*pargs, total)[0], stream),
                f"place wrote other bytes on a repeated run {where}")

    kernels = {scan[0]: lambda: scan[1](*sargs),
               "place": lambda: place.place(*pargs, total)}
    out = None
    if st.direct is not None:
        xargs = (stream, states, st.direct, st.n, st.T)
        out = decode.decode_direct(*xargs)
        res["decode_direct"] = {"max_abs_err": compare(
            "decode_direct", where, out,
            plain("decode_direct", lane_codec.decode_direct_plain, *xargs))}
        if not timed:
            compare("decode_direct on global loads", where,
                    decode.decode_direct(*xargs, instance="global"), out)
        kernels["decode_direct"] = lambda: decode.decode_direct(*xargs)
    dargs = (stream, states, st.dec, st.n, st.T)
    use_plain = plain_search or out is None
    got = dec[1](*dargs)
    res[dec[0]] = {"max_abs_err": compare(
        dec[0], where, got,
        plain(dec[0], dec[2], *dargs) if use_plain else out)}
    if grouped or not timed:
        compare(f"{dec[0]} on global loads", where,
                dec[1](*dargs, instance="global"), got)
    kernels[dec[0]] = lambda: dec[1](*dargs)

    if timed:
        items = st.T * st.S
        moved = {
            scan[0]: nbytes(st.mapped, packed, states, *[
                t for t in vars(st.enc).values() if torch.is_tensor(t)]),
            "place": nbytes(packed, st.nb, st.excw, step_base, stream) + 8}
        for name, tab in ((dec[0], st.dec), ("decode_direct", st.direct)):
            if tab is not None:
                moved[name] = 4 * items + nbytes(stream, states, *[
                    t for t in vars(tab).values() if torch.is_tensor(t)])
        for name, kern in kernels.items():
            res[name]["ms"] = cuda_ms(kern)
            res[name]["plain_ms"] = plain_ms.get(name)
            tab = st.enc if name == scan[0] else st.dec
            res[name].update(bound(
                name, moved[name], items,
                getattr(tab, "levels", getattr(tab, "depth", 0))))
        if step_ns is not None:  # T dependent encode steps, one after another
            res[scan[0]]["chain_bound_ms"] = st.T * step_ns / 1e6
    return res


def check_bytesplit(x: torch.Tensor, timed: bool) -> dict:
    """K7 (both formats), K8 and K9 on the (n,) i32 values x against their
    plain versions, and the round trip; when timed, K7, K8 and K9 give the
    same output on BYTE_REPEATS more runs (their status words are zeroed every
    call), and timings and bounds as check_kernels gives them.  K7's time
    is the vbyte format's (5 phases of compares against streamvbyte's 4);
    streamvbyte's is printed."""
    from ans_tpu_torch.ops import bytesplit as bs
    n = x.numel()
    where = f"at n={n}"
    vb = bs.vbyte_encode(x)
    ctrl, data = bs.svb_encode(x)
    err = max(compare("bytesplit_encode (vbyte)", where, vb,
                      bs.vbyte_encode_plain(x)),
              compare("bytesplit_encode (streamvbyte)", where, (ctrl, data),
                      bs.svb_encode_plain(x)))
    res = {"bytesplit_encode": {"max_abs_err": err}}
    got = bs.vbyte_decode(vb, n)
    res["vbyte_decode"] = {"max_abs_err": compare(
        "vbyte_decode", where, got, bs.vbyte_decode_plain(vb, n))}
    require(torch.equal(got, x), "vbyte does not round-trip")
    got = bs.svb_decode(ctrl, data, n)
    res["svb_decode"] = {"max_abs_err": compare(
        "svb_decode", where, got, bs.svb_decode_plain(ctrl, data, n))}
    require(torch.equal(got, x), "streamvbyte does not round-trip")
    if timed:
        for _ in range(BYTE_REPEATS):
            require(torch.equal(bs.vbyte_encode(x), vb),
                    f"bytesplit_encode (vbyte) {where}: other bytes on a "
                    f"repeated run")
            c2, d2 = bs.svb_encode(x)
            require(torch.equal(c2, ctrl) and torch.equal(d2, data),
                    f"bytesplit_encode (streamvbyte) {where}: other bytes on "
                    f"a repeated run")
            require(torch.equal(bs.vbyte_decode(vb, n), x),
                    f"vbyte_decode {where}: other values on a repeated run")
            require(torch.equal(bs.svb_decode(ctrl, data, n), x),
                    f"svb_decode {where}: other values on a repeated run")
        pairs = {
            "bytesplit_encode": (lambda: bs.vbyte_encode(x),
                                 lambda: bs.vbyte_encode_plain(x),
                                 nbytes(x, vb), n),
            "svb_decode": (lambda: bs.svb_decode(ctrl, data, n),
                           lambda: bs.svb_decode_plain(ctrl, data, n),
                           nbytes(ctrl, data, x), n),
            "vbyte_decode": (lambda: bs.vbyte_decode(vb, n),
                             lambda: bs.vbyte_decode_plain(vb, n),
                             nbytes(vb, x), vb.numel())}
        for name, (kern, plain, moved, items) in pairs.items():
            res[name]["ms"] = cuda_ms(kern)
            res[name]["plain_ms"] = cuda_ms(plain, PLAIN_RUNS, warm=False)
            res[name].update(bound(name, moved, items))
        res["bytesplit_encode"]["svb_ms"] = cuda_ms(lambda: bs.svb_encode(x))
    return res


def check_place_long() -> dict:
    """K2 at S = 1 over 2^16 + 5 steps (far more chunks than blocks in
    flight, most of them writing no byte) against its plain version, and
    the same bytes on PLACE_REPEATS more runs."""
    from ans_tpu_torch.ops import lane_codec, place
    T, S = (1 << 16) + 5, 1
    rng = np.random.default_rng(14)
    rc = np.where(rng.random((T, S)) < 0.3, rng.integers(1, 4, (T, S)), 0)
    nb = np.where(rng.random((T, S)) < 0.2, rng.integers(0, 4, (T, S)), 0)
    packed, nb, excw = (torch.from_numpy(a.astype(np.int32)).to(DEVICE) for a
                        in (rng.integers(0, 1 << 24, (T, S)) | (rc << 24),
                            nb, rng.integers(0, 1 << 24, (T, S))))
    stream, step_base, total = place.place(packed, nb, excw, T)
    want = lane_codec.place_plain(packed, nb, excw, T)
    require(total == want[2], f"place at S=1: {total} bytes, the plain "
                              f"version {want[2]}")
    err = compare("place", "at S=1 over 2^16 steps", (stream, step_base),
                  want[:2])
    for _ in range(PLACE_REPEATS):
        require(torch.equal(place.place(packed, nb, excw, T, total)[0],
                            stream),
                "place wrote other bytes on a repeated run at S=1")
    return {"place": {"max_abs_err": err}}


def full_block_frame() -> np.ndarray:
    """5500 symbols over M = 2^16: 219 KB of per-slot tables, which leave
    the stream's ring no room in K4's shared memory."""
    rng = np.random.default_rng(12)
    nf = 1 + rng.multinomial((1 << 16) - 5500, np.full(5500, 1 / 5500))
    return nf.astype(np.uint64)


def check_full_block() -> dict:
    """K1, K2 and K4 on a frame that fills the block: the wrapper must
    take K4's instance on global loads by itself."""
    from ans_tpu_torch.models.ans import _stage
    from ans_tpu_torch.ops import decode, encode, lane_codec, place, tables
    nf, n, S = full_block_frame(), 1 << 20, FULL_LANES
    x = np.random.default_rng(13).choice(len(nf), size=n, p=nf / nf.sum())
    xt = torch.from_numpy(x.astype(np.int32)).to(DEVICE)
    zero = torch.zeros_like(xt)
    enc, (mapped, nb, excw) = _stage(xt, zero, zero, n, nf, True, S)
    T = mapped.shape[0]
    packed, states = encode.encode_scan(mapped, n, enc)
    stream, _, _ = place.place(packed, nb, excw, n)
    table = tables.build_dec_table(nf)
    direct = tables.to_device(tables.materialize_slots(table), DEVICE)
    before = decode.instance_launches["decode_direct"]["global"]
    got = decode.decode_direct(stream, states, direct, n, T)
    require(decode.instance_launches["decode_direct"]["global"] == before + 1,
            "a frame that fills the block did not take K4's instance on "
            "global loads")
    err = compare("decode_direct", "on a frame that fills the block", got,
                  lane_codec.decode_direct_plain(stream, states, direct, n,
                                                 T))
    require(torch.equal(got.reshape(-1)[:n], xt),
            "decode_direct on a frame that fills the block is not exact")
    return {"decode_direct": {"max_abs_err": err}}


def check_probe(card: str) -> dict:
    """K10: every chain at 32 and 1024 threads against its plain chain at
    PROBE_COMPARE_ITERS (exact; the sum of the 1024-thread kernel and plain
    times is the row's ms / plain_ms), then the probe's own entry point at
    PROBE_RUN_ITERS with the launch count set to 0 before it."""
    from ans_tpu_torch import probe
    inp = probe.make_inputs(DEVICE, 1 << 20)
    err, ms, plain_ms = 0, 0.0, 0.0
    for name in probe.CHAINS:
        for threads in (32, 1024):
            x = probe.make_x(name, threads, DEVICE)
            got, clocks = probe.run_kernel(name, x, PROBE_COMPARE_ITERS, inp)
            require(clocks > 0, f"probe chain {name} took no clocks")
            err = max(err, compare(
                f"op_probe chain {name}", f"at {threads} threads", got,
                probe.run_plain(name, x, PROBE_COMPARE_ITERS, inp)))
        ms += cuda_ms(lambda: probe.run_kernel(name, x, PROBE_COMPARE_ITERS,
                                               inp), runs=3)
        plain_ms += cuda_ms(lambda: probe.run_plain(
            name, x, PROBE_COMPARE_ITERS, inp), PLAIN_RUNS, warm=False)
    print(f"kernels == plain, {len(probe.CHAINS)} probe chains at 32 and "
          f"1024 threads, {PROBE_COMPARE_ITERS * probe.UNROLL} ops deep: "
          f"op_probe max_abs_err {err}")
    # one warp's dependent encode steps: what K1's and K6's chain bound is
    # made of
    step = probe.time_chain("encode_step", 32, PROBE_RUN_ITERS // 4, inp)
    print(f"{card} encode_step at 32 threads: {step['clocks_per_op']:.1f} "
          f"clocks a step")
    del inp
    probe.launches = 0
    require(probe.main(["--iters", str(PROBE_RUN_ITERS)]) == 0,
            "python3 -m ans_tpu_torch.probe failed")
    launches = probe.launches
    require(launches >= 2 * len(probe.CHAINS),
            f"the probe's run launched its kernel {launches} times")
    print(f"{card} op_probe: all chains at 1024 threads, "
          f"{PROBE_COMPARE_ITERS * probe.UNROLL} ops deep: kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms; no bound (a probe's work is the "
          f"latency it measures) and no library call; {launches} launches "
          f"by its own run")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": None, "bound_by": "operations", "launches": launches,
            "encode_step_clocks": step["clocks_per_op"]}


def merge_errs(total: dict, res: dict) -> None:
    for name, r in res.items():
        total[name] = max(total.get(name, 0), r["max_abs_err"])


def print_timed(card: str, where: str, res: dict) -> None:
    for name, r in res.items():
        plain = ("not timed" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.3f} ms")
        chain = (f", chain bound {r['chain_bound_ms']:.4f} ms"
                 if "chain_bound_ms" in r else "")
        print(f"{card} {name} at the shapes of {where}: kernel "
              f"{r['ms']:.3f} ms, plain {plain}, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}{chain}, max_abs_err "
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


def counter_modules() -> dict:
    from ans_tpu_torch import probe
    from ans_tpu_torch.ops import bytesplit, decode, encode, place
    return {"encode": encode, "place": place, "decode": decode,
            "bytesplit": bytesplit, "probe": probe}


def reset_launches() -> None:
    mods = counter_modules()
    for _, _, counter in KERNELS.values():
        mod, attr = counter.split(".")
        setattr(mods[mod], attr, 0)
    for counts in mods["decode"].instance_launches.values():
        for instance in counts:
            counts[instance] = 0


def read_launches() -> dict:
    mods = counter_modules()
    out = {}
    for name, (_, _, counter) in KERNELS.items():
        mod, attr = counter.split(".")
        out[name] = getattr(mods[mod], attr)
    return out


def require_launched(what: str, launches: dict, kernels) -> None:
    """Every kernel's counter moved, and for the lockstep decodes the
    counters of their instances add up to it."""
    by_instance = counter_modules()["decode"].instance_launches
    for kernel in kernels:
        require(launches[kernel] > 0, f"{what} never launched {kernel}")
        if kernel in by_instance:
            require(sum(by_instance[kernel].values()) == launches[kernel],
                    f"{what}: {kernel} launched {launches[kernel]} times, "
                    f"its instances {by_instance[kernel]}")


ENCODE_PATH = {"search": ("encode_scan", "place"),
               "grouped": ("encode_scan_grouped", "place")}
DECODE_KERNEL = {"search": "decode_search", "grouped": "decode_grouped",
                 "direct": "decode_direct"}


def run_codec(card: str, name: str, x: np.ndarray, rec: dict,
              layout: str, engine: str, also: str | None = None) -> dict:
    """encode/decode of `name` on x through the user's entry points: the
    blob equals the record, decode is exact, the prepared decoder takes
    `engine` (the rule's choice) and, forced, `also`; the prepared encoder
    reproduces the bytes; every kernel of the layout's encode path and of
    each engine was launched by this run.  Returns the launches of this
    run and its numbers."""
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
    r = {"blob": blob, "e2e_enc": e2e_enc, "e2e_dec": e2e_dec, "dec_ms": {}}
    pe = models.prepare_encoder(name, x, lanes=FULL_LANES, device=DEVICE)
    require(pe.prelude + pe.to_bytes(*pe()) == blob,
            f"{name}: prepared encoder bytes differ from encode()")
    r["enc_ms"] = cuda_ms(pe)
    for eng in (None, also) if also else (None,):
        pd = models.prepare_decoder(name, blob, n, device=DEVICE, engine=eng)
        require(pd.engine == (eng or engine),
                f"{name}: prepared decoder engine {pd.engine}, not "
                f"{eng or engine}")
        require(np.array_equal(pd.to_host(pd()), x),
                f"{name}: prepared decoder ({pd.engine}) output differs "
                f"from the input")
        r["dec_ms"][pd.engine] = cuda_ms(pd)
    torch.cuda.synchronize()
    r["launches"] = read_launches()
    require_launched(f"{name} on the {engine} engine", r["launches"], (
        *ENCODE_PATH[layout], DECODE_KERNEL[engine],
        *((DECODE_KERNEL[also],) if also else ())))
    from ans_tpu_torch.ops import decode
    print(f"{card} {name}: {DECODE_KERNEL[engine]} by instance: "
          f"{decode.instance_launches[DECODE_KERNEL[engine]]}")
    print(f"{card} {name}: {len(blob)} bytes, {8 * len(blob) / n:.4f} bpi, "
          f"sha256 {sha256(blob)[:12]}, engine {engine}; e2e (host "
          f"clock, host data) encode {e2e_enc:.3f} s, decode "
          f"{e2e_dec:.3f} s")
    print(f"{card} {name}: prepared encode "
          f"{n / r['enc_ms'] / 1e3:.1f}M ints/s ({r['enc_ms']:.3f} ms), "
          f"prepared decode " + ", ".join(
              f"{eng} {n / ms / 1e3:.1f}M ints/s ({ms:.3f} ms)"
              for eng, ms in r["dec_ms"].items()))
    return r


def run_byte_codec(card: str, name: str, x: np.ndarray, path: Path) -> dict:
    """A byte-path method on x through models.get: the split stream of its
    splitter and the composite's blob equal the records, both decode
    exactly, and this run launched K7, K1, K2 on encode and K4 and the
    splitter's decode kernel (K9 for vbyte, K8 for streamvbyte) on decode.
    Times the AnsByte prepared decode under "direct" (the rule's choice)
    and under "search"."""
    from ans_tpu_torch import models
    n = len(x)
    splitter = name[:-3]
    reset_launches()
    split = models.get(splitter, device=DEVICE)
    rec = find_record(path, splitter, x)
    stream = split.encode(x)
    require(len(stream) == rec["blob_len"] and sha256(stream)
            == rec["blob_sha256"],
            f"{splitter}: split stream differs from the record")
    require(np.array_equal(split.decode(stream, n), x),
            f"{splitter}: decode is not exact")
    del stream
    rec = find_record(path, name, x)
    codec = models.get(name, device=DEVICE)
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
    nb = int.from_bytes(blob[:4], "little")
    dec_ms = {}
    want = None
    for eng in (None, "search"):
        pd = codec.entropy.prepare_decoder(blob[4:], nb, eng)
        require(pd.engine == (eng or "direct"),
                f"{name}: AnsByte decoder engine {pd.engine}")
        got = pd()
        require(want is None or torch.equal(got, want),
                f"{name}: the engines decode AnsByte's blob differently")
        want = got
        dec_ms[pd.engine] = cuda_ms(pd)
    torch.cuda.synchronize()
    launches = read_launches()
    require_launched(name, launches, (
        "bytesplit_encode", "encode_scan", "place", "decode_direct",
        "decode_search",
        "vbyte_decode" if splitter == "vbyte" else "svb_decode"))
    print(f"{card} {name}: {len(blob)} bytes, {8 * len(blob) / n:.4f} bpi "
          f"({nb} split bytes, S={rec['lanes']}), sha256 "
          f"{sha256(blob)[:12]}; e2e (host clock, host data) encode "
          f"{e2e_enc:.3f} s, decode {e2e_dec:.3f} s; AnsByte prepared "
          f"decode " + ", ".join(f"{eng} {ms:.3f} ms ({nb / ms / 1e3:.1f}M "
                                 f"bytes/s)" for eng, ms in dec_ms.items()))
    return {"launches": launches, "dec_ms": dec_ms, "e2e_enc": e2e_enc,
            "e2e_dec": e2e_dec}


def check_batched(bc, x: np.ndarray, step_ns: float | None = None) -> dict:
    """The batched kernels of a BlockCodec's container of x, staged as its
    encode stages them ((D, T, S) inputs, the sections' lengths, the
    shared table): the scan (K1 or K6), K2 and the decodes (the rule's
    engine, and K3 forced on a value-order frame), each against its
    batched plain version on the same inputs (all integer: tolerance
    zero; the values of each section also equal its input), then timed as
    check_kernels times them: one launch for the batch, CUDA events, min
    of RUNS; the plain version's one run, for the comparison, is its
    time; the bound: every input read once, the shared tables once; the
    scan's chain bound the section's T steps."""
    from ans_tpu_torch.ops import decode, encode, lane_codec, place, tables
    _, (m, nb, ex), n, enc, _ = bc._front(x)
    D, T, S = m.shape
    where = f"in a batch of D={D} at n={len(x)}, S={S}"
    grouped = isinstance(enc, tables.GroupedEncDevice)
    scan, scan_plain = ((encode.encode_scan_grouped_batch,
                         lane_codec.encode_scan_grouped_batch_plain)
                        if grouped else
                        (encode.encode_scan_batch,
                         lane_codec.encode_scan_batch_plain))
    sname = "encode_scan_grouped" if grouped else "encode_scan"
    errs, plain_ms = {}, {}

    def plain(name, fn, *args):
        """A plain version's result; its one run is also its timing."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        return out

    packed, states = scan(m, n, enc)
    errs[sname] = compare(sname, where, (packed, states), plain(
        sname, scan_plain, m, n, enc))
    stream, offsets, ends = place.place_batch(packed, nb, ex, n)
    errs["place"] = compare("place", where, (stream, offsets), plain(
        "place", lane_codec.place_batch_plain, packed, nb, ex, n))
    stream_off = torch.cat([offsets[:, 0], offsets[-1:, T]]).contiguous()
    blob = bc.encode(x)
    pd = bc.prepare_decoder(blob)
    engines = [(pd.engine, pd.table)]
    if not grouped:  # K3 forced beside the rule's K4
        engines.append(("search",
                        bc.prepare_decoder(blob, engine_name="search").table))
    batch = {"search": decode.decode_search_batch,
             "direct": decode.decode_direct_batch,
             "grouped": decode.decode_grouped_batch}
    plains = {"search": lane_codec.decode_search_batch_plain,
              "direct": lane_codec.decode_direct_batch_plain,
              "grouped": lane_codec.decode_grouped_batch_plain}
    runs = {sname: (lambda: scan(m, n, enc), enc),
            "place": (lambda: place.place_batch(packed, nb, ex, n, ends),
                      enc)}
    for eng, tab in engines:
        name = DECODE_KERNEL[eng]
        out = batch[eng](stream, stream_off, states, n, tab, T)
        require(np.array_equal(pd.to_host(out), x),
                f"{name} {where} does not decode the sections' values")
        want = plain(name, plains[eng], stream, stream_off, states, n, tab,
                     T)
        errs[name] = compare(name, where, valid_outputs(out, n),
                             valid_outputs(want, n))
        runs[name] = (lambda f=batch[eng], t=tab: f(
            stream, stream_off, states, n, t, T), tab)
    items = D * T * S
    moved = {sname: nbytes(m, packed, states, *[
        t for t in vars(enc).values() if torch.is_tensor(t)]),
        "place": nbytes(packed, nb, ex, offsets, stream) + 8}
    for name, (_, tab) in runs.items():
        if name not in moved:
            moved[name] = 4 * items + nbytes(stream, stream_off, states, n, *[
                t for t in vars(tab).values() if torch.is_tensor(t)])
    res = {}
    for name, (fn, tab) in runs.items():
        res[name] = {"max_abs_err": errs[name], "ms": cuda_ms(fn),
                     "plain_ms": plain_ms[name], **bound(
                         name, moved[name], items,
                         getattr(tab, "levels", getattr(tab, "depth", 0)))}
    if step_ns is not None:  # the sections' scans run side by side
        res[sname]["chain_bound_ms"] = T * step_ns / 1e6
    return res


def valid_outputs(out: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The first n[d] outputs of each stream of a batch, one after the
    other (what a batched decode is held to)."""
    flat = out.reshape(out.shape[0], -1)
    return torch.cat([flat[d, :k] for d, k in enumerate(n.tolist())])


def print_batched(card: str, where: str, res: dict) -> None:
    for name, r in res.items():
        chain = (f", chain bound {r['chain_bound_ms']:.4f} ms"
                 if "chain_bound_ms" in r else "")
        print(f"{card} {name}, one launch for {where}: {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}{chain}, max_abs_err {r['max_abs_err']}")


def run_blocked(card: str, method: str, x: np.ndarray, D: int,
                rec: dict | None) -> dict:
    """BlockCodec(method) in D sections of FULL_LANES lanes on x: the
    container equal to the record (when given), decode exact, and each
    call one launch of the scan, of K2 and of the decode for all sections;
    the prepared batched encode (pe.to_bytes(*pe()) the same container)
    and decode timed.  Returns the launches of the encode and of the
    decode, and the times."""
    from ans_tpu_torch.parallel import BlockCodec
    bc = BlockCodec(method, D, FULL_LANES, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    blob = bc.encode(x)
    e2e_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    enc_launches = read_launches()
    if rec is not None:
        require(len(blob) == rec["blob_len"]
                and sha256(blob) == rec["blob_sha256"],
                f"{method} in {D} sections: container differs from the "
                f"record: {len(blob)} bytes")
    reset_launches()
    t0 = time.perf_counter()
    out = bc.decode(blob, len(x))
    e2e_dec = time.perf_counter() - t0
    torch.cuda.synchronize()
    dec_launches = read_launches()
    require(np.array_equal(out, x),
            f"{method} in {D} sections: decode is not exact")
    scan = [k for k in ("encode_scan", "encode_scan_grouped")
            if enc_launches[k]]
    dec = [k for k in DECODE_KERNEL.values() if dec_launches[k]]
    require(len(scan) == 1 and enc_launches[scan[0]] == 1
            and enc_launches["place"] == 1
            and sum(enc_launches[k] for k in DECODE_KERNEL.values()) == 0,
            f"{method} in {D} sections: the encode launched {enc_launches}, "
            f"not one scan and one placement")
    require(len(dec) == 1 and dec_launches[dec[0]] == 1
            and sum(dec_launches[k] for k in ENCODE_PATH["search"]
                    + ENCODE_PATH["grouped"]) == 0,
            f"{method} in {D} sections: the decode launched {dec_launches}, "
            f"not one decode")
    pe = bc.prepare_encoder(x)
    require(pe.to_bytes(*pe()) == blob,
            f"{method} in {D} sections: prepared encoder bytes differ")
    pd = bc.prepare_decoder(blob)
    require(np.array_equal(pd.to_host(pd()), x),
            f"{method} in {D} sections: prepared decode is not exact")
    enc_ms, dec_ms = cuda_ms(pe), cuda_ms(pd)
    n = len(x)
    print(f"{card} {method} in {D} sections of {FULL_LANES} lanes: "
          f"{len(blob)} bytes, {8 * len(blob) / n:.4f} bpi, sha256 "
          f"{sha256(blob)[:12]}; encode launched {scan[0]} x1, place x1; "
          f"decode {dec[0]} x1 ({pd.engine}); e2e (host clock, host data) "
          f"encode {e2e_enc:.3f} s, decode {e2e_dec:.3f} s; prepared "
          f"encode {n / enc_ms / 1e3:.1f}M ints/s ({enc_ms:.3f} ms), "
          f"prepared decode {n / dec_ms / 1e3:.1f}M ints/s ({dec_ms:.3f} "
          f"ms)")
    return {"enc_launches": enc_launches, "dec_launches": dec_launches,
            "enc_ms": enc_ms, "dec_ms": dec_ms, "engine": pd.engine,
            "bytes": len(blob), "e2e_enc": e2e_enc, "e2e_dec": e2e_dec}


def one_stream_times(name: str, x: np.ndarray) -> tuple:
    """The prepared encode and decode of x as one stream (ms), decode
    exact: the yardstick of the blocked times."""
    from ans_tpu_torch import models
    pe = models.prepare_encoder(name, x, lanes=FULL_LANES, device=DEVICE)
    blob = pe.prelude + pe.to_bytes(*pe())
    pd = models.prepare_decoder(name, blob, len(x), device=DEVICE)
    require(np.array_equal(pd.to_host(pd()), x),
            f"{name} as one stream: decode is not exact")
    return cuda_ms(pe), cuda_ms(pd), pd.engine


def check_golden_container() -> int:
    """The committed containers of ans_tpu (blocked.json) re-encode to the
    same bytes on the card and decode exactly."""
    from ans_tpu_torch.parallel import BlockCodec
    recs = json.loads((LANE_FIXTURES / "blocked.json").read_text())
    for rec in recs:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        require(sha256(blob) == rec["sha256"], f"{rec['blob']} changed")
        bc = BlockCodec(rec["method"], rec["sections"], rec["lanes"],
                        device=DEVICE)
        require(bc.encode(x) == blob,
                f"encode of {rec['input']} differs from {rec['blob']}")
        require(np.array_equal(bc.decode(blob, len(x)), x),
                f"decode of {rec['blob']} differs from {rec['input']}")
    return len(recs)


def check_golden_pseudo() -> int:
    """The committed ATFP containers of ans_tpu (pseudo.json, lane and
    compat) re-encode to the same bytes through encode() on the card and
    decode exactly."""
    from ans_tpu_torch.models.pseudo_adaptive import PseudoAdaptive
    recs = json.loads((LANE_FIXTURES / "pseudo.json").read_text())
    for rec in recs:
        x = np.fromfile(LANE_FIXTURES / rec["input"], dtype="<u4")
        blob = (LANE_FIXTURES / rec["blob"]).read_bytes()
        require(sha256(blob) == rec["sha256"], f"{rec['blob']} changed")
        codec = PseudoAdaptive(rec["block_size"], rec["kind"], rec["lanes"],
                               rec["engine"], device=DEVICE)
        require(codec.encode(x) == blob,
                f"encode of {rec['input']} differs from {rec['blob']}")
        require(np.array_equal(codec.decode(blob), x),
                f"decode of {rec['blob']} differs from {rec['input']}")
    return len(recs)


def find_pseudo_record(x: np.ndarray, kind: str) -> dict:
    input_sha = sha256(x.tobytes())
    recs = [e for e in json.loads((LANE_FIXTURES / "fullwidth_pseudo.json")
                                  .read_text())["inputs"]
            if e["kind"] == kind and e["input_sha256"] == input_sha]
    require(len(recs) == 1,
            f"pseudo_adaptive {kind}: the input (numpy {np.__version__}, "
            f"sha256 {input_sha[:12]}) is not in fullwidth_pseudo.json")
    return recs[0]


def run_pseudo(card: str, name: str, kind: str, x: np.ndarray, scan: str,
               dec: str, step_ns: float) -> dict:
    """PseudoAdaptive(kind) at its defaults on x through the prepared entry
    points (encode(values) and decode(blob) are prepare, one call and the
    bytes): the container equals the record, decode is exact; the encode
    call is one scan launch (`scan`) and one placement launch a scan batch,
    the decode call one `dec` launch a decode batch, by the counters; each
    batched kernel against its batched plain version on the call's own
    staging (tolerance zero), timed (CUDA events, min of RUNS; a plain
    version runs once, and that run is its time) beside its bound and, for
    the scan, its chain bound; the prepared decode beside the blocks'
    one-stream decodes, one launch each."""
    from ans_tpu_torch.models.pseudo_adaptive import PseudoAdaptive
    from ans_tpu_torch.ops import decode, encode, lane_codec, place
    n = len(x)
    rec = find_pseudo_record(x, kind)
    codec = PseudoAdaptive(kind=kind, device=DEVICE)
    where = f"pseudo_adaptive {kind} on {name}"
    t0 = time.perf_counter()
    pe = codec.prepare_encoder(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_launches()
    outs = pe()
    torch.cuda.synchronize()
    enc_launches = read_launches()
    blob = pe.to_bytes(outs)
    e2e_enc, stage_enc = time.perf_counter() - t0, t1 - t0
    require(len(blob) == rec["blob_len"]
            and sha256(blob) == rec["blob_sha256"],
            f"{where}: container differs from the record: {len(blob)} "
            "bytes")
    t0 = time.perf_counter()
    pd = codec.prepare_decoder(blob)
    t1 = time.perf_counter()
    reset_launches()
    out = pd()
    torch.cuda.synchronize()
    dec_launches = read_launches()
    require(np.array_equal(pd.to_host(out), x), f"{where}: decode is not "
                                                "exact")
    e2e_dec, stage_dec = time.perf_counter() - t0, t1 - t0
    nenc, ndec = len(pe.batches), len(pd.batches)
    scans = ("encode_scan", "encode_scan_grouped")
    require(enc_launches[scan] == nenc and enc_launches["place"] == nenc
            and sum(enc_launches[k] for k in scans) == nenc
            and sum(enc_launches[k] for k in DECODE_KERNEL.values()) == 0,
            f"{where}: the encode launched {enc_launches} for {nenc} scan "
            f"batches")
    require(dec_launches[dec] == ndec
            and sum(dec_launches[k] for k in DECODE_KERNEL.values()) == ndec
            and sum(dec_launches[k] for k in (*scans, "place")) == 0,
            f"{where}: the decode launched {dec_launches} for {ndec} "
            f"decode batches")
    require_launched(where, {**enc_launches, dec: dec_launches[dec]},
                     (scan, "place", dec))
    launches = {scan: nenc, "place": nenc, dec: ndec}
    blocks = sum(len(b[0]) for b in pe.batches)

    # each kernel against its plain version on this staging, then timed
    errs, plain_ms, runs = {}, {}, {}

    def plain(kname, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms[kname] = plain_ms.get(kname, 0.0) + start.elapsed_time(end)
        return got

    scan_fn, scan_plain = ((encode.encode_scan_grouped_batch,
                            lane_codec.encode_scan_grouped_batch_plain)
                           if scan == "encode_scan_grouped" else
                           (encode.encode_scan_batch,
                            lane_codec.encode_scan_batch_plain))
    dec_fn, dec_plain = {
        "decode_search": (decode.decode_search_batch,
                          lane_codec.decode_search_batch_plain),
        "decode_direct": (decode.decode_direct_batch,
                          lane_codec.decode_direct_batch_plain),
        "decode_grouped": (decode.decode_grouped_batch,
                           lane_codec.decode_grouped_batch_plain)}[dec]
    moved = {scan: 0, "place": 0, dec: 0}
    items, depth, T_max = 0, 0, 0
    for _, b in pe.batches:
        args = (b.mapped, b.lengths, b.table)
        packed, states = scan_fn(*args)
        errs[scan] = max(errs.get(scan, 0), compare(
            scan, where, (packed, states), plain(scan, scan_plain, *args)))
        pargs = (packed, b.nb, b.excw, b.lengths)
        stream, offsets, ends = place.place_batch(*pargs)
        errs["place"] = max(errs.get("place", 0), compare(
            "place", where, (stream, offsets),
            plain("place", lane_codec.place_batch_plain, *pargs)))
        runs.setdefault(scan, []).append(lambda a=args: scan_fn(*a))
        runs.setdefault("place", []).append(
            lambda a=pargs, e=ends: place.place_batch(*a, e))
        moved[scan] += nbytes(b.mapped, packed, states,
                              *b.table.device_tensors())
        moved["place"] += nbytes(packed, b.nb, b.excw, offsets, stream) + 8
        items += b.mapped.numel()
        T_max = max(T_max, b.T)
        if scan == "encode_scan_grouped":
            depth = max(depth, b.table.largest("depth"))
    dec_items, dec_depth = 0, 0
    one_stream = []
    for batch in pd.batches:
        d = batch["decoder"]
        args = (d.stream, d.stream_off, d.states, d.n, d.table, d.T)
        got = dec_fn(*args)
        errs[dec] = max(errs.get(dec, 0), compare(
            dec, where, valid_outputs(got, d.n),
            valid_outputs(plain(dec, dec_plain, *args), d.n)))
        runs.setdefault(dec, []).append(lambda a=args: dec_fn(*a))
        moved[dec] += 4 * got.numel() + nbytes(
            d.stream, d.stream_off, d.states, d.n, *d.table.device_tensors())
        dec_items += got.numel()
        if dec != "decode_direct":
            dec_depth = max(dec_depth, d.table.largest(
                "levels" if dec == "decode_grouped" else "depth"))
        # the same blocks as one-stream decodes: one launch each
        off = d.stream_off.tolist()
        for k, nk in enumerate(d.n_sec.tolist()):
            one_stream.append((d.stream[off[k]:off[k + 1]], d.states[k],
                               d.table.table(k), nk, d.T))
    one = {"decode_search": decode.decode_search,
           "decode_direct": decode.decode_direct,
           "decode_grouped": decode.decode_grouped}[dec]
    res = {}
    for kname, fns in runs.items():
        ms = cuda_ms(lambda f=fns: [g() for g in f])
        tab_items = dec_items if kname == dec else items
        res[kname] = {"max_abs_err": errs[kname], "ms": ms,
                      "plain_ms": plain_ms[kname], "launches":
                      launches[kname], **bound(
                          kname, moved[kname], tab_items,
                          dec_depth if kname == dec else depth)}
    res[scan]["chain_bound_ms"] = T_max * step_ns / 1e6
    enc_ms, dec_ms = cuda_ms(pe), cuda_ms(pd)
    one_ms = cuda_ms(lambda: [one(*a) for a in one_stream])
    print(f"{card} {where}, n=2^{n.bit_length() - 1}, {blocks} lane blocks "
          f"of {PSEUDO_BLOCK}: {len(blob)} bytes, {8 * len(blob) / n:.4f} "
          f"bpi, sha256 {sha256(blob)[:12]}; encode call launched {scan} "
          f"x{nenc}, place x{nenc}; decode call {dec} x{ndec} "
          f"({', '.join(pd.engines)}); e2e (host clock, host data) encode "
          f"{e2e_enc:.3f} s ({stage_enc:.3f} s of it the model and "
          f"staging), decode {e2e_dec:.3f} s ({stage_dec:.3f} s staging); "
          f"prepared encode {n / enc_ms / 1e3:.1f}M ints/s ({enc_ms:.3f} "
          f"ms), prepared decode {n / dec_ms / 1e3:.1f}M ints/s "
          f"({dec_ms:.3f} ms); the {len(one_stream)} blocks as one-stream "
          f"decodes, one launch each: {one_ms:.3f} ms ({one_ms / dec_ms:.1f}x "
          f"the batched decode)")
    torch.cuda.empty_cache()
    return {"kernels": res, "enc_ms": enc_ms, "dec_ms": dec_ms,
            "one_stream_ms": one_ms, "e2e_enc": e2e_enc,
            "e2e_dec": e2e_dec, "stage_enc": stage_enc,
            "stage_dec": stage_dec, "blocks": -(-n // PSEUDO_BLOCK),
            "bytes": len(blob)}


def check_native(card: str) -> dict:
    """The host library against its plain versions (the host modules'
    `_native` set to None) on one zipf20 block of PSEUDO_BLOCK values:
    each step's output byte for byte, and its time both ways."""
    from ans_tpu_torch.inputs import zipf20_input
    from ans_tpu_torch.reference_model import (interp, model, rans_compat,
                                               vbyte)
    mods = (model, interp, rans_compat)
    x = zipf20_input(PSEUDO_BLOCK)
    freqs = np.bincount(x).astype(np.uint64)
    nf = model.adjust_freqs(freqs, int(x.max()), False)
    M = int(nf.sum())
    prelude = model.serialize_prelude(nf, M)
    at = 8 * (len(vbyte.encode_u32(len(nf) - 1)) + 1)
    ans, fold = rans_compat.AnsInt(), rans_compat.AnsFold(2)
    blobs = {"ANS": ans.encode(x), "ANSfold-2": fold.encode(x)}
    steps = {
        "adjust_freqs": lambda: model.adjust_freqs(
            freqs, int(x.max()), False).tobytes(),
        "serialize_prelude": lambda: model.serialize_prelude(nf, M),
        "interp.decode": lambda: np.asarray(interp.decode(
            prelude, len(nf), M + len(nf) + 1, bit_offset=at)[0],
            np.uint64).tobytes(),
        "compat ANS encode": lambda: ans.encode(x),
        "compat ANS decode": lambda: ans.decode(blobs["ANS"],
                                                len(x)).tobytes(),
        "compat ANSfold-2 encode": lambda: fold.encode(x),
        "compat ANSfold-2 decode": lambda: fold.decode(
            blobs["ANSfold-2"], len(x)).tobytes()}
    require(np.frombuffer(steps["compat ANS decode"](), np.uint32).tolist()
            == x.tolist() and np.array_equal(np.frombuffer(
                steps["compat ANSfold-2 decode"](), np.uint32), x),
            "the compat engine on the host library does not round-trip")
    res = {}
    for name, fn in steps.items():
        out = {}
        for plain in (False, True):
            saved = [m._native for m in mods]
            if plain:
                for m in mods:
                    m._native = None
            try:
                t0 = time.perf_counter()
                got = fn()
                out[plain] = (got, time.perf_counter() - t0)
            finally:
                for m, lib in zip(mods, saved):
                    m._native = lib
        require(out[False][0] == out[True][0],
                f"host library: {name} differs from its plain version")
        res[name] = {"native_s": out[False][1], "plain_s": out[True][1]}
        print(f"{card} host library == plain, {name} on a zipf20 block of "
              f"{PSEUDO_BLOCK}: {len(out[False][0])} bytes equal; native "
              f"{out[False][1]:.4f} s, plain {out[True][1]:.4f} s "
              f"({out[True][1] / out[False][1]:.1f}x)")
    return res


def run_cli(card: str, full: np.ndarray, rec: dict, z20: np.ndarray,
            brec: dict) -> dict:
    """`python -m ans_tpu_torch` through its main() on the card at full
    width: the ATFC file of the main path, the blocked container and the
    compat engine; files, launches and times as the module docstring says
    (phase 12)."""
    from ans_tpu_torch import container
    from ans_tpu_torch.__main__ import main as cli
    from ans_tpu_torch.inputs import zipf20_input
    res = {}

    def timed(what: str, *argv) -> float:
        t0 = time.perf_counter()
        require(cli([*argv]) == 0, f"the CLI's {what} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, atfc, dst = tmp / "bench.u32", tmp / "bench.atfc", tmp / "out.u32"
        full.astype("<u4").tofile(src)
        reset_launches()
        tc = timed("compress", "compress", str(src), str(atfc), "--device",
                   DEVICE)
        timed("info", "info", str(atfc))
        td = timed("decompress", "decompress", str(atfc), str(dst),
                   "--device", DEVICE)
        launches = read_launches()
        require_launched("the CLI on the main path", launches,
                         ("encode_scan", "place", "decode_direct"))
        method, engine, n, blob = container.unpack(atfc.read_bytes())
        require((method, engine, n) == ("ANSfold-2", "lane", len(full))
                and len(blob) == rec["blob_len"]
                and sha256(blob) == rec["blob_sha256"],
                "the CLI's ATFC payload differs from fullwidth.json's blob")
        require(np.array_equal(np.fromfile(dst, dtype="<u4"), full),
                "the CLI's decompressed file differs from its input")
        res["main"] = {"compress_s": tc, "decompress_s": td,
                       "launches": launches}
        print(f"{card} python -m ans_tpu_torch compress / info / decompress, "
              f"ANSfold-2 on bench.py's input, n=2^25: ATFC payload sha256 "
              f"{sha256(blob)[:12]} equal to fullwidth.json's, output file "
              f"equal to the input; compress {tc:.3f} s, decompress "
              f"{td:.3f} s (host clock, files on disk); launched "
              + ", ".join(f"{k} x{launches[k]}" for k in (
                  "encode_scan", "place", "decode_direct")))

        src, atfb = tmp / "zipf20.u32", tmp / "zipf20.atfb"
        z20.astype("<u4").tofile(src)
        reset_launches()
        tc = timed("blocked compress", "compress", str(src), str(atfb),
                   "--blocked", "-D", str(CLI_BLOCK_D), "-S",
                   str(FULL_LANES), "--device", DEVICE)
        timed("blocked info", "info", str(atfb))
        td = timed("blocked decompress", "decompress", str(atfb), str(dst),
                   "--device", DEVICE)
        launches = read_launches()
        require_launched("the blocked CLI", launches,
                         ("encode_scan", "place", "decode_direct"))
        out = atfb.read_bytes()
        require(len(out) == brec["blob_len"]
                and sha256(out) == brec["blob_sha256"],
                "the CLI's ATFB file differs from fullwidth_blocked.json")
        require(np.array_equal(np.fromfile(dst, dtype="<u4"), z20),
                "the blocked CLI's decompressed file differs from its input")
        res["blocked"] = {"compress_s": tc, "decompress_s": td,
                          "launches": launches}
        print(f"{card} python -m ans_tpu_torch --blocked -D {CLI_BLOCK_D} "
              f"-S {FULL_LANES}, zipf20, n=2^25: file equal to "
              f"fullwidth_blocked.json's, decompressed exactly; compress "
              f"{tc:.3f} s, decompress {td:.3f} s; launched "
              + ", ".join(f"{k} x{launches[k]}" for k in (
                  "encode_scan", "place", "decode_direct")))

        x = zipf20_input(CLI_COMPAT_N)
        src, out = tmp / "small.u32", tmp / "small.atfc"
        x.astype("<u4").tofile(src)
        reset_launches()
        tc = timed("compat compress", "compress", str(src), str(out), "-m",
                   "ANSfold-2", "--engine", "compat", "--device", DEVICE)
        td = timed("compat decompress", "decompress", str(out), str(dst),
                   "--device", DEVICE)
        launches = read_launches()
        require(not any(launches.values()),
                f"the compat engine launched kernels: {launches}")
        require(container.unpack(out.read_bytes())[:3]
                == ("ANSfold-2", "compat", len(x))
                and np.array_equal(np.fromfile(dst, dtype="<u4"), x),
                "the compat CLI's decompressed file differs from its input")
        res["compat"] = {"compress_s": tc, "decompress_s": td}
        print(f"{card} python -m ans_tpu_torch -m ANSfold-2 --engine compat, "
              f"zipf20, n=2^20: {out.stat().st_size} bytes, "
              f"{8 * out.stat().st_size / len(x):.4f} bpi, decompressed "
              f"exactly; compress {tc:.3f} s, decompress {td:.3f} s on the "
              f"host, no kernel launched")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from ans_tpu_torch.csrc import build
    from ans_tpu_torch.inputs import (bench_input, dense_input,
                                      zipf20_input, zipf125_input)
    from ans_tpu_torch.models.ans import AnsFold, AnsInt
    from ans_tpu_torch.models.bytes import AnsByte, Vbyte

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
    t_start = time.perf_counter()

    # 1. build
    build.load_all(tuple(KERNELS))
    print(f"build: {time.perf_counter() - t_start:.1f} s for {len(KERNELS)} "
          f"kernels in parallel ({build.NVCC_FLAGS[0]})")
    from ans_tpu_torch import native
    from ans_tpu_torch.native import build as host_build
    native.lib()
    gxx = host_build.compiler_version()
    host_s = (f"built in {host_build.build_seconds:.1f} s"
              if host_build.build_seconds is not None else "already built")
    print(f"build: host library {host_s} ({gxx}, "
          f"{' '.join(host_build.CXX_FLAGS)})")
    for name, log in build.build_log.items():
        for fn, line in ptxas_report(log):
            print(f"  {name}: {fn}: {line}")

    def on_card(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x.view(np.int32)).to(DEVICE)

    def byte_stage(x: np.ndarray, lanes: int) -> Stage:
        """AnsByte's frame over the vbyte split stream of x."""
        return Stage(AnsByte(device=DEVICE),
                     Vbyte(device=DEVICE).split(on_card(x)), lanes)

    # 2. kernels against their plain versions
    errs = {}
    for lanes, log2n in ((32, 17), (4096, 20)):
        n2 = 1 << log2n
        z20 = zipf20_input(n2)
        for what, st in (
                ("ANSfold-2", lambda: Stage(AnsFold(2, device=DEVICE),
                                            bench_input(n2, 7), lanes)),
                ("AnsByte", lambda: byte_stage(z20, lanes)),
                ("ANSfold-7", lambda: Stage(AnsFold(7, device=DEVICE), z20,
                                            lanes)),
                ("ANS (no escape)", lambda: Stage(AnsInt(device=DEVICE),
                                                  dense_input(n2), lanes)),
                ("identity frame", lambda: FrameStage(
                    identity_frame(), n2, lanes, True)),
                ("small grouped frame", lambda: FrameStage(
                    small_grouped_frame(), n2, lanes, False))):
            res = check_kernels(st(), timed=False)
            merge_errs(errs, res)
            print(f"kernels == plain, {what} at n=2^{log2n}, S={lanes}: "
                  + ", ".join(f"{k} max_abs_err {v['max_abs_err']}"
                              for k, v in res.items()))
    print(f"kernels against plain at small depth: "
          f"{time.perf_counter() - t_start:.0f} s since the start")
    rng = np.random.default_rng(9)
    mixed = rng.integers(0, 1 << 32, size=1 << 20, dtype=np.uint32) >> (
        rng.integers(0, 32, size=1 << 20).astype(np.uint32))
    res = check_bytesplit(on_card(mixed), timed=False)
    merge_errs(errs, res)
    print("kernels == plain, values of every byte length at n=2^20: "
          + ", ".join(f"{k} max_abs_err {v['max_abs_err']}"
                      for k, v in res.items()))
    res = check_place_long()
    merge_errs(errs, res)
    print(f"kernels == plain, place at S=1 over 2^16 + 5 steps, "
          f"{1 + PLACE_REPEATS} runs with the same bytes: max_abs_err "
          f"{res['place']['max_abs_err']}")
    res = check_full_block()
    merge_errs(errs, res)
    print("kernels == plain, a frame that fills the block (sigma 5500, "
          "M = 2^16) at n=2^20, S=4096: decode_direct on global loads "
          f"max_abs_err {res['decode_direct']['max_abs_err']}")
    from ans_tpu_torch.ops import decode
    for kernel, counts in decode.instance_launches.items():
        require(min(counts.values()) > 0,
                f"{kernel} did not run in both instances: {counts}")
    print(f"instances of K3 / K4 / K5 launched so far: "
          f"{decode.instance_launches}")

    # 2b. the step probe
    pres = check_probe(card)
    errs["op_probe"] = pres["max_abs_err"]

    full = bench_input(FULL_N, FULL_SEED)
    rec = find_record(LANE_FIXTURES / "fullwidth.json", "ANSfold-2", full)
    # a step's clocks over the SM's top clock (the event time of the probe's
    # short launch is mostly its set-up)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    step_ns = pres["encode_step_clocks"] * 1e3 / mhz
    print(f"{card} chain bound of a scan step: "
          f"{pres['encode_step_clocks']:.1f} clocks at {mhz:.0f} MHz = "
          f"{step_ns:.2f} ns")
    kres = check_kernels(Stage(AnsFold(2, device=DEVICE), full, FULL_LANES),
                         timed=True, step_ns=step_ns)
    merge_errs(errs, kres)
    print_timed(card, "the main path, n=2^25, S=4096", kres)
    torch.cuda.synchronize()

    # 3. golden fixtures
    print(f"golden fixtures: {check_fixtures()} blobs re-encoded and "
          f"decoded exactly")
    torch.cuda.synchronize()

    # 4. the main path at full width, through the user's entry points: the
    # rule takes its decode to K4; K3 runs forced
    main_run = run_codec(card, "ANSfold-2", full, rec, "search", "direct",
                         also="search")
    del full

    # 5. the grouped path at full width: ANSfold-7 on zipf20
    z20 = zipf20_input(FULL_N)
    zrec = LANE_FIXTURES / "fullwidth_zipf20.json"
    grouped_run = run_codec(card, "ANSfold-7", z20,
                            find_record(zrec, "ANSfold-7", z20), "grouped",
                            "grouped")
    gres = check_kernels(Stage(AnsFold(7, device=DEVICE), z20, FULL_LANES),
                         timed=True, step_ns=step_ns)
    merge_errs(errs, gres)
    print_timed(card, "ANSfold-7, zipf20, n=2^25, S=4096", gres)

    # 6. ANS on zipf20: the tail escape onto the pivot search (depth 13,
    # NR = 3, one exception round; M = 2^22 is far past K4's tables)
    run_codec(card, "ANS", z20, find_record(zrec, "ANS", z20), "search",
              "search")
    ares = check_kernels(Stage(AnsInt(device=DEVICE), z20, FULL_LANES),
                         timed=True, step_ns=step_ns)
    merge_errs(errs, ares)
    print_timed(card, "ANS, zipf20, n=2^25, S=4096", ares)

    # 7. ANS without the escape: K6 on ranks, K5 with a value table
    dense = dense_input(DENSE_N)
    run_codec(card, "ANS", dense, find_record(zrec, "ANS", dense), "grouped",
              "grouped")
    dres = check_kernels(Stage(AnsInt(device=DEVICE), dense, FULL_LANES),
                         timed=True, step_ns=step_ns)
    merge_errs(errs, dres)
    print_timed(card, "ANS, dense22, n=2^22, S=4096", dres)
    del dense

    # 8. the byte path at full width: vbyteANS and streamvbyteANS on zipf20
    brec = LANE_FIXTURES / "fullwidth_bytes.json"
    byte_run = run_byte_codec(card, "vbyteANS", z20, brec)
    svb_run = run_byte_codec(card, "streamvbyteANS", z20, brec)
    from ans_tpu_torch.ops import bytesplit
    ptxas = "; ".join(line for _, line in ptxas_report(
        build.build_log.get("svb_decode", "")))
    print(f"svb_decode at n=2^25: {bytesplit.svb_chunks(FULL_N)} chunks of "
          f"{bytesplit.SVB_CHUNK} elements, one launch; ptxas: "
          f"{ptxas or 'not rebuilt by this process'}")
    sres = check_bytesplit(on_card(z20), timed=True)
    merge_errs(errs, sres)
    print_timed(card, "the byte path, zipf20, n=2^25", sres)
    print(f"{card} bytesplit_encode, streamvbyte format, same input: "
          f"kernel {sres['bytesplit_encode']['svb_ms']:.3f} ms")
    print(f"{card} the byte path's kernels against their byte bounds, "
          f"{1 + BYTE_REPEATS} runs of K7, K8 and K9 with the same output: "
          + ", ".join(f"{k} {r['bound_ms'] / r['ms']:.1%} of its bound "
                      f"({r['bound_ms']:.4f} of {r['ms']:.3f} ms)"
                      for k, r in sres.items()))
    bres = check_kernels(byte_stage(z20, FULL_LANES), timed=True,
                         plain_search=False, step_ns=step_ns)
    merge_errs(errs, bres)
    print_timed(card, "AnsByte on the vbyte stream of zipf20, S=4096", bres)

    # 9. ANSmsb and ANSrfold-2 at full width on zipf20 (no K6: an msb
    # alphabet has at most 1280 symbols, rfold-2's 1036 here)
    for name in ("ANSmsb", "ANSrfold-2"):
        run_codec(card, name, z20, find_record(zrec, name, z20), "search",
                  "direct")
    torch.cuda.synchronize()

    # 10. the blocked container at full width: D = 32 sections, one batch
    # a kernel
    print(f"golden containers: {check_golden_container()} re-encoded and "
          f"decoded exactly")
    from ans_tpu_torch.parallel import BlockCodec
    blk = LANE_FIXTURES / "fullwidth_blocked.json"
    block_res, blocked = {}, {}
    for name in ("ANSfold-2", "ANSfold-7"):
        blocked[name] = run_blocked(card, name, z20, BLOCK_D,
                                    find_record(blk, name, z20))
        block_res[name] = check_batched(
            BlockCodec(name, BLOCK_D, FULL_LANES, device=DEVICE), z20,
            step_ns=step_ns)
        merge_errs(errs, block_res[name])
        print_batched(card, f"{name} in {BLOCK_D} sections, zipf20, n=2^25",
                      block_res[name])
        enc1, dec1, eng1 = one_stream_times(name, z20)
        print(f"{card} {name} on zipf20, n=2^25, as one stream: prepared "
              f"encode {enc1:.3f} ms, decode ({eng1}) {dec1:.3f} ms; in "
              f"{BLOCK_D} sections {blocked[name]['enc_ms']:.3f} / "
              f"{blocked[name]['dec_ms']:.3f} ms: decode "
              f"{dec1 / blocked[name]['dec_ms']:.1f}x as fast")
    run_blocked(card, "ANSfold-2", z20, BLOCK_D_WIDE, None)
    wres = check_batched(BlockCodec("ANSfold-2", BLOCK_D_WIDE, FULL_LANES,
                                    device=DEVICE), z20, step_ns=step_ns)
    merge_errs(errs, wres)
    print_batched(card, f"ANSfold-2 in {BLOCK_D_WIDE} sections, zipf20, "
                        f"n=2^25", wres)

    # 11. pseudo-adaptive (ATFP) at full width: 256 blocks of 2^17 values,
    # S = 32, each block its own model, one launch a kernel a batch
    print(f"golden ATFP containers: {check_golden_pseudo()} re-encoded and "
          f"decoded exactly")
    pseudo, cells = {}, {"zipf20": z20}
    for data, pkind, scan, dec in PSEUDO_CELLS:
        if data not in cells:
            cells[data] = zipf125_input(FULL_N)
        r = run_pseudo(card, data, pkind, cells[data], scan, dec, step_ns)
        pseudo[f"{data} {pkind}"] = r
        merge_errs(errs, r["kernels"])
        for kname, k in r["kernels"].items():
            chain = (f", chain bound {k['chain_bound_ms']:.4f} ms"
                     if "chain_bound_ms" in k else "")
            print(f"{card} {kname}, pseudo_adaptive {pkind} on {data} "
                  f"(blocks of {PSEUDO_BLOCK}, a model each), "
                  f"{k['launches']} launch(es): {k['ms']:.3f} ms, plain "
                  f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms by "
                  f"{k['bound_by']}{chain}, max_abs_err {k['max_abs_err']}")
    del cells

    # 12. the host layer and the user's entry point
    print(f"host library: {gxx}, {host_s} in phase 1")
    check_native(card)
    for cell, r in pseudo.items():
        print(f"{card} ATFP {cell} on the host library, n=2^25, {r['blocks']} "
              f"blocks: e2e encode {r['e2e_enc']:.3f} s (staging "
              f"{r['stage_enc']:.3f} s, {r['stage_enc'] / r['blocks']:.4f} s "
              f"a block), decode {r['e2e_dec']:.3f} s (staging "
              f"{r['stage_dec']:.3f} s, {r['stage_dec'] / r['blocks']:.4f} s "
              f"a block); e2e encode on the pure-Python host code, before "
              f"the library: {PLAIN_ATFP_ENCODE_S} s")
    full = bench_input(FULL_N, FULL_SEED)
    cli_res = run_cli(card, full, rec, z20,
                      find_record(blk, "ANSfold-2", z20))
    del full, z20

    launches = {name: main_run["launches"][name]
                for name in ("encode_scan", "place", "decode_search")}
    launches.update({name: grouped_run["launches"][name] for name in
                     ("encode_scan_grouped", "decode_grouped")})
    launches.update({name: byte_run["launches"][name] for name in
                     ("decode_direct", "bytesplit_encode", "vbyte_decode")})
    launches["svb_decode"] = svb_run["launches"]["svb_decode"]
    launches["op_probe"] = pres["launches"]
    # each kernel at its own path's shapes: K1-K3 the main path's, K4
    # AnsByte's, K5/K6 the grouped path's, K7-K9 the byte path's
    timed = {**gres, **sres, **bres, "op_probe": pres, **{k: kres[k] for k in (
        "encode_scan", "place", "decode_search")}}
    print(f"{card} decode_direct at the main path's shapes: "
          f"{kres['decode_direct']['ms']:.3f} ms against decode_search "
          f"{kres['decode_search']['ms']:.3f} ms")
    # each lane kernel's batched launch: ms and bound at D = 32 (ANSfold-2
    # for K1-K4, ANSfold-7 for K5/K6 and K2) and D = 128 (ANSfold-2), and
    # its launches in phase 10's encode and decode calls
    batched = {}
    for D, res in ((BLOCK_D, {**block_res["ANSfold-7"],
                              **block_res["ANSfold-2"]}),
                   (BLOCK_D_WIDE, wres)):
        for name, r in res.items():
            batched.setdefault(name, {})[f"D={D}"] = {
                k: r[k] for k in ("ms", "plain_ms", "max_abs_err",
                                  "bound_ms", "bound_by", "chain_bound_ms")
                if k in r}
    for name in batched:
        batched[name]["launches"] = sum(
            run[key][name] for run in blocked.values()
            for key in ("enc_launches", "dec_launches"))
    # each path kernel's launches on a model a stream: ms and bound at
    # D = 256 blocks, S = 32, T = 4096, by cell
    per_model = {}
    for cell, run in pseudo.items():
        for name, r in run["kernels"].items():
            per_model.setdefault(name, {})[cell] = {
                k: r[k] for k in ("ms", "plain_ms", "max_abs_err",
                                  "bound_ms", "bound_by", "chain_bound_ms",
                                  "launches") if k in r}
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"],
         "bound_by": timed[name]["bound_by"], "library_ms": None,
         **({"chain_bound_ms": timed[name]["chain_bound_ms"]}
            if "chain_bound_ms" in timed[name] else {}),
         **({"batched": batched[name]} if name in batched else {}),
         **({"pseudo": per_model[name]} if name in per_model else {}),
         **({"cli_launches": sum(cli_res[run]["launches"][name]
                                 for run in ("main", "blocked"))}
            if name in ("encode_scan", "place", "decode_direct") else {}),
         **({"note": "a probe: its work is the latency it measures, so it "
                     "has no work bound; no PyTorch call computes a "
                     "dependency chain of one primitive"}
            if name == "op_probe" else {})}
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
