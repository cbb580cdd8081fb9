"""The card's step probe (csrc/op_probe.cu): how long one primitive of the
kernels takes when each op needs the last one's result.

    python3 -m ans_tpu_torch.probe [--iters N] [--device cpu] [--out FILE]

Replaces tools/mosaic_probe.py (`_mk` / `run`): a serial dependency chain
of one primitive, ITERS * UNROLL deep, timed per op.  The chains are the
primitives csrc/*.cu are built from (CHAINS below), not the TPU's rolls
and row lookups; each runs in one block of 32 threads (one warp) and of
1024 (the block shape of the lockstep decodes).  Every chain has a plain
PyTorch version here, the same recurrence in int64 tensor ops, giving the
same final values: `run` takes it for CPU tensors and launches the kernel
for CUDA tensors; `run_kernel` raises on anything else.

The command prints one line per chain and block shape, ns/op from CUDA
events (min of 3 after a warm-up) and clocks/op from the SM's clock
register read inside the kernel, with the card's name and power limit,
then one JSON object.  With --device cpu it runs the plain chains at a
small depth and prints their checksums: a check of the recurrences, not a
measurement.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes as ct
import json
import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .csrc import build
from .ops import lane_codec, tables

UNROLL = 16
MASK = 0xFFFFFFFF
GOLD = 2654435761
SIGMA, LOG2M = 1546, 15     # K4's tables on the ANSfold-2 main path: 89 KB
TAB = 4096
G_SIGMA, G_LOG2M = 20000, 17    # a grouped frame the size of ANSfold-7's on
                                # 2^20-value data: K5's tables, 92 KB
ENC_ROWS = 4096                 # rows of the encode chain's tile, 64 KB

# launches of the probe kernel (never counts a plain chain)
launches = 0


@dataclass(frozen=True)
class Chain:
    index: int      # the kernel's `chain` argument
    kind: str       # "scalar", "scan", "read", "encode" or "group"
    p0: int = 0
    p1: int = 0
    what: str = ""


CHAINS = {
    "add": Chain(0, "scalar", 3, 0, "v += k"),
    "cmp_select": Chain(1, "scalar", 1000003, 7919,
                        "v = v >= c ? v - c : v + d"),
    "shift_or": Chain(2, "scalar", 0x40000000, 0, "v = (v >> 1) | k"),
    "umulhi": Chain(3, "scalar", 0x9E3779B1, 0x12345679,
                    "v = __umulhi(v, m) + k (the encode's divide)"),
    "shfl_up": Chain(4, "scalar", what="__shfl_up_sync by one lane, + 1"),
    "ballot_popc": Chain(5, "scalar",
                         what="__ballot_sync + __popc(mask & lanemask_lt)"),
    "redux_add": Chain(15, "scalar",
                       what="__reduce_add_sync over the warp"),
    "smem_load": Chain(6, "scalar",
                       what="dependent shared-memory load, 16 KB table"),
    "lookup2": Chain(7, "scalar", what="K4's lookup: u16 slot -> 16-byte "
                                       "row, 89 KB in shared memory"),
    "syncthreads": Chain(8, "scalar", what="__syncthreads()"),
    "gload_l2": Chain(9, "scalar", what="dependent 1-byte global load, "
                                        "buffer inside L2"),
    "gload_dram": Chain(9, "scalar", what="dependent 1-byte global load, "
                                          "buffer far past L2"),
    "scan_old": Chain(10, "scan", what="lane::block_exclusive_scan, six "
                                       "rounds, two barriers"),
    "scan_new": Chain(11, "scan", what="lockstep's packed scan, six rounds, "
                                       "one barrier"),
    "read_old": Chain(12, "read", what="the byte read before lockstep.cuh: "
                                       "six scans + conditional global "
                                       "byte loads"),
    "read_global": Chain(13, "read", what="lockstep::read_step on global "
                                          "loads"),
    "read_ring": Chain(14, "read", what="lockstep::read_step through the "
                                        "shared-memory ring"),
    "encode_step": Chain(16, "encode", what="K6's state chain: "
                                            "lane::encode_step, its row in "
                                            "a shared-memory tile"),
    "group_search": Chain(17, "group", what="K5's lookup: bucket, probes, "
                                            "group row, divide, per-rank "
                                            "table, 92 KB in shared memory"),
}


def lanes_per_thread(threads: int) -> int:
    """Lanes a thread owns in the "read" chains: 4 at 1024 threads (the
    main path's S = 4096), else 1."""
    return 4 if threads == 1024 else 1


@dataclass(frozen=True)
class Inputs:
    """What the chains read: tab (4096,) i32; slot_sym (2^log2m,) i16
    holding u16 indices below sigma; rows (sigma, 4) i32; buf (a power of
    two,) u8, the global buffer of "gload_*" and the stream of "read_*";
    grouped: K5's tables of a frequency-grouped frame with a value table
    ("group_search"); enc_rows (ENC_ROWS, 4) i32 rows [f, base, magic, 0]
    of symbols drawn from that frame ("encode_step")."""

    tab: torch.Tensor
    slot_sym: torch.Tensor
    rows: torch.Tensor
    buf: torch.Tensor
    grouped: tables.GroupedDecDevice
    enc_rows: torch.Tensor
    sigma: int = SIGMA
    log2m: int = LOG2M


def make_inputs(device, buf_bytes: int, seed: int = 0) -> Inputs:
    """Random tables from `seed` (numpy); the buffer is drawn on the
    device when it is large."""
    if buf_bytes & (buf_bytes - 1) or buf_bytes < 1:
        raise ValueError("buf_bytes must be a power of two")
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    tab = rng.integers(0, 1 << 32, size=TAB, dtype=np.uint32)
    slot = rng.integers(0, SIGMA, size=1 << LOG2M).astype(np.uint16)
    rows = rng.integers(0, 1 << 32, size=(SIGMA, 4), dtype=np.uint32)
    if buf_bytes <= 1 << 24:
        buf = torch.from_numpy(
            rng.integers(0, 256, size=buf_bytes, dtype=np.uint8)).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        buf = torch.randint(0, 256, (buf_bytes,), dtype=torch.uint8,
                            device=dev, generator=gen)
    # Zipf(1) frequencies over G_SIGMA symbols in no order, summing to
    # 2^G_LOG2M: a value table, a few hundred groups
    w = 1.0 / np.arange(1, G_SIGMA + 1)
    nf = 1 + np.floor(((1 << G_LOG2M) - G_SIGMA) * w / w.sum()).astype(
        np.int64)
    nf[0] += (1 << G_LOG2M) - int(nf.sum())
    nf = rng.permutation(nf).astype(np.uint64)
    enc = tables.to_device(tables.build_enc_table(nf), dev)
    syms = rng.choice(G_SIGMA, size=ENC_ROWS, p=nf / nf.sum())
    return Inputs(tab=torch.from_numpy(tab.view(np.int32)).to(dev),
                  slot_sym=torch.from_numpy(slot.view(np.int16)).to(dev),
                  rows=torch.from_numpy(rows.view(np.int32)).to(dev),
                  buf=buf,
                  grouped=tables.to_device(tables.build_grouped_table(nf),
                                           dev),
                  enc_rows=enc.words[torch.from_numpy(syms).to(dev)]
                  .contiguous())


def make_x(name: str, threads: int, device, seed: int = 1) -> torch.Tensor:
    """The chain's start values, (threads,) i32 or (threads * LPT,) for a
    "read" chain, from `seed`."""
    n = threads * (lanes_per_thread(threads)
                   if CHAINS[name].kind == "read" else 1)
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=n,
                                             dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _check(name: str, x: torch.Tensor, iters: int, inp: Inputs) -> int:
    """Validate a call; returns the block's thread count."""
    if name not in CHAINS:
        raise ValueError(f"unknown chain {name!r}; have {sorted(CHAINS)}")
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError("probe: x must be a 1-d int32 tensor")
    if iters < 0:
        raise ValueError("probe: iters must not be negative")
    threads = x.numel()
    if CHAINS[name].kind == "read":
        threads = 1024 if x.numel() == 4096 else x.numel()
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"probe: {x.numel()} values do not make a block "
                         f"of 32..1024 threads (a multiple of 32)")
    if inp.tab.shape != (TAB,) or inp.rows.shape != (inp.sigma, 4) \
            or inp.slot_sym.shape != (1 << inp.log2m,):
        raise ValueError("probe: table shapes do not match")
    if (inp.tab.dtype, inp.rows.dtype, inp.slot_sym.dtype) != (
            torch.int32, torch.int32, torch.int16):
        raise ValueError("probe: tab and rows must be int32, slot_sym int16")
    if inp.buf.dtype != torch.uint8 or inp.buf.dim() != 1 \
            or inp.buf.numel() & (inp.buf.numel() - 1):
        raise ValueError("probe: buf must be a 1-d uint8 tensor, a power "
                         "of two long")
    g = inp.grouped
    if g.table.numel() != g.sigma or g.NE or g.log2m != G_LOG2M:
        raise ValueError("probe: the grouped frame needs a value table, no "
                         f"exception bytes and 2^{G_LOG2M} slots")
    if inp.enc_rows.shape != (ENC_ROWS, 4) \
            or inp.enc_rows.dtype != torch.int32:
        raise ValueError(f"probe: enc_rows must be ({ENC_ROWS}, 4) int32")
    if CHAINS[name].kind == "read" \
            and iters * UNROLL * x.numel() * 6 > inp.buf.numel():
        raise ValueError(
            f"probe: {iters * UNROLL} steps of {x.numel()} lanes may read "
            f"{iters * UNROLL * x.numel() * 6} bytes; buf holds "
            f"{inp.buf.numel()}")
    return threads


# --------------------------------------------------------------------------
# the plain chains
# --------------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & MASK


def _excl(c: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(c, dim) - c


def _scalar_op(c: Chain, v: torch.Tensor, inp: dict) -> torch.Tensor:
    i = c.index
    if i == 0:
        return (v + c.p0) & MASK
    if i == 1:
        return torch.where(v >= c.p0, v - c.p0, (v + c.p1) & MASK)
    if i == 2:
        return (v >> 1) | c.p0
    if i == 3:
        # the high word of v * p0, in halves (the product passes 2^63)
        hi = ((v >> 16) * c.p0 + (((v & 0xFFFF) * c.p0) >> 16)) >> 16
        return (hi + c.p1) & MASK
    if i == 4:
        w = v.view(-1, 32)
        y = torch.cat([w[:, :1], w[:, :-1]], dim=1)
        return ((y + 1) & MASK).reshape(-1)
    if i == 5:
        return ((v.view(-1, 32) + _excl(v.view(-1, 32) & 1, 1)) & MASK
                ).reshape(-1)
    if i == 6:
        return inp["tab"][v & (TAB - 1)]
    if i == 7:
        log2m = inp["log2m"]
        slot = v & ((1 << log2m) - 1)
        e = inp["rows"][inp["slot_sym"][slot]]
        return (e[:, 0] * (v >> log2m) + slot - e[:, 1] + e[:, 2]) & MASK
    if i == 8:
        return (v + 1) & MASK
    if i == 15:
        w = v.view(-1, 32)
        return ((w + (w & 3).sum(1, keepdim=True)) & MASK).reshape(-1)
    buf = inp["buf"]
    return ((v + buf[v & (buf.numel() - 1)].to(torch.int64)) * GOLD
            + 12345) & MASK


def _scan_op(v: torch.Tensor) -> torch.Tensor:
    """Six rounds of counts (v >> 2r) & 3: the sum over the rounds of this
    thread's byte offset from the cursor, plus the step's total."""
    cnt = (v[:, None] >> (2 * torch.arange(6, device=v.device))) & 3
    tot = cnt.sum(0)
    offs = _excl(tot) + _excl(cnt)
    return (v * 1664525 + 1 + offs.sum(1) + tot.sum()) & MASK


def _read_op(v: torch.Tensor, cursor: int, buf: torch.Tensor):
    """One lockstep byte read over the lanes v, in lane order: rc = v & 3
    renorm bytes into the state, ne = (v >> 2) & 3 exception bytes into
    low, both high-first; a read past the end of buf gives 0."""
    rc, ne = v & 3, (v >> 2) & 3
    st, lo = v, torch.zeros_like(v)
    L = buf.numel()
    for j in range(6):
        need = (rc > j) if j < 3 else (ne > j - 3)
        pos = cursor + _excl(need.to(torch.int64))
        byte = torch.where(need & (pos < L),
                           buf[pos.clamp(max=L - 1)].to(torch.int64), 0)
        if j < 3:
            st = torch.where(need, ((st << 8) | byte) & MASK, st)
        else:
            lo = torch.where(need, (lo << 8) | byte, lo)
        cursor += int(need.sum())
    return ((st ^ lo) * GOLD + 1) & MASK, cursor


def _encode_chain(x: torch.Tensor, steps: int,
                  inp: Inputs) -> torch.Tensor:
    """K6's state chain: the state starts at A_L | x & (A_L - 1); step i of
    thread k takes row (k + i * threads) mod ENC_ROWS through
    lane::encode_step; the state plus the sum of the packed words."""
    rows = _u32(inp.enc_rows)
    log2m = inp.grouped.log2m
    k = torch.arange(x.numel(), device=x.device)
    st = tables.A_L | (_u32(x) & (tables.A_L - 1))
    words = torch.zeros_like(st)
    for i in range(steps):
        r = rows[(k + i * x.numel()) & (ENC_ROWS - 1)]
        f, base = r[:, 0], r[:, 1]
        ub = f << (31 - log2m)
        word = torch.zeros_like(st)
        for j in range(3):
            e = st >= ub
            word |= (st & 0xFF) << (8 * j)
            word += e.to(torch.int64) << 24
            st = torch.where(e, st >> 8, st)
        q = st // f
        st = (q << log2m) + (st - q * f) + base
        words = (words + word) & MASK
    return (st + words) & MASK


def _group_op(v: torch.Tensor, g: tables.GroupedDecDevice) -> torch.Tensor:
    """K5's lookup: the slot's group by the kernel's short search, the
    in-group index by an exact division, the per-rank table."""
    slot = v & (g.frame_size - 1)
    row = _u32(g.groups)[lane_codec.bucket_search(g, slot)]
    f = row[:, 0]
    x = slot - row[:, 2]
    j = x // f
    s0 = f * (v >> g.log2m) + x - j * f
    return ((s0 ^ _u32(g.table)[row[:, 3] + j]) * GOLD + 1) & MASK


def run_plain(name: str, x: torch.Tensor, iters: int,
              inp: Inputs) -> torch.Tensor:
    """The chain's final values by plain tensor ops, on x's device:
    iters * UNROLL applications of the recurrence, in int64."""
    _check(name, x, iters, inp)
    c = CHAINS[name]
    v = _u32(x)
    tabs = {"tab": _u32(inp.tab), "rows": _u32(inp.rows),
            "slot_sym": inp.slot_sym.to(torch.int64) & 0xFFFF,
            "log2m": inp.log2m, "buf": inp.buf}
    cursor = 0
    if c.kind == "encode":
        v = _encode_chain(x, iters * UNROLL, inp)
    for _ in range(0 if c.kind == "encode" else iters * UNROLL):
        if c.kind == "group":
            v = _group_op(v, inp.grouped)
        elif c.kind == "scalar":
            v = _scalar_op(c, v, tabs)
        elif c.kind == "scan":
            v = _scan_op(v)
        else:
            v, cursor = _read_op(v, cursor, inp.buf)
    return ((v ^ (1 << 31)) - (1 << 31)).to(torch.int32)  # u32 bits as i32


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_ARGTYPES = [ct.c_int, ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p,
             ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
             ct.c_void_p, ct.c_int64, ct.c_uint, ct.c_uint, ct.c_int,
             ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
             ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_void_p,
             ct.c_int, ct.c_int, ct.c_void_p]


def _launch(name: str, x: torch.Tensor, iters: int, inp: Inputs):
    """Launch the kernel without waiting for it: (final values, (3,) i64
    clock before, clock after, read-past-the-end flag)."""
    global launches
    threads = _check(name, x, iters, inp)
    g = inp.grouped
    dev = build.require_cuda("op_probe", x, inp.tab, inp.slot_sym, inp.rows,
                             inp.buf, g.groups, g.bases, g.buckets, g.table,
                             inp.enc_rows)
    c = CHAINS[name]
    out = torch.empty_like(x)
    cycles = torch.zeros(3, dtype=torch.int64, device=dev)
    ring = 0
    if name == "read_ring":
        from .ops.decode import ring_bytes
        ring = ring_bytes(x.numel(), 6)
    fn = build.function("op_probe", _ARGTYPES)
    build.check("op_probe", fn(
        c.index, threads, iters, build.ptr(x), build.ptr(out),
        build.ptr(inp.tab), build.ptr(inp.slot_sym), build.ptr(inp.rows),
        inp.sigma, inp.log2m, build.ptr(inp.buf), inp.buf.numel(), c.p0,
        c.p1, ring, build.ptr(cycles), build.ptr(g.groups),
        build.ptr(g.bases), build.ptr(g.buckets), build.ptr(g.table),
        g.groups.shape[0], g.levels, g.shift, g.sigma, g.log2m,
        build.ptr(inp.enc_rows), ENC_ROWS, g.log2m,
        build.current_stream(dev)))
    launches += 1
    return out, cycles


def run_kernel(name: str, x: torch.Tensor, iters: int, inp: Inputs):
    """Launch the probe kernel on CUDA tensors; returns (final values,
    SM clocks the loop took).  Raises ValueError for tensors elsewhere."""
    out, cycles = _launch(name, x, iters, inp)
    t0, t1, bad = cycles.tolist()
    if bad:
        raise ValueError(f"probe: chain {name} read past the end of buf")
    return out, t1 - t0


def run(name: str, x: torch.Tensor, iters: int, inp: Inputs) -> torch.Tensor:
    """The chain's final values: CPU tensors run the plain chain, CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return run_plain(name, x, iters, inp)
    return run_kernel(name, x, iters, inp)[0]


def time_chain(name: str, threads: int, iters: int, inp: Inputs,
               runs: int = 3) -> dict:
    """ns/op (CUDA events, min of `runs` after a warm-up) and clocks/op
    (the SM clock inside the kernel, min) of one chain on the card."""
    x = make_x(name, threads, inp.buf.device)
    run_kernel(name, x, iters, inp)
    ops = iters * UNROLL
    best_ms, best_clk = float("inf"), float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, cycles = _launch(name, x, iters, inp)
        end.record()
        torch.cuda.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end))
        t0, t1, _ = cycles.tolist()
        best_clk = min(best_clk, t1 - t0)
    return {"chain": name, "threads": threads, "ops": ops,
            "ns_per_op": best_ms * 1e6 / ops, "clocks_per_op": best_clk / ops,
            "ms": best_ms}


# depth of the timed chains relative to --iters: the slow chains run fewer
DEPTH = {"scalar": 1.0, "scan": 0.25, "read": 1 / 16, "encode": 0.25,
         "group": 0.25}
SLOW = {"gload_l2": 1 / 8, "gload_dram": 1 / 8, "syncthreads": 0.25}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4000,
                    help="loop count of the fast chains (each iteration is "
                         f"{UNROLL} ops); slower chains run a fraction")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--chains", help="comma-separated chain names "
                                     "(default: all)")
    args = ap.parse_args(argv)
    names = args.chains.split(",") if args.chains else list(CHAINS)
    for name in names:
        if name not in CHAINS:
            ap.error(f"unknown chain {name!r}; have {sorted(CHAINS)}")
    if args.device == "cpu":
        inp = make_inputs("cpu", 1 << 16)
        for name in names:
            for threads in (32, 64):
                if CHAINS[name].kind == "read" and threads > 32:
                    continue
                v = run_plain(name, make_x(name, threads, "cpu"), 2, inp)
                print(f"plain {name:12s} threads={threads:3d} "
                      f"{2 * UNROLL} ops: checksum "
                      f"{int(_u32(v).sum()) & MASK:08x}")
        return 0
    if not torch.cuda.is_available():
        print("probe: no CUDA card (--device cpu runs the plain chains)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    small = make_inputs("cuda", 1 << 24)      # 16 MiB: inside L2
    large = make_inputs("cuda", 1 << 30)      # 1 GiB: far past L2
    recs = []
    for name in names:
        c = CHAINS[name]
        inp = small if name == "gload_l2" else large
        iters = max(1, int(args.iters * SLOW.get(name, DEPTH[c.kind])))
        for threads in (32, 1024):
            r = time_chain(name, threads, iters, inp)
            recs.append(r)
            print(f"[{smi}] {name:12s} threads={threads:4d}: "
                  f"{r['ns_per_op']:9.2f} ns/op {r['clocks_per_op']:9.1f} "
                  f"clocks/op over {r['ops']} ops  ({c.what})", flush=True)
    text = json.dumps({"card": smi, "unroll": UNROLL, "chains": recs})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
