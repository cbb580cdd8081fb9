"""Time the design steps of the grouped path's kernels apart, on one CUDA
card: K5 (csrc/decode_grouped.cu) and K6 (csrc/encode_scan_grouped.cu).

    python3 -m ans_tpu_torch.bench_steps [--out FILE] [--quick] [--baseline]

The sources keep one form of each kernel.  This script rebuilds the
earlier forms from them: it copies csrc/ into the build directory, applies
the textual substitutions below (each must match exactly once, so a source
that has moved on fails here and not silently), builds the copy and times
it beside the sources as they are, in one process on one card.  What needs
no other source is set through the wrappers: the instance ("global") and
the bucket level (a one-bucket table with the full search's levels).

K5, cumulative, from the step of csrc/lockstep.cuh on global loads to the
kernel as it is:
  a  the new step, global loads; the search lane after lane, full depth;
     one 4-byte store a lane
  b  a + the stream staged in the shared-memory ring
  c  b + the lanes of a thread searched level by level together
  d  c + the bucket level in front of a shorter search
  e  d + 16-byte stores: the kernel as it is
K6:
  a   one thread a lane loads 16 symbols, resolves their 16 rows into
      registers, then runs 16 chain steps; blocks of 256 lanes
  ac  a in blocks of 32 lanes
  b4  the rows resolved a tile ahead by lookup warps into shared memory
      (csrc/encode_ahead.cuh), blocks of 128 lanes, four lookup warps a
      chain warp with eight lookups in flight a thread
  b1  the same in blocks of 32 lanes
  b2 / bc  eight lookup warps a chain warp with four lookups in flight a
      thread, blocks of 64 / 32 lanes; bc is the kernel as it is
  chain alone / lookups alone  bc with the lookup warps' work, or the chain
      warp's, cut out (outputs not checked: they are wrong by design):
      which of the two halves the kernel waits for

Cells: ANSfold-7 on zipf20 (n = 2^25, S = 4096: the grouped path) and ANS on
dense22 (n = 2^22; K5's value table in global memory, K6 fed ranks).  Every
variant's output is held against the final kernel's.  Times are CUDA
events, min of 5 after a warm-up.  --baseline times only the kernels as
they are, through calls every version of the port has (to time an older
tree, copy this file into it).  Prints one line per variant with the
card's name and power limit, then one JSON object.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys

import torch

from .csrc import build
from .inputs import dense_input, zipf20_input
from .models.ans import AnsFold, AnsInt, _stage
from .ops import decode, encode, lane_codec, place, tables

RUNS = 5
DEVICE = "cuda"
LANES = 4096

# K5: the search of a thread's lanes one lane after the other
LANE_AFTER_LANE = ("decode_grouped.cu", """\
    for (int bit = (1 << levels) >> 1; bit > 0; bit >>= 1) {
#pragma unroll LANE_UNROLL
      for (int l = 0; l < LPT; ++l) {
        const int probe = m[l] + bit;
        m[l] = slot[l] >= static_cast<uint32_t>(bases[probe]) ? probe : m[l];
      }
    }
""", """\
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) {
      for (int bit = (1 << levels) >> 1; bit > 0; bit >>= 1) {
        const int probe = m[l] + bit;
        m[l] = slot[l] >= static_cast<uint32_t>(bases[probe]) ? probe : m[l];
      }
    }
""")

# K5: one 4-byte store a lane
SCALAR_STORES = ("decode_grouped.cu", """\
    if (owns) lockstep::store_lanes<LPT>(out + row, val);
""", """\
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l)
      if (owns) out[row + l] = static_cast<int32_t>(val[l]);
""")

def chain_warps(count: int):
    """K6: a block owns 32 * count lanes."""
    return ("encode_ahead.cuh", "constexpr int CHAIN_WARPS = 1;",
            f"constexpr int CHAIN_WARPS = {count};")


# K6: four lookup warps a chain warp, eight lookups in flight a thread (what
# lets a block of four chain warps stay within 1024 threads)
FOUR_LOOKUP_WARPS = [
    ("encode_ahead.cuh", "constexpr int LOOKUP_WARPS = 8;",
     "constexpr int LOOKUP_WARPS = 4;"),
    ("encode_ahead.cuh", "constexpr int LOOKUPS = 4;",
     "constexpr int LOOKUPS = 8;")]


# K6: the lookup warps resolve nothing (the chain runs on whatever the tile
# holds), or the chain warp runs nothing
NO_LOOKUPS = ("encode_ahead.cuh", """\
    } else if (tile > 0) {
      fill_tile(""", """\
    } else if (tile < 0) {
      fill_tile(""")
NO_CHAIN = ("encode_ahead.cuh", """\
      if (lane < S)
        chain_tile(""", """\
      if (lane < 0)
        chain_tile(""")


# K6: each thread resolves the rows of its own next 16 steps into registers,
# in blocks of L threads with no tile
REGISTER_ROWS = ("encode_scan_grouped.cu", """\
  ahead::scan_block(T, S, n, log2m, find, packed, states);
""", """\
  constexpr int DR = 16;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  uint32_t st = lane::A_L;
  for (int t1 = T; t1 > 0; t1 -= DR) {
    uint32_t x[DR];
    bool in[DR];
    int4 row[DR];
#pragma unroll
    for (int d = 0; d < DR; ++d) {
      const int64_t idx = static_cast<int64_t>(t1 - 1 - d) * S + lane;
      in[d] = t1 - 1 - d >= 0 && idx < n;
      x[d] = find.fetch(in[d] ? idx : 0);
    }
    find.rows(x, in, row);
#pragma unroll
    for (int d = 0; d < DR; ++d) {
      if (t1 - 1 - d < 0) break;
      const int64_t idx = static_cast<int64_t>(t1 - 1 - d) * S + lane;
      uint32_t word;
      if (in[d]) {
        word = lane::encode_step(st, static_cast<uint32_t>(row[d].x),
                                 static_cast<uint32_t>(row[d].y),
                                 static_cast<uint32_t>(row[d].z), log2m);
      } else {
        const uint32_t b = st & 0xFF;
        word = b | (b << 8) | (b << 16);
      }
      packed[idx] = static_cast<int32_t>(word);
    }
  }
  states[lane] = static_cast<int32_t>(st);
""")
REGISTER_LAUNCH = [
    ("encode_scan_grouped.cu", """\
  const int threads = ahead::THREADS;
""", """\
  const int threads = ahead::L;
"""),
    ("encode_scan_grouped.cu", """\
      16 * (size_t(ahead::TILE_ROWS) + NG) +
""", """\
      16 * size_t(NG) +
"""),
    ("encode_scan_grouped.cu", """\
  const int groups_at = ahead::TILE_ROWS;
""", """\
  const int groups_at = 0;
"""),
]


def cuda_ms(fn, runs: int = RUNS) -> float:
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


class Variant:
    """The kernels built from a copy of csrc/ with `patches` applied;
    inside the `with` block the wrappers launch that build."""

    def __init__(self, name: str, patches):
        self.name, self.patches = name, patches

    def __enter__(self):
        self.csrc = build.CSRC
        if self.patches:
            copy = build.BUILD_DIR / "steps" / self.name
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(self.csrc, copy,
                            ignore=shutil.ignore_patterns("__pycache__"))
            for fname, old, new in self.patches:
                text = (copy / fname).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(
                        f"variant {self.name}: {fname} holds the text to "
                        f"replace {text.count(old)} times, not once:\n{old}")
                (copy / fname).write_text(text.replace(old, new))
            build.CSRC = copy
        self._forget()
        return self

    def __exit__(self, *exc):
        build.CSRC = self.csrc
        self._forget()

    @staticmethod
    def _forget():
        for name in ("decode_grouped", "encode_scan_grouped"):
            build._libs.pop(name, None)


class Cell:
    """One input staged as the codec's encode() and decode() stage it, with
    the stream the kernels as they are write and read."""

    def __init__(self, label: str, codec, values):
        self.label = label
        mapped, k, low, pfreqs, ffreqs, raw = codec._enc_inputs(values)
        self.n = int(mapped.shape[0])
        self.T = lane_codec.lane_steps(self.n, LANES)
        self.enc, (self.mapped, nb, excw) = _stage(
            mapped, k, low, self.n, ffreqs, raw, LANES)
        self.dec = tables.to_device(codec._table(pfreqs), DEVICE)
        self.packed, self.states = encode.encode_scan_grouped(
            self.mapped, self.n, self.enc)
        round_base, total = lane_codec.encode_totals(self.packed, nb, self.n)
        self.stream = place.place(self.packed, nb, excw, self.n, round_base,
                                  int(total))
        self.out = self.decode(self.dec)

    def decode(self, table, **kw):
        return decode.decode_grouped(self.stream, self.states, table, self.n,
                                     self.T, **kw)

    def scan(self):
        return encode.encode_scan_grouped(self.mapped, self.n, self.enc)

    def full_search(self):
        """The decode table with one bucket and the full search's levels:
        the search as it was before the bucket level."""
        d = self.dec
        return dataclasses.replace(
            d, buckets=torch.zeros(1, dtype=torch.int16, device=DEVICE),
            shift=d.log2m, levels=d.depth)


def time_k5(cell: Cell, table, what: str, **kw) -> float:
    if not torch.equal(cell.decode(table, **kw), cell.out):
        raise RuntimeError(f"{cell.label}: K5 variant {what} decodes wrongly")
    return cuda_ms(lambda: cell.decode(table, **kw))


def time_k6(cell: Cell, what: str) -> float:
    packed, states = cell.scan()
    if not (torch.equal(packed, cell.packed)
            and torch.equal(states, cell.states)):
        raise RuntimeError(f"{cell.label}: K6 variant {what} scans wrongly")
    return cuda_ms(cell.scan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--quick", action="store_true",
                    help="n = 2^20 in both cells: a check, not a "
                         "measurement")
    ap.add_argument("--baseline", action="store_true",
                    help="time only the kernels as they are")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_steps: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cells = [
        Cell("ANSfold-7 on zipf20", AnsFold(7, device=DEVICE),
             zipf20_input(1 << (20 if args.quick else 25))),
        Cell("ANS on dense22", AnsInt(device=DEVICE),
             dense_input(1 << (20 if args.quick else 22)))]
    recs = []

    def emit(cell, kernel, step, ms):
        recs.append({"cell": cell.label, "n": cell.n, "kernel": kernel,
                     "step": step, "ms": ms})
        print(f"[{smi}] {cell.label} n={cell.n} {kernel} {step}: {ms:.3f} ms",
              flush=True)

    if args.baseline:
        for cell in cells:
            emit(cell, "K5", "as it is", cuda_ms(lambda: cell.decode(cell.dec)))
            emit(cell, "K6", "as it is", cuda_ms(cell.scan))
    else:
        for cell in cells:
            full = cell.full_search()
            with Variant("k5_a", [LANE_AFTER_LANE, SCALAR_STORES]):
                emit(cell, "K5", "a", time_k5(cell, full, "a",
                                              instance="global"))
                emit(cell, "K5", "b", time_k5(cell, full, "b"))
            with Variant("k5_c", [SCALAR_STORES]):
                emit(cell, "K5", "c", time_k5(cell, full, "c"))
                emit(cell, "K5", "d", time_k5(cell, cell.dec, "d"))
            with Variant("final", []):
                emit(cell, "K5", "e", time_k5(cell, cell.dec, "e"))
                emit(cell, "K5", "e on global loads",
                     time_k5(cell, cell.dec, "e/global", instance="global"))
            # K6: the register form in blocks of 256 lanes (as the kernel
            # had them) and of 32, then the tile form
            registers = [REGISTER_ROWS, *REGISTER_LAUNCH]
            for step, patches in (("a", [*registers, chain_warps(8)]),
                                  ("ac", registers),
                                  ("b4", [chain_warps(4),
                                          *FOUR_LOOKUP_WARPS]),
                                  ("b1", FOUR_LOOKUP_WARPS),
                                  ("b2", [chain_warps(2)]), ("bc", [])):
                with Variant(f"k6_{step}", patches):
                    emit(cell, "K6", step, time_k6(cell, step))
            for step, patch in (("chain alone", NO_LOOKUPS),
                                ("lookups alone", NO_CHAIN)):
                with Variant("k6_" + step.replace(" ", "_"), [patch]):
                    emit(cell, "K6", step, cuda_ms(cell.scan))
    text = json.dumps({"card": smi, "runs": RUNS, "lanes": LANES,
                       "steps": recs})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
