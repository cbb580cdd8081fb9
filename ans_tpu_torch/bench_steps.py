"""Time the design steps of the kernels apart, on one CUDA card: K5
(csrc/decode_grouped.cu) and K6 (csrc/encode_scan_grouped.cu) on the
grouped path, K1 (csrc/encode_scan.cu) and K2 (csrc/place.cu) on the
main path and K2 on the grouped path.

    python3 -m ans_tpu_torch.bench_steps [--out FILE] [--quick] [--baseline]
        [--kernels K1,K2,K5,K6]

The sources keep one form of each kernel.  This script rebuilds the
earlier forms from them: it copies csrc/ into the build directory, applies
the textual substitutions below (each must match exactly once, so a source
that has moved on fails here and not silently), builds the copy and times
it beside the sources as they are, in one process on one card.  What needs
no other source is set through the wrappers: the instance ("global") and
the bucket level (a one-bucket table with the full search's levels).  The
earlier forms of K1 and K2 differ from the sources throughout: their
sources are kept whole in ans_tpu_torch/earlier_csrc/ and copied over the
copy of csrc/ (no codec path builds them).

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
K1:
  earlier      one thread a lane, blocks of 256 lanes, the symbol and its
               table row loaded a step ahead on the chain, a branch on
               `idx < n` in the chain loop
  b4 / b2      the look-ahead scan of encode_ahead.cuh with four lookup
               warps of eight lookups / in blocks of 64 lanes
  as it is     the look-ahead scan, eight lookup warps of four lookups,
               blocks of 32 lanes, the table in shared memory
  chain alone / lookups alone  as for K6
K2:
  earlier + totals  the plain round totals (lane_codec.encode_totals:
               ~20 torch kernels over (T, S, 6) masks) and the earlier K2
  earlier      the earlier K2 alone, round_base given: one block a step,
               one-byte stores
  narrow look-back  the look-back reading one status word a lane: 32
               chunks a round trip to L2, where it reads 256 as it is
  no look-back  every chunk placed at offset 0 (wrong by design): what the
               look-back costs
  block index / relaxed publish  the chunk taken by block index instead of
               the ticket / the status words stored relaxed, not released
  staging loads at once  a thread's staging loads all issued together
  pause in the look-back  a 200 ns pause before an unpublished window is
               read again
  look-back before staging  warp 0 looks back while the others stage
  timeline     the kernel as it is with each block's phases timed on the
               global timer (median over the blocks), the kernel's span,
               and how many blocks were in flight
  two steps a chunk  blocks of 512 threads over two steps at S = 4096
  four lanes a thread  the single pass in blocks of 1024 threads a step
               at S = 4096 (one block an SM)
  byte stores  the single pass, its run written with one-byte stores
  as it is     the single pass, 16 lanes a thread (blocks of 256 threads
               at S = 4096), 16-byte stores on the run's interior

Cells: ANSfold-7 on zipf20 (n = 2^25, S = 4096: the grouped path) and ANS on
dense22 (n = 2^22; K5's value table in global memory, K6 fed ranks) for K5,
K6 and K2; ANSfold-2 on bench.py's input (n = 2^25, S = 4096: the main
path) for K1 and K2.  Every variant's output is held against the final
kernel's.  Times are CUDA
events, min of 5 after a warm-up.  --baseline times only the kernels as
they are, through calls every version of the port has (to time an older
tree, copy this file into it).  Prints one line per variant with the
card's name and power limit, then one JSON object.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes as ct
import dataclasses
import inspect
import json
import shutil
import subprocess
import sys

import torch

from .csrc import build
from .inputs import bench_input, dense_input, zipf20_input
from .models.ans import AnsFold, AnsInt, _stage
from .ops import decode, encode, lane_codec, place, tables

RUNS = 5
DEVICE = "cuda"
LANES = 4096
EARLIER = build.CSRC.parent / "earlier_csrc"  # earlier forms of K1 and K2

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


# K2: the run written with one-byte stores only (no 16-byte interior)
BYTE_STORES = ("place.cu", """\
  const int64_t a0 = min(up, max(p1, p0)), a1 = max(a0, down);
""", """\
  const int64_t a0 = max(p1, p0), a1 = a0;
""")

# K2: the look-back one status word a lane (32 chunks a round trip), or none
# at all (every chunk placed at 0: the output is wrong by design)
NARROW_LOOK_BACK = ("place.cu", "constexpr int LOOK = 8;",
                    "constexpr int LOOK = 1;")
NO_LOOK_BACK = ("place.cu", """\
    const uint64_t ex = chunk == 0 ? 0 : look_back(status, chunk);
""", """\
    const uint64_t ex = chunk < 0 ? look_back(status, chunk) : 0;
""")

# K2: chunks of two steps at S = 4096 (blocks of 512 threads)
TWO_STEPS_A_CHUNK = ("place.cu", "constexpr int STEP_BLOCK = 256;",
                     "constexpr int STEP_BLOCK = 512;")

# K2: the chunk by block index instead of the ticket (the look-back then
# relies on blocks starting in index order, as they do), or the status words
# published relaxed instead of with release
BLOCK_INDEX = ("place.cu",
               "  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1u);\n",
               "  if (threadIdx.x == 0) chunk_s = blockIdx.x;\n")
RELAXED_PUBLISH = ("place.cu", "st.release.gpu.global.u64",
                   "st.relaxed.gpu.global.u64")

# K2 with a timeline: thread 0 of each block reads the global timer at its
# start, after the ticket, after the counts' scan, after staging its bytes,
# after the look-back (and the barrier behind it) and at its end, and writes
# the six times past the stream's `cap` bytes (the caller gives a longer
# buffer)

# K2: each thread's staging loads all issued at once (12 vector loads at
# S = 4096) instead of two lanes' vectors at a time; the look-back pausing
# 200 ns before it reads a window again; the look-back before the staging
# (warp 0 looks back while the others stage)
STAGE_UNROLLED = ("place.cu", "#pragma unroll 2\n", "#pragma unroll\n")
PAUSE = ("place.cu", """\
      unpublished = __any_sync(lane::FULL_MASK, waiting);
""", """\
      unpublished = __any_sync(lane::FULL_MASK, waiting);
      if (unpublished) __nanosleep(200);
""")
LOOK_BACK_FIRST = [
    ("place.cu", """\
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  if (fast)
    stage_lanes<LPT, true>(packed, nb, excw, row, l0, S, n, pos, bytes);
  else
    stage_lanes<LPT, false>(packed, nb, excw, row, l0, S, n, pos, bytes);
""", ""),
    ("place.cu", """\
      excl_s = ex;
    }
  }
""", """\
      excl_s = ex;
    }
  }
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  if (fast)
    stage_lanes<LPT, true>(packed, nb, excw, row, l0, S, n, pos, bytes);
  else
    stage_lanes<LPT, false>(packed, nb, excw, row, l0, S, n, pos, bytes);
""")]
TIMELINE = [
    ("place.cu", """\
  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1u);
""", """\
  uint64_t clk[6];
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[0]));
  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1u);
"""),
    ("place.cu", """\
  const int64_t chunk = chunk_s;
""", """\
  const int64_t chunk = chunk_s;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[1]));
"""),
    ("place.cu", """\
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
""", """\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[2]));
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
"""),
    ("place.cu", """\
  if (threadIdx.x < 32) {
    const uint64_t ex""", """\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[3]));
  if (threadIdx.x < 32) {
    const uint64_t ex"""),
    ("place.cu", """\
  const int64_t p0 = static_cast<int64_t>(excl_s);
""", """\
  const int64_t p0 = static_cast<int64_t>(excl_s);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[4]));
"""),
    ("place.cu", """\
    *reinterpret_cast<uint4*>(stream + p) = out;
  }
}
""", """\
    *reinterpret_cast<uint4*>(stream + p) = out;
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[5]));
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i)
      reinterpret_cast<uint64_t*>(stream + ((cap + 7) & ~int64_t(7)))
          [6 * chunk + i] = clk[i];
}
""")]
TIMELINE_PHASES = ("ticket", "counts and scan", "staging", "look-back",
                   "writes")

# K2: four lanes a thread (1024 threads a step at S = 4096, one block an SM)
FOUR_LANES_A_THREAD = [
    ("place.cu", "constexpr int LANES_A_THREAD = 16;",
     "constexpr int LANES_A_THREAD = 4;"),
    ("place.cu", "constexpr int STEP_BLOCK = 256;",
     "constexpr int STEP_BLOCK = 1024;")]

# the earlier K2's C entry point: round_base in, one error flag out
EARLIER_PLACE_ARGTYPES = [
    ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int, ct.c_int,
    ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p]


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
    """The kernels built from a copy of csrc/ with the sources `earlier`
    (names in earlier_csrc/) copied over it and `patches` applied; inside
    the `with` block the wrappers launch that build."""

    def __init__(self, name: str, patches, earlier=()):
        self.name, self.patches, self.earlier = name, patches, earlier

    def __enter__(self):
        self.csrc = build.CSRC
        if self.patches or self.earlier:
            copy = build.BUILD_DIR / "steps" / self.name
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(self.csrc, copy,
                            ignore=shutil.ignore_patterns("__pycache__"))
            for fname in self.earlier:
                shutil.copy(EARLIER / fname, copy / fname)
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
        for name in ("decode_grouped", "encode_scan_grouped", "encode_scan",
                     "place"):
            build._libs.pop(name, None)


def _place(packed, nb, excw, n: int) -> torch.Tensor:
    """The stream through the placement as this tree has it: the single
    pass, or (an older tree, under --baseline) the plain round totals and
    the earlier K2."""
    if "round_base" in inspect.signature(place.place).parameters:
        round_base, total = lane_codec.encode_totals(packed, nb, n)
        return place.place(packed, nb, excw, n, round_base, int(total))
    return place.place(packed, nb, excw, n)[0]


def earlier_place(packed, nb, excw, n: int, total: int, round_base=None):
    """The earlier K2 (built from earlier_csrc/place.cu inside its
    Variant) as the earlier prepared encoder called it: round_base from the
    plain round totals (unless given), the launch, one sync on its error
    flag."""
    if round_base is None:
        round_base, _ = lane_codec.encode_totals(packed, nb, n)
    T, S = packed.shape
    stream = torch.empty(total, dtype=torch.uint8, device=DEVICE)
    err = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    fn = build.function("place", EARLIER_PLACE_ARGTYPES)
    build.check("place", fn(
        build.ptr(packed), build.ptr(nb), build.ptr(excw), n, T, S,
        build.ptr(round_base), build.ptr(stream), total, build.ptr(err),
        build.current_stream(torch.device(DEVICE))))
    if err.item():
        raise RuntimeError("the earlier K2 wrote past the stream")
    return stream


class LaneCell:
    """ANSfold-2 on bench.py's input (the main path), staged as encode()
    stages it, with K1's words and K2's stream as the kernels as they are
    write them."""

    def __init__(self, label: str, values):
        self.label = label
        mapped, k, low, _, ffreqs, raw = AnsFold(
            2, device=DEVICE)._enc_inputs(values)
        self.n = int(mapped.shape[0])
        self.T = lane_codec.lane_steps(self.n, LANES)
        self.enc, (self.mapped, self.nb, self.excw) = _stage(
            mapped, k, low, self.n, ffreqs, raw, LANES)
        self.packed, self.states = self.scan()
        self.stream = _place(self.packed, self.nb, self.excw, self.n)

    def scan(self):
        return encode.encode_scan(self.mapped, self.n, self.enc)


def time_k1(cell: LaneCell, what: str) -> float:
    packed, states = cell.scan()
    if not (torch.equal(packed, cell.packed)
            and torch.equal(states, cell.states)):
        raise RuntimeError(f"{cell.label}: K1 variant {what} scans wrongly")
    return cuda_ms(cell.scan)


def time_place(cell, what: str, fn) -> float:
    """fn() -> stream, held against the stream as it is, then timed."""
    if not torch.equal(fn()[:cell.stream.numel()], cell.stream):
        raise RuntimeError(f"{cell.label}: K2 variant {what} places wrongly")
    return cuda_ms(fn)


def k2_timeline(cell, emit) -> None:
    """K2 as it is with its timeline (TIMELINE): the median of each phase
    over the blocks, the blocks' mean time, and how many were in flight on
    average (their summed time over the kernel's span)."""
    import numpy as np
    from .ops.place import _ARGTYPES
    T, S = cell.packed.shape
    total = cell.stream.numel()
    head = (total + 7) // 8 * 8
    with Variant("k2_timeline", TIMELINE):
        fn = build.function("place", _ARGTYPES)
        for _ in range(2):  # the second run is read
            stream = torch.zeros(head + 48 * T, dtype=torch.uint8,
                                 device=DEVICE)
            scratch = torch.zeros(2 * (T + 1), dtype=torch.int64,
                                  device=DEVICE)
            build.check("place", fn(
                build.ptr(cell.packed), build.ptr(cell.nb),
                build.ptr(cell.excw), cell.n, T, S, build.ptr(stream), total,
                build.ptr(scratch), build.ptr(scratch[T + 1:]),
                build.current_stream(torch.device(DEVICE))))
            torch.cuda.synchronize()
        if not torch.equal(stream[:total], cell.stream):
            raise RuntimeError(f"{cell.label}: K2 with its timeline places "
                               "wrongly")
        clk = stream[head:].cpu().numpy().view(np.int64).reshape(T, 6)
    clk = clk - clk[:, 0].min()
    span = clk[:, 5].max()
    for i, phase in enumerate(TIMELINE_PHASES):
        emit(cell, "K2", f"timeline: {phase} (median)",
             float(np.median(clk[:, i + 1] - clk[:, i])) / 1e6)
    emit(cell, "K2", "timeline: a block (mean)",
         float((clk[:, 5] - clk[:, 0]).mean()) / 1e6)
    emit(cell, "K2", "timeline: span", float(span) / 1e6)
    recs_in_flight = float((clk[:, 5] - clk[:, 0]).sum() / span)
    print(f"{cell.label}: K2 blocks in flight on average "
          f"{recs_in_flight:.1f}; start of every 1024th chunk (us): "
          f"{[round(float(x) / 1e3, 1) for x in clk[::1024, 0]]}")


def k2_rows(cell, emit) -> None:
    """The earlier K2 with and without the plain round totals in front,
    the single pass with byte stores, and as it is."""
    args = (cell.packed, cell.nb, cell.excw, cell.n)
    total = cell.stream.numel()
    with Variant("k2_earlier", [], earlier=["place.cu"]):
        rb, _ = lane_codec.encode_totals(*args[:2], cell.n)
        emit(cell, "K2", "earlier + totals", time_place(
            cell, "earlier + totals", lambda: earlier_place(*args, total)))
        emit(cell, "K2", "earlier", time_place(
            cell, "earlier", lambda: earlier_place(*args, total, rb)))
    with Variant("k2_narrow_look_back", [NARROW_LOOK_BACK]):
        emit(cell, "K2", "narrow look-back", time_place(
            cell, "narrow look-back", lambda: place.place(*args, total)[0]))
    with Variant("k2_no_look_back", [NO_LOOK_BACK]):
        emit(cell, "K2", "no look-back", cuda_ms(
            lambda: place.place(*args)[0]))
    with Variant("k2_block_index", [BLOCK_INDEX]):
        emit(cell, "K2", "block index", time_place(
            cell, "block index", lambda: place.place(*args, total)[0]))
    with Variant("k2_relaxed_publish", [RELAXED_PUBLISH]):
        emit(cell, "K2", "relaxed publish", time_place(
            cell, "relaxed publish", lambda: place.place(*args, total)[0]))
    with Variant("k2_pause", [PAUSE]):
        emit(cell, "K2", "pause in the look-back", time_place(
            cell, "pause", lambda: place.place(*args, total)[0]))
    with Variant("k2_look_back_first", LOOK_BACK_FIRST):
        emit(cell, "K2", "look-back before staging", time_place(
            cell, "look-back first", lambda: place.place(*args, total)[0]))
    with Variant("k2_stage_unrolled", [STAGE_UNROLLED]):
        emit(cell, "K2", "staging loads at once", time_place(
            cell, "staging loads at once",
            lambda: place.place(*args, total)[0]))
    if cell.packed.shape[1] >= 512:  # one step a chunk
        k2_timeline(cell, emit)
    with Variant("k2_two_steps", [TWO_STEPS_A_CHUNK]):
        emit(cell, "K2", "two steps a chunk", time_place(
            cell, "two steps a chunk", lambda: place.place(*args, total)[0]))
    with Variant("k2_four_lanes", FOUR_LANES_A_THREAD):
        emit(cell, "K2", "four lanes a thread", time_place(
            cell, "four lanes a thread", lambda: place.place(*args, total)[0]))
    with Variant("k2_byte_stores", [BYTE_STORES]):
        emit(cell, "K2", "byte stores", time_place(
            cell, "byte stores", lambda: place.place(*args, total)[0]))
    with Variant("final", []):
        emit(cell, "K2", "as it is", time_place(
            cell, "as it is", lambda: place.place(*args, total)[0]))


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
        self.nb, self.excw = nb, excw
        self.packed, self.states = self.scan()
        self.stream = _place(self.packed, nb, excw, self.n)
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
    ap.add_argument("--kernels", default="K1,K2,K5,K6",
                    help="the kernels to time (default: %(default)s)")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("bench_steps: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log2n = 20 if args.quick else 25
    lane = (LaneCell("ANSfold-2 on bench input", bench_input(1 << log2n, 42))
            if kernels & {"K1", "K2"} else None)
    cells = [
        Cell("ANSfold-7 on zipf20", AnsFold(7, device=DEVICE),
             zipf20_input(1 << log2n)),
        Cell("ANS on dense22", AnsInt(device=DEVICE),
             dense_input(1 << (20 if args.quick else 22)))
    ] if kernels & {"K2", "K5", "K6"} else []
    recs = []

    def emit(cell, kernel, step, ms):
        recs.append({"cell": cell.label, "n": cell.n, "kernel": kernel,
                     "step": step, "ms": ms})
        print(f"[{smi}] {cell.label} n={cell.n} {kernel} {step}: {ms:.3f} ms",
              flush=True)

    if args.baseline:
        if "K1" in kernels:
            emit(lane, "K1", "as it is", cuda_ms(lane.scan))
        for cell in [lane, *cells] if "K2" in kernels else []:
            emit(cell, "K2", "as it is", cuda_ms(lambda: _place(
                cell.packed, cell.nb, cell.excw, cell.n)))
        for cell in cells:
            if "K5" in kernels:
                emit(cell, "K5", "as it is",
                     cuda_ms(lambda: cell.decode(cell.dec)))
            if "K6" in kernels:
                emit(cell, "K6", "as it is", cuda_ms(cell.scan))
    else:
        if "K1" in kernels:
            with Variant("k1_earlier", [], earlier=["encode_scan.cu"]):
                emit(lane, "K1", "earlier", time_k1(lane, "earlier"))
            for step, patches in (("b4", FOUR_LOOKUP_WARPS),
                                  ("b2", [chain_warps(2)]),
                                  ("as it is", [])):
                with Variant(f"k1_{step.replace(' ', '_')}", patches):
                    emit(lane, "K1", step, time_k1(lane, step))
            for step, patch in (("chain alone", NO_LOOKUPS),
                                ("lookups alone", NO_CHAIN)):
                with Variant("k1_" + step.replace(" ", "_"), [patch]):
                    emit(lane, "K1", step, cuda_ms(lane.scan))
        for cell in [lane, *cells] if "K2" in kernels else []:
            k2_rows(cell, emit)
        for cell in cells if "K5" in kernels else []:
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
        for cell in cells if "K6" in kernels else []:
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
