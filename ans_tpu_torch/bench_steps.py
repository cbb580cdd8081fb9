"""Time the design steps of the kernels apart, on one CUDA card: K5
(csrc/decode_grouped.cu) and K6 (csrc/encode_scan_grouped.cu) on the
grouped path, K1 (csrc/encode_scan.cu) and K2 (csrc/place.cu) on the
main path and K2 on the grouped path; K7 (csrc/bytesplit_encode.cu), K8
(csrc/svb_decode.cu) and K9 (csrc/vbyte_decode.cu) on the byte path.

    python3 -m ans_tpu_torch.bench_steps [--out FILE] [--quick] [--baseline]
        [--kernels K1,K2,K5,K6,K7,K8,K9 (with --baseline also K3,K4,PE)]

The sources keep one form of each kernel.  This script rebuilds the
earlier forms from them: it copies csrc/ into the build directory, applies
the textual substitutions below (each must match exactly once, so a source
that has moved on fails here and not silently), builds the copy and times
it beside the sources as they are, in one process on one card.  What needs
no other source is set through the wrappers: the instance ("global") and
the bucket level (a one-bucket table with the full search's levels).  The
earlier forms of K1, K2, K7, K8 and K9 differ from the sources throughout:
their sources are kept whole in ans_tpu_torch/earlier_csrc/ and copied over the
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
  narrow look-back / look-back eight words a lane  the look-back
               (csrc/lookback.cuh) reading one / eight status words a lane:
               32 / 256 chunks a round trip to L2 (eight as K2's own copy
               of the look-back read them), where it reads two as it is
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
Each K2 row but "earlier + totals" times the launch alone (its status
words zeroed in front, on buffers allocated once); "as it is, through the
wrapper" times the call chip_smoke.py times.

K7 (vbyte format unless a row says otherwise) and K9, one launch each, a
chained scan with decoupled look-back (csrc/lookback.cuh):
  earlier      three launches (tile totals, one block scanning them, the
               write or decode pass reading the input again; K7 stores its
               bytes one at a time, K9 walks back in device memory)
  a branch before each load  the first form of the loads: each 16-byte
               load behind its own branch and used at once, so that each
               waited for the one before
  scalar loads  element by element (K7) or byte by byte (K9) loads
  values read again  K7's staging reads the values again (from L2): a
               second pass over the input inside the one launch
  walk-back in global memory  K9's 8 bytes before each granule read from
               device memory instead of the chunk in shared memory
  values by element, after the look-back  K9 staging only its
               terminators' positions, then rebuilding four neighbouring
               elements a thread from the 8 bytes that end at each
  byte stores / 4-byte stores  the staged run written without its
               16-byte interior
  scattered, no staging  K7 with no staging: each thread stores its bytes
               straight into the stream after the look-back
  look-back before staging  warp 0 looks back while the others stage
  narrow / wide look-back  one / eight status words a lane (32 / 256
               chunks a round trip), where the kernels read two
  no look-back  every chunk at offset 0 (wrong by design): what the
               look-back costs
  registers uncapped  four blocks an SM instead of five
  chunks of ...  blocks of other sizes, 16 items a thread for K7 and 32
               bytes for K9, as many threads an SM
  timeline     as for K2, the kernel as it is
  as it is     K7 chunks of 4096 elements, K9 of 8192 bytes, 256
               threads; K9 also on the stream at an odd address (byte
               loads at its head and tail)
K8, one launch on the same header:
  earlier      three launches (tile totals from the control bytes, one
               block scanning them, the decode pass reading the control
               bytes again and gathering each element byte by byte)
  byte loads behind a branch  no staging: each element gathered byte by
               byte from device memory behind a check of the data length
               (the earlier gather)
  4-byte stores  four stores a control byte instead of one 16-byte store
  two launches  a pass over the control bytes alone publishes every
               chunk's aggregate, then the decode pass, whose look-back
               never waits
  look-back two / eight words a lane  where it reads one (32 chunks a
               round trip)
  no look-back, registers uncapped  as for K7 and K9
  five blocks an SM  registers capped for five blocks, not six
  chunks of 2048 / 8192  blocks of 128 / 512 threads, 16 elements a
               thread, as many threads an SM
  timeline     ticket, control loads and scan, look-back, data loads,
               decode and stores
  as it is     chunks of 4096 elements, 256 threads, six blocks an SM, a
               look-back of one word a lane; also with the data
               right behind the control bytes, as the codecs hand them
               over (an odd address)
Each K7 / K8 / K9 row times the launch alone (its status words zeroed in
front, on buffers allocated once); the rows "through the wrapper" time the
call chip_smoke.py times (allocations, the launch, the sync on the length
or the flags).

Cells: ANSfold-7 on zipf20 (n = 2^25, S = 4096: the grouped path) and ANS on
dense22 (n = 2^22; K5's value table in global memory, K6 fed ranks) for K5,
K6 and K2; ANSfold-2 on bench.py's input (n = 2^25, S = 4096: the main
path) for K1 and K2; zipf20 (n = 2^25) through K7, its vbyte stream
(64,162,199 bytes) through K9 and its streamvbyte stream (67,713,815 data
bytes) through K8.  Every variant's output is held against the
final kernel's.  Times are CUDA events, min of 5 after a warm-up.
--baseline times only the kernels as they are, through calls every version
of the port has (to time an older tree, copy this file into it); there
`--kernels` also takes K3 and K4, the main path's decodes, and PE, the
prepared encode (`models.prepare_encoder`: the scan and the placement
with their wrappers' host work) of the main and the grouped path, min of
PE_RUNS calls.  Prints one
line per variant with the card's name and power limit, then one JSON
object.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes as ct
import dataclasses
import inspect
import json
import shutil
import subprocess
import sys
import types
from unittest import mock

import torch

from .csrc import build
from .inputs import bench_input, dense_input, zipf20_input
from .models.ans import AnsFold, AnsInt, _stage
from .ops import bytesplit, decode, encode, lane_codec, place, tables

RUNS = 5
PE_RUNS = 20  # the prepared encode is partly host time: more calls
DEVICE = "cuda"
LANES = 4096
# earlier forms of K1, K2, K7, K8 and K9
EARLIER = build.CSRC.parent / "earlier_csrc"

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

# K2: the look-back (lookback.cuh, two status words a lane) one or eight
# status words a lane (32 or 256 chunks a round trip; eight as K2's own
# copy of the look-back read them), or none at all (every chunk placed at
# 0: the output is wrong by design)
NARROW_LOOK_BACK = ("place.cu", "constexpr int LOOK = 2;",
                    "constexpr int LOOK = 1;")
WIDE_LOOK_BACK = ("place.cu", "constexpr int LOOK = 2;",
                  "constexpr int LOOK = 8;")
K2_LOOK_BACK = """\
  const uint64_t ex = lookback::exclusive_prefix<LOOK>(status, chunk, agg);
"""
NO_LOOK_BACK = ("place.cu", K2_LOOK_BACK, """\
  const uint64_t ex = 0;
""")

# K2: chunks of two steps at S = 4096 (blocks of 512 threads)
TWO_STEPS_A_CHUNK = ("place.cu", "constexpr int STEP_BLOCK = 256;",
                     "constexpr int STEP_BLOCK = 512;")

# K2: the chunk by block index instead of the ticket (the look-back then
# relies on blocks starting in index order, as they do), or the status words
# published relaxed instead of with release (both in lookback.cuh, which
# the K2 rows build only into K2)
BLOCK_INDEX = ("lookback.cuh",
               "  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1u);\n",
               "  if (threadIdx.x == 0) chunk_s = blockIdx.x;\n")
RELAXED_PUBLISH = ("lookback.cuh", "st.release.gpu.global.u64",
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
PAUSE = ("lookback.cuh", """\
      if (!__any_sync(lane::FULL_MASK, waiting && me <= last)) break;
""", """\
      if (!__any_sync(lane::FULL_MASK, waiting && me <= last)) break;
      __nanosleep(200);
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
  if (threadIdx.x == 0) excl_s = ex;
""", """\
  if (threadIdx.x == 0) excl_s = ex;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  if (fast)
    stage_lanes<LPT, true>(packed, nb, excw, row, l0, S, n, pos, bytes);
  else
    stage_lanes<LPT, false>(packed, nb, excw, row, l0, S, n, pos, bytes);
""")]
TIMELINE = [
    ("place.cu", """\
  const int64_t chunk = lookback::take_ticket(ticket);
""", """\
  uint64_t clk[6];
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[0]));
  const int64_t chunk = lookback::take_ticket(ticket);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[1]));
"""),
    ("place.cu", """\
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
""", """\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[2]));
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
"""),
    ("place.cu", K2_LOOK_BACK, """\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[3]));
""" + K2_LOOK_BACK),
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

# blocks of 256 threads an SM that K7, K8 and K9 cap their registers for
MIN_BLOCKS = {"bytesplit_encode.cu": 5, "svb_decode.cu": 6,
              "vbyte_decode.cu": 5}


# K7, K8 and K9: blocks of `threads` threads, each holding as many threads
# an SM as the kernel as it is (five or six blocks of 256; an SM holds at
# most 32 blocks), so that the chunk grows with the block
def byte_threads(fname: str, threads: int):
    blocks = min(32, max(1, 256 * MIN_BLOCKS[fname] // threads))
    return [(fname, "constexpr int THREADS = 256;  // a block",
             f"constexpr int THREADS = {threads};  // a block"),
            (fname, f"constexpr int MIN_BLOCKS = {MIN_BLOCKS[fname]};",
             f"constexpr int MIN_BLOCKS = {blocks};")]


# K7, K8 and K9: the registers not capped (four blocks of 256 an SM)
def uncapped(fname: str):
    return (fname, f"constexpr int MIN_BLOCKS = {MIN_BLOCKS[fname]};",
            "constexpr int MIN_BLOCKS = 1;")


# K8: its look-back `words` status words a lane, where it reads one; its
# registers capped for five blocks an SM, where it holds six
def k8_look(words: int):
    return ("svb_decode.cu", "constexpr int LOOK = 1;",
            f"constexpr int LOOK = {words};")


K8_FIVE_BLOCKS = ("svb_decode.cu", "constexpr int MIN_BLOCKS = 6;",
                  "constexpr int MIN_BLOCKS = 5;")


# K7 and K9: the look-back one status word a lane (32 chunks a round trip),
# or eight (256, as K2 reads them), where it reads two; or none at all (every
# chunk placed at 0: the output is wrong by design)
NARROW_BYTE_LOOK_BACK = ("lookback.cuh", "constexpr int LOOK = 2;",
                         "constexpr int LOOK = 1;")
WIDE_BYTE_LOOK_BACK = ("lookback.cuh", "constexpr int LOOK = 2;",
                       "constexpr int LOOK = 8;")
NO_BYTE_LOOK_BACK = ("lookback.cuh", """\
  const uint64_t ex = chunk == 0 ? 0 : look_back<WORDS>(status, chunk);
""", """\
  const uint64_t ex = chunk < 0 ? look_back<WORDS>(status, chunk) : 0;
""")

# K7 and K9: the first form of the loads, a branch before each 16-byte load
# and its result used right after it, so that each waits for the one before
K7_BRANCHED_LOADS = ("bytesplit_encode.cu", """\
  if (vec && i0 - 4 * threadIdx.x + CHUNK <= n) {
    uint4 q[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      q[g] = __ldg(reinterpret_cast<const uint4*>(x + i0 + g * 4 * THREADS));
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      v[g][0] = q[g].x, v[g][1] = q[g].y, v[g][2] = q[g].z, v[g][3] = q[g].w;
  } else {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = i0 + g * 4 * THREADS + j;
        const uint32_t y = __ldg(x + (i < n ? i : 0));
        v[g][j] = i < n ? y : 0u;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    cnt[g] = 0;
""", """\
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int64_t i = i0 + g * 4 * THREADS;
    if (vec && i + 4 <= n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(x + i));
      v[g][0] = q.x, v[g][1] = q.y, v[g][2] = q.z, v[g][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t y = __ldg(x + (i + j < n ? i + j : 0));
        v[g][j] = i + j < n ? y : 0u;
      }
    }
    cnt[g] = 0;
""")
K9_BRANCHED_LOADS = ("vbyte_decode.cu", """\
  if (first >= 0 && first + CHUNK <= len) {
#pragma unroll
    for (int g = 0; g < GRANULES; ++g) {
      q[g] = __ldg(reinterpret_cast<const uint4*>(
          data + first + 16 * (g * THREADS + threadIdx.x)));
      valid[g] = 0xFFFFu;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GRANULES; ++g)
      q[g] = load_edge(data, len, first + 16 * (g * THREADS + threadIdx.x),
                       valid[g]);
  }
  uint32_t mine[GRANULES];  // a bit for each terminator in the stream
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
""", """\
  uint32_t mine[GRANULES];  // a bit for each terminator in the stream
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    const int64_t p = first + 16 * (g * THREADS + threadIdx.x);
    if (p >= 0 && p + 16 <= len) {
      q[g] = __ldg(reinterpret_cast<const uint4*>(data + p));
      valid[g] = 0xFFFFu;
    } else {
      q[g] = load_edge(data, len, p, valid[g]);
    }
""")

# K9: the values by element after the look-back: the block stages only its
# terminators' positions before it, then a thread rebuilds four neighbouring
# elements from the 8 bytes that end at each terminator and stores them
K9_BY_ELEMENT = [
    ("vbyte_decode.cu", "constexpr int SMEM = 16 + CHUNK + 4 * CHUNK;",
     "constexpr int SMEM = 16 + CHUNK + 2 * CHUNK;"),
    ("vbyte_decode.cu", """\
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    vbyte_decode_kernel(""",
     """\
// The 8 bytes that end at the chunk's byte p, out of shared memory (the
// chunk's bytes behind their 16 bytes of halo): x holds bytes p-7 .. p-4,
// y bytes p-3 .. p.
__device__ __forceinline__ uint2 window_at(const uint8_t* sbytes, int p) {
  const int b = 16 + p - 7;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(sbytes) + (b >> 2);
  const int sh = 8 * (b & 3);
  return make_uint2(__funnelshift_r(s32[0], s32[1], sh),
                    __funnelshift_r(s32[1], s32[2], sh));
}

// The value of the element whose terminator ends the 8 bytes w; `bad` is
// set when more than four continuation bytes precede it (bytes outside the
// stream read 0, so the count stops at the stream's start).
__device__ __forceinline__ uint32_t value_by_element(uint2 w, bool& bad) {
  // continuation bytes right before the terminator (byte 7)
  const int k = __clz((terminators(w.x) | terminators(w.y) << 4) << 25);
  bad |= k >= 5;
  // the element's bytes, its first in the low byte
  const uint64_t y = ((static_cast<uint64_t>(w.y) << 32) | w.x) >>
                     (8 * (7 - min(k, 4)));
  const uint32_t l = static_cast<uint32_t>(y);
  const uint32_t h = static_cast<uint32_t>(y >> 32);
  return k >= 5 ? 0u
                : (l & 0x7Fu) | ((l >> 1) & 0x3F80u) | ((l >> 2) & 0x1FC000u) |
                      ((l >> 3) & 0xFE00000u) | (h << 28);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    vbyte_decode_kernel("""),
    ("vbyte_decode.cu", """\
  // the scan's barriers made the granules and the halo visible: each
  // granule's values from a window of its 16 bytes and the 8 before it
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + 1 + CHUNK / 16);
  int bad = CHUNK;  // the chunk's index of my first element past 5 bytes
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    const int idx = g * THREADS + threadIdx.x;
    int r = at + excl[g];  // the chunk's index of the granule's first value
    at += tot[g];
    const uint2 before = *reinterpret_cast<const uint2*>(sbytes + 16 * idx + 8);
    const uint4 q = smem[1 + idx];
    const uint32_t w[7] = {before.x, before.y, q.x, q.y, q.z, q.w, 0};
    // bytes outside the stream are 0, so a walk back stops at its start
    const uint32_t win = terminators(w[0]) | terminators(w[1]) << 4 |
                         terminators(w[2]) << 8 | terminators(w[3]) << 12 |
                         terminators(w[4]) << 16 | terminators(w[5]) << 20;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (mine[g] >> j & 1) {
        // continuation bytes before the terminator at window byte 8 + j
        const uint32_t below = win & ((1u << (8 + j)) - 1);
        const int k = 7 + j - (31 - __clz(below));
        if (k >= 5) bad = min(bad, r);
        vals[r++] = k >= 5 ? 0u : value_of(w, j + 1, min(k, 4));
      }
    }
  }
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t e0 = static_cast<int64_t>(excl_s);  // the chunk's first element
  if (bad < CHUNK && e0 + bad < n) atomicOr(err, 2);
  if (threadIdx.x == 0 && chunk == gridDim.x - 1) {
    *total = e0 + agg;
    if (e0 + agg < n) atomicOr(err, 1);
  }

  // the run out[e0, e1): 4-byte stores up to the first 16-byte boundary and
  // after the last one, 16-byte stores between
  const int64_t e1 = min(e0 + static_cast<int64_t>(agg), n);
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const int64_t up = static_cast<int64_t>(
      (((base + 4 * e0 + 15) & ~uintptr_t(15)) - base) >> 2);
  const int64_t down =
      static_cast<int64_t>((((base + 4 * e1) & ~uintptr_t(15)) - base) >> 2);
  const int64_t a0 = min(up, max(e1, e0)), a1 = max(a0, down);
  for (int64_t e = e0 + threadIdx.x; e < a0; e += THREADS)
    out[e] = vals[e - e0];
  for (int64_t e = a1 + threadIdx.x; e < e1; e += THREADS)
    out[e] = vals[e - e0];
  for (int64_t e = a0 + 4 * static_cast<int64_t>(threadIdx.x); e < a1;
       e += 4 * THREADS) {
    const uint32_t* src = vals + (e - e0);
    *reinterpret_cast<uint4*>(out + e) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

""",
     """\
  // the scan's barriers made the granules and the halo visible: each
  // terminator's position in the chunk, in stream order
  uint16_t* pos = reinterpret_cast<uint16_t*>(sbytes + 16 + CHUNK);
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    int r = at + excl[g];
    at += tot[g];
    const int p0 = 16 * (g * THREADS + threadIdx.x);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (mine[g] >> j & 1) pos[r++] = static_cast<uint16_t>(p0 + j);
  }
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t e0 = static_cast<int64_t>(excl_s);  // the chunk's first element
  if (threadIdx.x == 0 && chunk == gridDim.x - 1) {
    *total = e0 + agg;
    if (e0 + agg < n) atomicOr(err, 1);
  }

  // the run out[e0, e1), each value from the 8 bytes that end at its
  // terminator: 4-byte stores up to the first 16-byte boundary and after
  // the last one, 16-byte stores of four neighbouring elements between
  bool bad = false;  // one of my elements is longer than 5 bytes
  const auto value = [&](int e) {
    return value_by_element(window_at(sbytes, pos[e]), bad);
  };
  const int64_t e1 = min(e0 + static_cast<int64_t>(agg), n);
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const int64_t up = static_cast<int64_t>(
      (((base + 4 * e0 + 15) & ~uintptr_t(15)) - base) >> 2);
  const int64_t down =
      static_cast<int64_t>((((base + 4 * e1) & ~uintptr_t(15)) - base) >> 2);
  const int64_t a0 = min(up, max(e1, e0)), a1 = max(a0, down);
  for (int64_t e = e0 + threadIdx.x; e < a0; e += THREADS)
    out[e] = value(static_cast<int>(e - e0));
  for (int64_t e = a1 + threadIdx.x; e < e1; e += THREADS)
    out[e] = value(static_cast<int>(e - e0));
  for (int64_t e = a0 + 4 * static_cast<int64_t>(threadIdx.x); e < a1;
       e += 4 * THREADS) {
    const int i = static_cast<int>(e - e0);
    *reinterpret_cast<uint4*>(out + e) =
        make_uint4(value(i), value(i + 1), value(i + 2), value(i + 3));
  }
  if (bad) atomicOr(err, 2);
}

""")]

# K7: element by element loads (no 16-byte loads)
K7_SCALAR_LOADS = ("bytesplit_encode.cu", """\
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
""", """\
  const bool vec = false;
""")

# K7: the values read again for the staging (from L2, where the first read
# left them), as a second pass over the input would
K7_READ_AGAIN = ("bytesplit_encode.cu", """\
    const uint32_t key =
        stage_group<VBYTE>(bytes, at + excl[g], v[g], i0 + g * 4 * THREADS, n);
""", """\
    if (vec && i0 + g * 4 * THREADS + 4 <= n) {
      const uint4 q = __ldcg(
          reinterpret_cast<const uint4*>(x + i0 + g * 4 * THREADS));
      v[g][0] = q.x, v[g][1] = q.y, v[g][2] = q.z, v[g][3] = q.w;
    }
    const uint32_t key =
        stage_group<VBYTE>(bytes, at + excl[g], v[g], i0 + g * 4 * THREADS, n);
""")

# K7: the run written with one-byte stores only (no 16-byte interior)
K7_BYTE_STORES = ("bytesplit_encode.cu", """\
  const int64_t a0 = min(up, p1), a1 = max(a0, down);
""", """\
  const int64_t a0 = p1, a1 = a0;
""")

K7_STAGING = """\
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const uint32_t key =
        stage_group<VBYTE>(bytes, at + excl[g], v[g], i0 + g * 4 * THREADS, n);
    if (!VBYTE) keys[g * THREADS + threadIdx.x] = static_cast<uint8_t>(key);
    at += tot[g];
  }
"""
K7_LOOK_BACK = """\
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
"""
# K7: the look-back before the staging (warp 0 looks back while the others
# stage)
K7_LOOK_BACK_FIRST = [
    ("bytesplit_encode.cu", K7_STAGING, ""),
    ("bytesplit_encode.cu", K7_LOOK_BACK, K7_LOOK_BACK + K7_STAGING)]
# K7: no staging: after the look-back each thread stores its bytes straight
# into the stream, one byte at a time, as the earlier K7 did (vbyte only:
# the control bytes are not staged either)
K7_SCATTERED = [
    ("bytesplit_encode.cu", K7_STAGING, ""),
    ("bytesplit_encode.cu", """\
  const int64_t p0 = static_cast<int64_t>(excl_s);
""", """\
  const int64_t p0 = static_cast<int64_t>(excl_s);
  {
    uint32_t at = 0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      stage_group<VBYTE>(out + p0, at + excl[g], v[g],
                         i0 + g * 4 * THREADS, n);
      at += tot[g];
    }
  }
"""),
    ("bytesplit_encode.cu", """\
  const int64_t p1 = p0 + agg;
""", """\
  const int64_t p1 = p0;
""")]

# K9: each thread's 8 bytes before its granule read from device memory (L1
# or L2, where the neighbouring block's read left them) instead of shared
# memory
K9_GLOBAL_WALK = ("vbyte_decode.cu", """\
    const uint2 before = *reinterpret_cast<const uint2*>(sbytes + 16 * idx + 8);
""", """\
    const uint2 before = bytes_before(data, first + 16 * idx);
""")

# K9: the granule read with 16 byte loads (no 16-byte load)
K9_SCALAR_LOADS = ("vbyte_decode.cu", """\
  if (first >= 0 && first + CHUNK <= len) {
""", """\
  if (false) {
""")

# K9: the run written with 4-byte stores only (no 16-byte interior)
K9_WORD_STORES = ("vbyte_decode.cu", """\
  const int64_t a0 = min(up, max(e1, e0)), a1 = max(a0, down);
""", """\
  const int64_t a0 = max(e1, e0), a1 = a0;
""")

K9_STAGING = """\
  // the scan's barriers made the granules and the halo visible: each
  // granule's values from a window of its 16 bytes and the 8 before it
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + 1 + CHUNK / 16);
  int bad = CHUNK;  // the chunk's index of my first element past 5 bytes
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    const int idx = g * THREADS + threadIdx.x;
    int r = at + excl[g];  // the chunk's index of the granule's first value
    at += tot[g];
    const uint2 before = *reinterpret_cast<const uint2*>(sbytes + 16 * idx + 8);
    const uint4 q = smem[1 + idx];
    const uint32_t w[7] = {before.x, before.y, q.x, q.y, q.z, q.w, 0};
    // bytes outside the stream are 0, so a walk back stops at its start
    const uint32_t win = terminators(w[0]) | terminators(w[1]) << 4 |
                         terminators(w[2]) << 8 | terminators(w[3]) << 12 |
                         terminators(w[4]) << 16 | terminators(w[5]) << 20;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (mine[g] >> j & 1) {
        // continuation bytes before the terminator at window byte 8 + j
        const uint32_t below = win & ((1u << (8 + j)) - 1);
        const int k = 7 + j - (31 - __clz(below));
        if (k >= 5) bad = min(bad, r);
        vals[r++] = k >= 5 ? 0u : value_of(w, j + 1, min(k, 4));
      }
    }
  }
"""
K9_LOOK_BACK = """\
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
"""
# K9: the look-back before the values are rebuilt and staged
K9_LOOK_BACK_FIRST = [
    ("vbyte_decode.cu", K9_STAGING, ""),
    ("vbyte_decode.cu", K9_LOOK_BACK, K9_LOOK_BACK + K9_STAGING)]


def timeline_patches(fname: str, marks, end: str):
    """K7, K8 or K9 with a timeline: thread 0 of each block reads the global
    timer at its start, after the ticket, at each of the three `marks`
    (text, True to read after it or False before it) and at its end, and
    writes the six times past the scratch's words (the caller gives a longer
    scratch)."""
    tick = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk[{}]));\n'
    ticket = "  const int64_t chunk = lookback::take_ticket(ticket);\n"
    return [
        (fname, ticket, "  uint64_t clk[6];\n  " + tick.format(0) + ticket
         + "  " + tick.format(1)),
        *[(fname, text, text + "  " + tick.format(i) if after
           else "  " + tick.format(i) + text)
          for i, (text, after) in enumerate(marks, start=2)],
        (fname, end, end[:-2] + "  " + tick.format(5) + """\
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i)
      status[gridDim.x + 3 + 6 * chunk + i] = clk[i];
}
""")]


# K7 and K9: after the loads, counts and scan, before the look-back, after
# it (and the barrier behind it)
K7_TIMELINE = timeline_patches("bytesplit_encode.cu", [
    ("  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);\n", False),
    (K7_LOOK_BACK, False),
    ("  const int64_t p0 = static_cast<int64_t>(excl_s);\n", True)], """\
        for (int k = c; k < m; ++k) control[c0 + k] = keys[k];
      }
    }
  }
}
""")
K9_TIMELINE = timeline_patches("vbyte_decode.cu", [
    ("  // the scan's barriers made the granules and the halo visible: each\n",
     False),
    (K9_LOOK_BACK, False),
    ("  const int64_t e0 = static_cast<int64_t>(excl_s);  // the chunk's "
     "first element\n", True)], """\
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}
""")
BYTE_TIMELINE_PHASES = ("ticket", "loads, counts and scan", "staging",
                        "look-back", "writes")

# K8 (csrc/svb_decode.cu): the chunk's data staged in shared memory, then
# each control byte's values from five of its words
K8_STAGING = """\
  // the data [off, off + agg) as the granules of the address space that
  // hold it, the first `head` bytes of the first one before off: granule i
  // of the chunk is thread i % THREADS's load i / THREADS
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  const uintptr_t a0 = (base + off) & ~uintptr_t(15);
  const int head = static_cast<int>(base + off - a0);
  const int count = (head + static_cast<int>(agg) + 15) >> 4;
  uint4 q[LOADS];
  if (a0 >= base && a0 + 16 * count <= base + data_len) {
    const uint4* g0 = reinterpret_cast<const uint4*>(a0);
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k * THREADS < count)  // the same for the whole block
        q[k] = __ldg(g0 + min(k * THREADS + static_cast<int>(threadIdx.x),
                              count - 1));
  } else {
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k * THREADS < count)
        q[k] = load_edge(data, data_len,
                         off - head + 16 * (k * THREADS + threadIdx.x));
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k)
    if (k * THREADS + static_cast<int>(threadIdx.x) < count)
      staged[k * THREADS + threadIdx.x] = q[k];
  __syncthreads();
"""
K8_VALUES = """\
    values_of(words, head + start[g], ctrl[g], v);
"""
# K8: no staging; each element gathered byte by byte from device memory
# behind a check of the data length, as the earlier K8 gathered it (a
# thread's byte loads behind a loop of its own each)
K8_GATHER = [
    ("svb_decode.cu", K8_STAGING, ""),
    ("svb_decode.cu", K8_VALUES, """\
    int64_t p = off + start[g];
    for (int j = 0; j < 4; ++j) {
      const int len = 1 + ((ctrl[g] >> (2 * j)) & 3);
      v[j] = 0;
      if (p + len <= data_len) {
        for (int b = 0; b < len; ++b)
          v[j] |= static_cast<uint32_t>(data[p + b]) << (8 * b);
      }
      p += len;
    }
""")]
# K8: four 4-byte stores a control byte instead of one 16-byte store
K8_WORD_STORES = ("svb_decode.cu", """\
      *reinterpret_cast<uint4*>(out + e) = make_uint4(v[0], v[1], v[2], v[3]);
""", """\
#pragma unroll
      for (int j = 0; j < 4; ++j) out[e + j] = v[j];
""")
# K8 in two launches: a pass over the control bytes alone publishes every
# chunk's aggregate (chunk 0 its prefix), then the decode pass, whose
# look-back finds every status word published and never waits
K8_TWO_LAUNCHES = [
    ("svb_decode.cu", """\
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    svb_decode_kernel(""", """\
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    svb_aggregate_kernel(const uint8_t* __restrict__ control, int64_t n,
                         uint64_t* status) {
  __shared__ lane::ScanScratch scratch;
  uint32_t ctrl[BYTES];
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
  load_control(control, blockIdx.x, n, ctrl, cnt);
  int excl[lane::MAX_ROUNDS], tot[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(BYTES, cnt, excl, tot, scratch);
  uint32_t agg = 0;
#pragma unroll
  for (int g = 0; g < BYTES; ++g) agg += tot[g];
  if (threadIdx.x == 0)
    lookback::publish(status + blockIdx.x, agg,
                      blockIdx.x == 0 ? lookback::PREFIX
                                      : lookback::AGGREGATE);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    svb_decode_kernel("""),
    ("svb_decode.cu", """\
  svb_decode_kernel<<<""", """\
  svb_aggregate_kernel<<<static_cast<unsigned>(chunks), THREADS, 0, cs>>>(
      static_cast<const uint8_t*>(control), n,
      static_cast<uint64_t*>(scratch));
  svb_decode_kernel<<<""")]
# K8 with a timeline: before the look-back, after it (and the barrier
# behind it), after the data's staging
K8_LOOK_BACK = """\
  const uint64_t ex = lookback::exclusive_prefix<LOOK>(status, chunk, agg);
"""
K8_TIMELINE = timeline_patches("svb_decode.cu", [
    (K8_LOOK_BACK, False),
    ("  const int64_t off = static_cast<int64_t>(excl_s);  // the chunk's "
     "first byte\n", True),
    ("  // each control byte's four values, one 16-byte store (elements past "
     "n\n", False)], """\
        if (e + j < n) out[e + j] = v[j];
    }
  }
}
""")
K8_TIMELINE_PHASES = ("ticket", "control loads and scan", "look-back",
                      "data loads", "decode and stores")

# the earlier K7's, K8's and K9's C entry points: tile totals and offsets
# as scratch (earlier_scratch)
EARLIER_ENC_ARGTYPES = [ct.c_void_p, ct.c_int64, ct.c_int] + [ct.c_void_p] * 6
EARLIER_VB_DEC_ARGTYPES = [ct.c_void_p, ct.c_int64, ct.c_int64] + [
    ct.c_void_p] * 6
EARLIER_SVB_DEC_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_int64,
                            ct.c_int64] + [ct.c_void_p] * 6

# the earlier K1's C entry point: one stream, its length by value
EARLIER_SCAN_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int64,
                         ct.c_int, ct.c_int, ct.c_int] + [ct.c_void_p] * 4

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
                     "place", "bytesplit_encode", "svb_decode",
                     "vbyte_decode"):
            build._libs.pop(name, None)


def _place(packed, nb, excw, n: int) -> torch.Tensor:
    """The stream through the placement as this tree has it: the single
    pass, or (an older tree, under --baseline) the plain round totals and
    the earlier K2."""
    if "round_base" in inspect.signature(place.place).parameters:
        round_base, total = lane_codec.encode_totals(packed, nb, n)
        return place.place(packed, nb, excw, n, round_base, int(total))
    return place.place(packed, nb, excw, n)[0]


def earlier_place(packed, nb, excw, n: int, total: int):
    """The earlier K2 (built from earlier_csrc/place.cu inside its
    Variant) as the earlier prepared encoder called it: round_base from the
    plain round totals, the launch, one sync on its error flag."""
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


def earlier_k2(cell):
    """The earlier K2 with round_base given, on buffers allocated once (as
    earlier_k7 gives K7): (launch, result), result() the launch and the sync
    on its error flag."""
    T, S = cell.packed.shape
    round_base, _ = lane_codec.encode_totals(cell.packed, cell.nb, cell.n)
    total = cell.stream.numel()
    stream = torch.empty(total, dtype=torch.uint8, device=DEVICE)
    err = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    fn = build.function("place", EARLIER_PLACE_ARGTYPES)
    args = (build.ptr(cell.packed), build.ptr(cell.nb), build.ptr(cell.excw),
            cell.n, T, S, build.ptr(round_base), build.ptr(stream), total,
            build.ptr(err), build.current_stream(torch.device(DEVICE)))

    def launch():
        build.check("place", fn(*args))

    def result():
        err.zero_()
        launch()
        if err.item():
            raise RuntimeError("the earlier K2 wrote past the stream")
        return stream
    return launch, result


class LaneCell:
    """ANSfold-2 on bench.py's input (the main path), staged as encode()
    stages it, with K1's words and K2's stream as the kernels as they are
    write them."""

    def __init__(self, label: str, values):
        self.label = label
        # (six items in an older tree: no header yet)
        codec = AnsFold(2, device=DEVICE)
        mapped, k, low, pfreqs, ffreqs, raw = codec._enc_inputs(values)[:6]
        self.n = int(mapped.shape[0])
        self.T = lane_codec.lane_steps(self.n, LANES)
        self.enc, (self.mapped, self.nb, self.excw) = _stage(
            mapped, k, low, self.n, ffreqs, raw, LANES)
        self.packed, self.states = self.scan()
        self.stream = _place(self.packed, self.nb, self.excw, self.n)
        table = codec._table(pfreqs)
        self.dec = tables.to_device(table, DEVICE)
        self.direct = tables.to_device(tables.materialize_slots(table),
                                       DEVICE)

    def scan(self):
        return encode.encode_scan(self.mapped, self.n, self.enc)

    def decode(self, kernel: str):
        """K4 (the rule's engine) or K3 on the stream, as the prepared
        decoder calls them."""
        if kernel == "K4":
            return decode.decode_direct(self.stream, self.states,
                                        self.direct, self.n, self.T)
        return decode.decode_search(self.stream, self.states, self.dec,
                                    self.n, self.T)


def earlier_scan(cell: LaneCell):
    """The earlier K1 (built from earlier_csrc/encode_scan.cu inside its
    Variant) through its own C entry point: one stream, its length by
    value; (packed, states) as the scan as it is gives them."""
    T, S = cell.mapped.shape
    dev = torch.device(DEVICE)
    packed = torch.empty((T, S), dtype=torch.int32, device=dev)
    states = torch.empty(S, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function("encode_scan", EARLIER_SCAN_ARGTYPES)
    build.check("encode_scan", fn(
        build.ptr(cell.mapped), build.ptr(cell.enc.words),
        cell.enc.words.shape[0], cell.n, T, S, cell.enc.log2m,
        build.ptr(packed), build.ptr(states), build.ptr(err),
        build.current_stream(dev)))
    if err.item():
        raise RuntimeError("the earlier K1 flagged a symbol")
    return packed, states


def time_k1(cell: LaneCell, what: str, scan=None) -> float:
    scan = scan or cell.scan
    packed, states = scan()
    if not (torch.equal(packed, cell.packed)
            and torch.equal(states, cell.states)):
        raise RuntimeError(f"{cell.label}: K1 variant {what} scans wrongly")
    return cuda_ms(scan)


def time_place(cell, what: str, fn, launch=None) -> float:
    """fn() -> stream, held against the stream as it is; then launch()
    timed (the launch alone, k2_launch), or fn() where there is none."""
    if not torch.equal(fn()[:cell.stream.numel()], cell.stream):
        raise RuntimeError(f"{cell.label}: K2 variant {what} places wrongly")
    return cuda_ms(launch or fn)


def k2_launch(cell):
    """K2's launch as its wrapper makes it, on buffers allocated once (so
    inside the Variant that built it): the status words and the ticket
    zeroed, then the kernel."""
    from .ops.place import _ARGTYPES
    T, S = cell.packed.shape
    total = cell.stream.numel()
    stream = torch.empty(total, dtype=torch.uint8, device=DEVICE)
    scratch = torch.zeros(2 * (T + 1), dtype=torch.int64, device=DEVICE)
    status = scratch[T + 1:]
    n = lane_codec.batch_of_one(torch.device(DEVICE), cell.n)
    fn = build.function("place", _ARGTYPES)
    args = (build.ptr(cell.packed), build.ptr(cell.nb), build.ptr(cell.excw),
            build.ptr(n), 1, T, S, build.ptr(stream), total,
            build.ptr(scratch), build.ptr(status),
            build.current_stream(torch.device(DEVICE)))

    def go():
        status.zero_()
        build.check("place", fn(*args))
    return go


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
            n = lane_codec.batch_of_one(torch.device(DEVICE), cell.n)
            build.check("place", fn(
                build.ptr(cell.packed), build.ptr(cell.nb),
                build.ptr(cell.excw), build.ptr(n), 1, T, S,
                build.ptr(stream), total, build.ptr(scratch),
                build.ptr(scratch[T + 1:]),
                build.current_stream(torch.device(DEVICE))))
            torch.cuda.synchronize()
        if not torch.equal(stream[:total], cell.stream):
            raise RuntimeError(f"{cell.label}: K2 with its timeline places "
                               "wrongly")
        clk = stream[head:].cpu().numpy().view(np.int64).reshape(T, 6)
    emit_timeline(cell, "K2", clk, TIMELINE_PHASES, emit)


def emit_timeline(cell, kernel: str, clk, phases, emit) -> None:
    """A kernel's timeline, (chunks, 6) global-timer readings: the median
    of each phase over the blocks, the blocks' mean time, the kernel's
    span, and how many blocks were in flight on average (their summed time
    over the span)."""
    import numpy as np
    clk = clk - clk[:, 0].min()
    span = clk[:, 5].max()
    for i, phase in enumerate(phases):
        emit(cell, kernel, f"timeline: {phase} (median)",
             float(np.median(clk[:, i + 1] - clk[:, i])) / 1e6)
    emit(cell, kernel, "timeline: a block (mean)",
         float((clk[:, 5] - clk[:, 0]).mean()) / 1e6)
    emit(cell, kernel, "timeline: span", float(span) / 1e6)
    recs_in_flight = float((clk[:, 5] - clk[:, 0]).sum() / span)
    print(f"{cell.label}: {kernel} blocks in flight on average "
          f"{recs_in_flight:.1f}; start of every 1024th chunk (us): "
          f"{[round(float(x) / 1e3, 1) for x in clk[::1024, 0]]}")


def k2_rows(cell, emit) -> None:
    """The earlier K2 with the plain round totals in front (through the
    call, as the earlier prepared encoder made it) and alone, each design
    step taken back, the timeline, and as it is; each row but the first
    the launch alone (time_place), the kernel as it is also through its
    wrapper."""
    args = (cell.packed, cell.nb, cell.excw, cell.n)
    total = cell.stream.numel()

    def placed():
        return place.place(*args, total)[0]

    with Variant("k2_earlier", [], earlier=["place.cu"]):
        emit(cell, "K2", "earlier + totals", time_place(
            cell, "earlier + totals", lambda: earlier_place(*args, total)))
        launch, result = earlier_k2(cell)
        emit(cell, "K2", "earlier", time_place(cell, "earlier", result,
                                               launch))
    for step, patches in (("narrow look-back", [NARROW_LOOK_BACK]),
                          ("look-back eight words a lane", [WIDE_LOOK_BACK]),
                          ("block index", [BLOCK_INDEX]),
                          ("relaxed publish", [RELAXED_PUBLISH]),
                          ("pause in the look-back", [PAUSE]),
                          ("look-back before staging", LOOK_BACK_FIRST),
                          ("staging loads at once", [STAGE_UNROLLED]),
                          ("two steps a chunk", [TWO_STEPS_A_CHUNK]),
                          ("four lanes a thread", FOUR_LANES_A_THREAD),
                          ("byte stores", [BYTE_STORES])):
        with Variant("k2_" + step.replace(" ", "_").replace("-", "_"),
                     patches):
            emit(cell, "K2", step, time_place(cell, step, placed,
                                              k2_launch(cell)))
    with Variant("k2_no_look_back", [NO_LOOK_BACK]):
        emit(cell, "K2", "no look-back", cuda_ms(k2_launch(cell)))
    if cell.packed.shape[1] >= 512:  # one step a chunk
        k2_timeline(cell, emit)
    with Variant("final", []):
        emit(cell, "K2", "as it is", time_place(cell, "as it is", placed,
                                                k2_launch(cell)))
        emit(cell, "K2", "as it is, through the wrapper", cuda_ms(placed))


class ByteCell:
    """The byte path's input on the card, with the vbyte and streamvbyte
    streams K7 as it is writes (K9 reads the vbyte one, K8 the streamvbyte
    one)."""

    def __init__(self, label: str, values):
        self.label = label
        self.x = torch.from_numpy(values.view("<i4")).to(DEVICE)
        self.n = self.x.numel()
        self.vb = bytesplit.vbyte_encode(self.x)
        self.svb = bytesplit.svb_encode(self.x)


def time_bytes(cell, kernel: str, what: str, fn, want, launch) -> float:
    """fn() (the wrapper) -> what the kernel as it is gives (`want`),
    checked; then launch() timed: the launch alone, its scratch zeroed in
    front, none of the wrapper's host work or its sync."""
    got = fn()
    same = (all(torch.equal(a, b) for a, b in zip(got, want))
            if isinstance(want, tuple) else torch.equal(got, want))
    if not same:
        raise RuntimeError(f"{cell.label}: {kernel} variant {what} differs")
    return cuda_ms(launch)


def k7_launch(x, vbyte: bool):
    """K7's launch as its wrapper makes it, on buffers allocated once (so
    inside the Variant that built it): the status fill, then the kernel."""
    n = x.numel()
    chunks = bytesplit.encode_chunks(n)
    scratch = bytesplit.chained_scratch(chunks, x.device)
    out = torch.empty((5 if vbyte else 4) * n, dtype=torch.uint8,
                      device=x.device)
    control = torch.empty(-(-n // 4), dtype=torch.uint8, device=x.device)
    fn = build.function("bytesplit_encode", bytesplit._ENC_ARGTYPES)
    args = (build.ptr(x), n, int(vbyte), build.ptr(out), build.ptr(control),
            build.ptr(scratch), chunks, build.current_stream(x.device))

    def go():
        scratch.zero_()
        build.check("bytesplit_encode", fn(*args))
    return go


def k9_launch(data, n: int):
    """K9's launch as its wrapper makes it (see k7_launch)."""
    chunks = bytesplit.decode_chunks(data.numel(), data.data_ptr())
    scratch = bytesplit.chained_scratch(chunks, data.device)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    fn = build.function("vbyte_decode", bytesplit._VB_DEC_ARGTYPES)
    args = (build.ptr(data), data.numel(), n, build.ptr(out),
            build.ptr(scratch), chunks, build.current_stream(data.device))

    def go():
        scratch.zero_()
        build.check("vbyte_decode", fn(*args))
    return go


def k8_launch(control, data, n: int):
    """K8's launch as its wrapper makes it (see k7_launch)."""
    chunks = bytesplit.svb_chunks(n)
    scratch = bytesplit.chained_scratch(chunks, data.device)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    fn = build.function("svb_decode", bytesplit._SVB_DEC_ARGTYPES)
    args = (build.ptr(control), build.ptr(data), data.numel(), n,
            build.ptr(out), build.ptr(scratch), chunks,
            build.current_stream(data.device))

    def go():
        scratch.zero_()
        build.check("svb_decode", fn(*args))
    return go


def earlier_scratch(items: int, dev):
    """The earlier three-launch K7-K9's (tile totals i32, tile offsets i64,
    grand total i64) of a scan over `items` items."""
    ntiles = -(-items // bytesplit.TILE)
    return (torch.empty(ntiles, dtype=torch.int32, device=dev),
            torch.empty(ntiles, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev))


def earlier_k7(x, vbyte: bool):
    """The earlier K7 (built from earlier_csrc/ inside its Variant) on
    buffers allocated once: (launch, result), launch() its three launches
    alone, result() the launches and the sync on the stream's length, giving
    what its wrapper gave."""
    n = x.numel()
    tot, off, total = earlier_scratch(n, x.device)
    out = torch.empty((5 if vbyte else 4) * n, dtype=torch.uint8,
                      device=x.device)
    control = torch.empty(-(-n // 4), dtype=torch.uint8, device=x.device)
    fn = build.function("bytesplit_encode", EARLIER_ENC_ARGTYPES)
    args = (build.ptr(x), n, int(vbyte), build.ptr(tot), build.ptr(off),
            build.ptr(out), build.ptr(control), build.ptr(total),
            build.current_stream(x.device))

    def launch():
        build.check("bytesplit_encode", fn(*args))

    def result():
        launch()
        stream = out[: int(total.item())]
        return stream if vbyte else (control, stream)
    return launch, result


def earlier_k9(data, n: int):
    """The earlier K9 as earlier_k7 gives K7: its flag word zeroed in front
    of the launches, result() raising where its wrapper raised."""
    tot, off, total = earlier_scratch(data.numel(), data.device)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    err = torch.zeros(1, dtype=torch.int32, device=data.device)
    fn = build.function("vbyte_decode", EARLIER_VB_DEC_ARGTYPES)
    args = (build.ptr(data), data.numel(), n, build.ptr(tot), build.ptr(off),
            build.ptr(out), build.ptr(total), build.ptr(err),
            build.current_stream(data.device))

    def launch():
        err.zero_()
        build.check("vbyte_decode", fn(*args))

    def result():
        launch()
        if err.item():
            raise RuntimeError("the earlier K9 flagged the stream")
        return out
    return launch, result


def earlier_k8(control, data, n: int):
    """The earlier K8 as earlier_k9 gives K9."""
    tot, off, total = earlier_scratch(n, data.device)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    err = torch.zeros(1, dtype=torch.int32, device=data.device)
    fn = build.function("svb_decode", EARLIER_SVB_DEC_ARGTYPES)
    args = (build.ptr(control), build.ptr(data), data.numel(), n,
            build.ptr(tot), build.ptr(off), build.ptr(out), build.ptr(total),
            build.ptr(err), build.current_stream(data.device))

    def launch():
        err.zero_()
        build.check("svb_decode", fn(*args))

    def result():
        launch()
        if err.item():
            raise RuntimeError("the earlier K8 flagged the stream")
        return out
    return launch, result


@contextlib.contextmanager
def chunk_items(kernel: str, items: int):
    """The wrapper of K7, K8 or K9 sizing its scratch for chunks of
    `items`."""
    name = {"K7": "ENCODE_CHUNK", "K8": "SVB_CHUNK",
            "K9": "DECODE_CHUNK"}[kernel]
    kept = getattr(bytesplit, name)
    setattr(bytesplit, name, items)
    try:
        yield
    finally:
        setattr(bytesplit, name, kept)


def byte_timeline(cell, kernel: str, patches, fn, want, emit,
                  phases=BYTE_TIMELINE_PHASES) -> None:
    """K7, K8 or K9 as it is with its timeline (K7_TIMELINE, K8_TIMELINE,
    K9_TIMELINE): the wrapper's scratch is given room for six times a
    chunk."""
    kept = []

    def longer(chunks, dev):
        kept.append((chunks, torch.zeros(7 * chunks + 3, dtype=torch.int64,
                                         device=dev)))
        return kept[-1][1]

    with Variant(f"{kernel.lower()}_timeline", patches), \
            mock.patch.object(bytesplit, "chained_scratch", longer):
        for _ in range(2):  # the second run is read
            got = fn()
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"{cell.label}: {kernel} with its timeline "
                           "differs")
    chunks, scratch = kept[-1]
    emit_timeline(cell, kernel, scratch[chunks + 3:].cpu().numpy().reshape(
        chunks, 6), phases, emit)


def k7_rows(cell: ByteCell, emit) -> None:
    """K7 on the vbyte format unless a row says otherwise: the earlier
    three launches, each design step taken back, the chunk sizes, the
    timeline, and as it is; each row the launch alone (time_bytes), the
    kernel as it is also through its wrapper."""
    x = cell.x

    def vbyte():
        return bytesplit.vbyte_encode(x)

    def svb():
        return bytesplit.svb_encode(x)

    with Variant("k7_earlier", [], earlier=["bytesplit_encode.cu",
                                            "bytescan.cuh"]):
        for step, is_vbyte, want in (("earlier", True, cell.vb),
                                     ("earlier, streamvbyte", False,
                                      cell.svb)):
            launch, result = earlier_k7(x, is_vbyte)
            emit(cell, "K7", step, time_bytes(cell, "K7", step, result, want,
                                              launch))
    fname = "bytesplit_encode.cu"
    for step, patches in (("a branch before each load", [K7_BRANCHED_LOADS]),
                          ("scalar loads", [K7_SCALAR_LOADS]),
                          ("values read again", [K7_READ_AGAIN]),
                          ("byte stores", [K7_BYTE_STORES]),
                          ("scattered, no staging", K7_SCATTERED),
                          ("look-back before staging", K7_LOOK_BACK_FIRST),
                          ("narrow look-back", [NARROW_BYTE_LOOK_BACK]),
                          ("wide look-back", [WIDE_BYTE_LOOK_BACK]),
                          ("registers uncapped", [uncapped(fname)])):
        with Variant("k7_" + step.replace(" ", "_").replace(",", ""),
                     patches):
            emit(cell, "K7", step, time_bytes(cell, "K7", step, vbyte,
                                              cell.vb, k7_launch(x, True)))
    with Variant("k7_no_look_back", [NO_BYTE_LOOK_BACK]):
        emit(cell, "K7", "no look-back", cuda_ms(k7_launch(x, True)))
    for threads in (64, 512, 1024):
        with Variant(f"k7_threads{threads}", byte_threads(fname, threads)), \
                chunk_items("K7", 16 * threads):
            step = f"chunks of {16 * threads}"
            emit(cell, "K7", step, time_bytes(cell, "K7", step, vbyte,
                                              cell.vb, k7_launch(x, True)))
    byte_timeline(cell, "K7", K7_TIMELINE, vbyte, cell.vb, emit)
    with Variant("final", []):
        emit(cell, "K7", "as it is", time_bytes(
            cell, "K7", "as it is", vbyte, cell.vb, k7_launch(x, True)))
        emit(cell, "K7", "as it is, streamvbyte", time_bytes(
            cell, "K7", "as it is, streamvbyte", svb, cell.svb,
            k7_launch(x, False)))
        emit(cell, "K7", "as it is, through the wrapper", cuda_ms(vbyte))
        emit(cell, "K7", "as it is, streamvbyte, through the wrapper",
             cuda_ms(svb))


def k9_rows(cell: ByteCell, emit) -> None:
    """K9 on the vbyte stream: the earlier three launches, each design
    step taken back, the chunk sizes, a stream at an odd address, the
    timeline, and as it is (as k7_rows)."""
    n, vb = cell.n, cell.vb
    want = cell.x

    def dec():
        return bytesplit.vbyte_decode(vb, n)

    with Variant("k9_earlier", [], earlier=["vbyte_decode.cu",
                                            "bytescan.cuh"]):
        launch, result = earlier_k9(vb, n)
        emit(cell, "K9", "earlier", time_bytes(cell, "K9", "earlier", result,
                                               want, launch))
    fname = "vbyte_decode.cu"
    for step, patches in (("a branch before each load", [K9_BRANCHED_LOADS]),
                          ("scalar loads", [K9_SCALAR_LOADS]),
                          ("walk-back in global memory", [K9_GLOBAL_WALK]),
                          ("values by element, after the look-back",
                           K9_BY_ELEMENT),
                          ("4-byte stores", [K9_WORD_STORES]),
                          ("look-back before staging", K9_LOOK_BACK_FIRST),
                          ("narrow look-back", [NARROW_BYTE_LOOK_BACK]),
                          ("wide look-back", [WIDE_BYTE_LOOK_BACK]),
                          ("registers uncapped", [uncapped(fname)])):
        with Variant("k9_" + step.replace(" ", "_"), patches):
            emit(cell, "K9", step, time_bytes(cell, "K9", step, dec, want,
                                              k9_launch(vb, n)))
    with Variant("k9_no_look_back", [NO_BYTE_LOOK_BACK]):
        emit(cell, "K9", "no look-back", cuda_ms(k9_launch(vb, n)))
    for threads in (32, 128, 512):
        with Variant(f"k9_threads{threads}", byte_threads(fname, threads)), \
                chunk_items("K9", 32 * threads):
            step = f"chunks of {32 * threads}"
            emit(cell, "K9", step, time_bytes(cell, "K9", step, dec, want,
                                              k9_launch(vb, n)))
    byte_timeline(cell, "K9", K9_TIMELINE, dec, want, emit)
    with Variant("final", []):
        emit(cell, "K9", "as it is", time_bytes(
            cell, "K9", "as it is", dec, want, k9_launch(vb, n)))
        odd = torch.cat([vb.new_zeros(1), vb])[1:]
        emit(cell, "K9", "as it is, stream at an odd address", time_bytes(
            cell, "K9", "odd address", lambda: bytesplit.vbyte_decode(odd, n),
            want, k9_launch(odd, n)))
        emit(cell, "K9", "as it is, through the wrapper", cuda_ms(dec))


def k8_rows(cell: ByteCell, emit) -> None:
    """K8 on the streamvbyte stream: the earlier three launches, each
    design step taken back, two launches, the chunk sizes, the data at an
    odd address, the timeline, and as it is (as k7_rows)."""
    n, (ctrl, data) = cell.n, cell.svb
    want = cell.x

    def dec():
        return bytesplit.svb_decode(ctrl, data, n)

    with Variant("k8_earlier", [], earlier=["svb_decode.cu",
                                            "bytescan.cuh"]):
        launch, result = earlier_k8(ctrl, data, n)
        emit(cell, "K8", "earlier", time_bytes(cell, "K8", "earlier", result,
                                               want, launch))
    fname = "svb_decode.cu"
    for step, patches in (("byte loads behind a branch", K8_GATHER),
                          ("4-byte stores", [K8_WORD_STORES]),
                          ("two launches", K8_TWO_LAUNCHES),
                          ("look-back two words a lane", [k8_look(2)]),
                          ("look-back eight words a lane", [k8_look(8)]),
                          ("registers uncapped", [uncapped(fname)]),
                          ("five blocks an SM", [K8_FIVE_BLOCKS])):
        with Variant("k8_" + step.replace(" ", "_").replace("-", "_"),
                     patches):
            emit(cell, "K8", step, time_bytes(cell, "K8", step, dec, want,
                                              k8_launch(ctrl, data, n)))
    with Variant("k8_no_look_back", [NO_BYTE_LOOK_BACK]):
        emit(cell, "K8", "no look-back", cuda_ms(k8_launch(ctrl, data, n)))
    for threads in (128, 512):
        with Variant(f"k8_threads{threads}", byte_threads(fname, threads)), \
                chunk_items("K8", 16 * threads):
            step = f"chunks of {16 * threads}"
            emit(cell, "K8", step, time_bytes(cell, "K8", step, dec, want,
                                              k8_launch(ctrl, data, n)))
    byte_timeline(cell, "K8", K8_TIMELINE, dec, want, emit,
                  K8_TIMELINE_PHASES)
    with Variant("final", []):
        emit(cell, "K8", "as it is", time_bytes(
            cell, "K8", "as it is", dec, want, k8_launch(ctrl, data, n)))
        # the stream as the codecs hand it over: the data right behind the
        # control bytes
        joined = torch.cat([ctrl, data])
        jc, jd = joined[:ctrl.numel()], joined[ctrl.numel():]
        emit(cell, "K8", "as it is, data behind the control bytes",
             time_bytes(cell, "K8", "data behind the control bytes",
                        lambda: bytesplit.svb_decode(jc, jd, n), want,
                        k8_launch(jc, jd, n)))
        emit(cell, "K8", "as it is, through the wrapper", cuda_ms(dec))


class Cell:
    """One input staged as the codec's encode() and decode() stage it, with
    the stream the kernels as they are write and read."""

    def __init__(self, label: str, codec, values):
        self.label = label
        mapped, k, low, pfreqs, ffreqs, raw = codec._enc_inputs(
            values)[:6]
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
            if kernels & {"K1", "K2", "K3", "K4"} else None)
    cells = [
        Cell("ANSfold-7 on zipf20", AnsFold(7, device=DEVICE),
             zipf20_input(1 << log2n)),
        Cell("ANS on dense22", AnsInt(device=DEVICE),
             dense_input(1 << (20 if args.quick else 22)))
    ] if kernels & {"K2", "K5", "K6"} else []
    byte = (ByteCell("the byte path, zipf20", zipf20_input(1 << log2n))
            if kernels & {"K7", "K8", "K9"} else None)
    recs = []

    def emit(cell, kernel, step, ms):
        recs.append({"cell": cell.label, "n": cell.n, "kernel": kernel,
                     "step": step, "ms": ms})
        print(f"[{smi}] {cell.label} n={cell.n} {kernel} {step}: {ms:.3f} ms",
              flush=True)

    if args.baseline:
        if "K1" in kernels:
            emit(lane, "K1", "as it is", cuda_ms(lane.scan))
        for kernel in ("K3", "K4"):
            if kernel in kernels:
                emit(lane, kernel, "as it is",
                     cuda_ms(lambda k=kernel: lane.decode(k)))
        for cell in [lane, *cells] if "K2" in kernels else []:
            emit(cell, "K2", "as it is", cuda_ms(lambda: _place(
                cell.packed, cell.nb, cell.excw, cell.n)))
        for cell in cells:
            if "K5" in kernels:
                emit(cell, "K5", "as it is",
                     cuda_ms(lambda: cell.decode(cell.dec)))
            if "K6" in kernels:
                emit(cell, "K6", "as it is", cuda_ms(cell.scan))
        if "K7" in kernels:
            emit(byte, "K7", "as it is", cuda_ms(
                lambda: bytesplit.vbyte_encode(byte.x)))
        if "K8" in kernels:
            emit(byte, "K8", "as it is", cuda_ms(
                lambda: bytesplit.svb_decode(*byte.svb, byte.n)))
        if "K9" in kernels:
            emit(byte, "K9", "as it is", cuda_ms(
                lambda: bytesplit.vbyte_decode(byte.vb, byte.n)))
        if "PE" in kernels:
            from . import models
            for label, name, x in (
                    ("ANSfold-2 on bench input", "ANSfold-2",
                     bench_input(1 << log2n, 42)),
                    ("ANSfold-7 on zipf20", "ANSfold-7",
                     zipf20_input(1 << log2n))):
                pe = models.prepare_encoder(name, x, lanes=LANES,
                                            device=DEVICE)
                emit(types.SimpleNamespace(label=label, n=len(x)), "PE",
                     "prepared encode", cuda_ms(pe, PE_RUNS))
                del pe
    else:
        if "K1" in kernels:
            with Variant("k1_earlier", [], earlier=["encode_scan.cu"]):
                emit(lane, "K1", "earlier", time_k1(
                    lane, "earlier", lambda: earlier_scan(lane)))
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
        if "K7" in kernels:
            k7_rows(byte, emit)
        if "K8" in kernels:
            k8_rows(byte, emit)
        if "K9" in kernels:
            k9_rows(byte, emit)
    text = json.dumps({"card": smi, "runs": RUNS, "lanes": LANES,
                       "steps": recs})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
