// The encode scan with its lookups taken off the state chain (K6; K1 can
// take the same header).
//
// A lane's scan walks its T steps from the last to the first, and each step
// needs the row [f, base, magic] of the step's symbol before it can move the
// state.  Finding the row is a chain of dependent loads (the symbol from
// device memory, then its rank and group or its table row) several times
// longer than the step's arithmetic, but it does not depend on the state:
// all T x S rows could be found at once.  So the rows run ahead of the
// chain:
//
//   * a block owns L = 32 * CHAIN_WARPS lanes and walks T in tiles of D
//     steps, from the last tile to the first;
//   * while the block's chain warps (one thread a lane) run the D steps of
//     tile k, reading each step's row with one shared-memory load, its
//     lookup warps resolve the D x L rows of tile k - 1 into the other half
//     of a double-buffered shared-memory tile, LOOKUPS of them in flight a
//     thread, having asked for the symbols of tile k - 2 to be brought
//     into L2 meanwhile; one barrier a tile hands the halves over.
//
// The chain then costs what the state's own dependent arithmetic costs
// (python3 -m ans_tpu_torch.probe, chain encode_step), and the lookups
// only need to keep up with it.
#pragma once

#include "common.cuh"

namespace ahead {

constexpr int D = 32;            // steps a tile
constexpr int CHAIN_WARPS = 1;   // chain warps a block (timed: 1, 2, 4)
constexpr int L = 32 * CHAIN_WARPS;  // lanes a block owns
constexpr int LOOKUP_WARPS = 8;  // lookup warps per chain warp (timed: 3-8)
constexpr int LOOKUPS = 4;       // lookups in flight a thread
constexpr int THREADS = L * (1 + LOOKUP_WARPS);  // the block
static_assert(LOOKUP_WARPS * LOOKUPS == D,
              "a lookup thread resolves its lane's share of a tile in one "
              "batch");

// The block's dynamic shared memory: the two tile halves first, then what
// the kernel keeps behind them.  The tile and the kernel's tables are
// addressed from this array, so that every access is a shared-memory load
// by construction (through a pointer handed down, it was a generic one).
extern __shared__ int4 smem[];

constexpr int TILE_ROWS = 2 * D * L;  // rows (16 bytes) of both halves

// Resolve the rows of steps [tile * D, tile * D + D) for the block's lanes
// [lane0, lane0 + L) into smem[at + d * L + l], by the block's L *
// LOOKUP_WARPS lookup threads of which this is `tid`: a thread keeps one
// lane and takes every LOOKUP_WARPS-th step of it, so a warp reads 32
// neighbouring positions of one step.  Positions past n, T or S get a zero
// row.  find.fetch(idx) loads what the input holds at position idx,
// find.prefetch(idx) asks for it to be brought near (the positions this thread
// fetches in the tile after this one), and find.rows(x, in, row) turns a
// batch of LOOKUPS inputs (those with in[b] set) into rows [f, base, magic,
// 0], advancing the batch's dependent loads together so that LOOKUPS
// independent chains are in flight.
template <typename Find>
__device__ __forceinline__ void fill_tile(int at, int tile, int T, int S,
                                          int lane0, int64_t n, int tid,
                                          const Find& find) {
  const int l = tid % L, d0 = tid / L;
  const int lane = lane0 + l;
  uint32_t x[LOOKUPS];
  bool in[LOOKUPS];
#pragma unroll
  for (int b = 0; b < LOOKUPS; ++b) {
    const int t = tile * D + d0 + b * LOOKUP_WARPS;
    const int64_t idx = static_cast<int64_t>(t) * S + lane;
    in[b] = t < T && lane < S && idx < n;
    // the load itself is unconditional (a position outside reads position
    // 0): selecting its result here would wait for it, one load at a time
    x[b] = find.fetch(in[b] ? idx : 0);
    // one request a warp: its lanes' positions share a 128-byte line
    if (l % 32 == 0 && tile > 0 && lane < S)
      find.prefetch(idx - static_cast<int64_t>(D) * S);
  }
  int4 row[LOOKUPS];
  find.rows(x, in, row);
#pragma unroll
  for (int b = 0; b < LOOKUPS; ++b)
    smem[at + (d0 + b * LOOKUP_WARPS) * L + l] = row[b];
}

// The chain of one lane (global index `lane`, `l` inside the block) over
// the steps of one tile at smem[at ..], last first: one lane::encode_step a
// step, its row loaded one step before it is needed.  Positions past n are
// the scan's last steps (one at most when T = ceil(n / S); more in a short
// stream of a batch, whose T is that of its longest): such a pad position
// emits no bytes and keeps the state, and they are dealt with before the
// loop, which then has no branch on the chain.
__device__ __forceinline__ void chain_tile(int at, int tile, int T, int S,
                                           int lane, int l, int64_t n,
                                           int log2m, uint32_t& st,
                                           int32_t* __restrict__ packed) {
  const int t0 = tile * D;
  int d = (T - t0 < D ? T - t0 : D) - 1;
  int64_t idx = static_cast<int64_t>(t0 + d) * S + lane;
  for (; d >= 0 && idx >= n; --d, idx -= S) {
    const uint32_t b = st & 0xFF;
    packed[idx] = static_cast<int32_t>(b | (b << 8) | (b << 16));
  }
  if (d < 0) return;
  int4 next = smem[at + d * L + l];
  for (; d >= 0; --d, idx -= S) {
    const int4 row = next;
    if (d > 0) next = smem[at + (d - 1) * L + l];
    packed[idx] = static_cast<int32_t>(lane::encode_step(
        st, static_cast<uint32_t>(row.x), static_cast<uint32_t>(row.y),
        static_cast<uint32_t>(row.z), log2m));
  }
}

// The whole scan of one block of THREADS threads, the first L of them the
// chains, the others the lookups; the tile takes the first TILE_ROWS rows
// of smem.  Every thread of the block calls it (it holds barriers); the
// tables `find` reads must be in place.
template <typename Find>
__device__ __forceinline__ void scan_block(int T, int S, int64_t n,
                                           int log2m, const Find& find,
                                           int32_t* __restrict__ packed,
                                           int32_t* __restrict__ states) {
  const int lane0 = blockIdx.x * L;
  const int tid = threadIdx.x;
  const bool chains = tid < L;
  const int lane = lane0 + tid;
  const int ntiles = (T + D - 1) / D;
  uint32_t st = lane::A_L;
  if (!chains && ntiles > 0)
    fill_tile(((ntiles - 1) & 1) * D * L, ntiles - 1, T, S, lane0, n,
              tid - L, find);
  __syncthreads();
  for (int tile = ntiles - 1; tile >= 0; --tile) {
    if (chains) {
      if (lane < S)
        chain_tile((tile & 1) * D * L, tile, T, S, lane, tid, n, log2m, st,
                   packed);
    } else if (tile > 0) {
      fill_tile(((tile - 1) & 1) * D * L, tile - 1, T, S, lane0, n, tid - L,
                find);
    }
    __syncthreads();
  }
  if (chains && lane < S) states[lane] = static_cast<int32_t>(st);
}

}  // namespace ahead
