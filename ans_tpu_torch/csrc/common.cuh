// Shared pieces of the lane-engine kernels: the fmt-2 constants, the
// encode step of K1 and K6, the block-wide exclusive scan that turns
// per-thread byte-round counts into ranks in lane order, and the byte
// reads of one lockstep decode step as K5 makes them (K3 and K4 take the
// step of lockstep.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lane {

constexpr uint32_t A_L = 1u << 23;  // state lies in [A_L, 2^31)
constexpr int MAX_ROUNDS = 6;       // 3 renorm + 3 exception rounds a step
constexpr unsigned FULL_MASK = 0xffffffffu;

// Shared scratch of one scan: warp totals per round, then each warp's
// exclusive offset, with the block total in slot 32.
struct ScanScratch {
  int w[MAX_ROUNDS][33];
};

// Block-wide exclusive scan of `nch` counters per thread, in thread order.
// blockDim.x must be a multiple of 32 and at most 1024; every thread of the
// block must call it.  Two barriers; a caller that scans again before all
// threads have read this result passes a second ScanScratch (double
// buffering) instead of adding a third barrier.
__device__ __forceinline__ void block_exclusive_scan(
    int nch, const int (&cnt)[MAX_ROUNDS], int (&excl)[MAX_ROUNDS],
    int (&total)[MAX_ROUNDS], ScanScratch& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl[MAX_ROUNDS];
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < nch) {
      int v = cnt[r];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(FULL_MASK, v, d);
        if (lane >= d) v += y;
      }
      incl[r] = v;
      if (lane == 31) s.w[r][warp] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r) {
      if (r < nch) {
        int own = lane < nwarps ? s.w[r][lane] : 0;
        int v = own;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          int y = __shfl_up_sync(FULL_MASK, v, d);
          if (lane >= d) v += y;
        }
        s.w[r][lane] = v - own;
        if (lane == 31) s.w[r][32] = v;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < nch) {
      excl[r] = s.w[r][warp] + incl[r] - cnt[r];
      total[r] = s.w[r][32];
    }
  }
}

// x / d for d >= 2 by the Granlund-Montgomery multiply-high (exact for every
// u32 x; d == 1 is selected around by the caller).
__device__ __forceinline__ uint32_t gm_div(uint32_t x, uint32_t d,
                                           uint32_t magic) {
  const uint32_t mh = __umulhi(x, magic);
  return (mh + ((x - mh) >> 1)) >> (31 - __clz(d - 1));  // ceil(log2 d)-1
}

// One encode step of a lane (K1, K6): emit up to three renorm bytes while
// state >= ub = f << (31 - log2m), divide by f with the Granlund-Montgomery
// magic (f == 1 around it), state = (q << log2m) + r + base.  Returns the
// packed word r0 | r1<<8 | r2<<16 | rc<<24: byte slot i is the low byte of
// the state after the first i conditional shifts, emitted or not.
__device__ __forceinline__ uint32_t encode_step(uint32_t& st, uint32_t f,
                                                uint32_t base, uint32_t magic,
                                                int log2m) {
  const uint32_t ub = f << (31 - log2m);
  const uint32_t b0 = st & 0xFF;
  const uint32_t e0 = st >= ub;
  if (e0) st >>= 8;
  const uint32_t b1 = st & 0xFF;
  const uint32_t e1 = st >= ub;
  if (e1) st >>= 8;
  const uint32_t b2 = st & 0xFF;
  const uint32_t e2 = st >= ub;
  if (e2) st >>= 8;
  const uint32_t q = f == 1 ? st : gm_div(st, f, magic);
  const uint32_t r = st - q * f;
  st = (q << log2m) + r + base;
  return b0 | (b1 << 8) | (b2 << 16) | ((e0 + e1 + e2) << 24);
}

// The byte reads of one lockstep decode step (K5), for the LPT lanes of
// this thread.  rc[l] renorm bytes (round j < NR holds every lane's j-th
// one) and ne[l] exception bytes (round NR + j) are known before any read,
// so each round's block-wide exclusive scan gives a lane its rank, and its
// byte sits at cursor + (the earlier rounds' totals) + rank.  Renorm bytes
// are shifted into st[l], exception bytes into low[l], both high-first.  A
// read at or past stream_len sets `bad` and reads 0.  Every thread of the
// block calls it; returns the cursor after the step.
template <int LPT>
__device__ __forceinline__ int64_t read_merge(
    const uint8_t* __restrict__ stream, int64_t stream_len, int64_t cursor,
    int NR, int NE, const int (&rc)[LPT], const int (&ne)[LPT],
    uint32_t (&st)[LPT], uint32_t (&low)[LPT], bool& bad, ScanScratch& s) {
  // The lane loops unroll fully up to 8 lanes a thread.  The 16-lane
  // instance (S = 16384) stays rolled: fully unrolled, ptxas -O3 of CUDA
  // 12.9 gave code that read the later rounds' bytes at wrong positions
  // from the second step on, while -Xptxas -O0 and the rolled loop decode
  // exactly (tests/test_torch_cuda.py holds S = 16384).
  constexpr int LANE_UNROLL = LPT <= 8 ? LPT : 1;
  int cnt[MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
#pragma unroll LANE_UNROLL
  for (int l = 0; l < LPT; ++l) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < NR) cnt[j] += rc[l] > j;
      if (j < NE) cnt[NR + j] += ne[l] > j;
    }
  }
  int excl[MAX_ROUNDS], tot[MAX_ROUNDS];
  block_exclusive_scan(NR + NE, cnt, excl, tot, s);

  // stream position of this thread's next byte in each round
  int64_t pos[MAX_ROUNDS];
  int64_t base = cursor;
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < NR + NE) {
      pos[r] = base + excl[r];
      base += tot[r];
    }
  }
#pragma unroll LANE_UNROLL
  for (int l = 0; l < LPT; ++l) {
    uint32_t v = st[l];
    uint32_t lo = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < NR && rc[l] > j) {
        const int64_t p = pos[j]++;
        const bool in = p < stream_len;
        bad |= !in;
        v = (v << 8) | (in ? stream[p] : 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < NE && ne[l] > j) {
        const int64_t p = pos[NR + j]++;
        const bool in = p < stream_len;
        bad |= !in;
        lo = (lo << 8) | (in ? stream[p] : 0u);
      }
    }
    st[l] = v;
    low[l] = lo;
  }
  return base;
}

// Threads per block for a kernel that spreads S lanes over one block.
inline int block_threads(int S) {
  if (S >= 1024) return 1024;
  return S < 32 ? 32 : S;
}

}  // namespace lane

extern "C" const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
