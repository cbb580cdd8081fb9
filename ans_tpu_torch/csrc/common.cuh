// Shared pieces of the lane-engine kernels: the fmt-2 constants, the
// encode step of K1 and K6, the Granlund-Montgomery divide, and the
// block-wide exclusive scan that turns per-thread byte-round counts into
// ranks in lane order (K2; the decodes K3-K5 take the step of
// lockstep.cuh).
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

// The row of stream b in a batch's model array (ops/model_batch.py): the
// i32 words of `Model` at models + stride * b.  A model the whole batch
// shares is one row, read with stride 0.
template <typename Model>
__device__ __forceinline__ Model model_row(const int32_t* __restrict__ models,
                                           int stride, int b) {
  static_assert(sizeof(Model) % sizeof(int32_t) == 0, "a row of i32 words");
  Model m;
  int32_t* w = reinterpret_cast<int32_t*>(&m);
  const int32_t* r = models + static_cast<int64_t>(stride) * b;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(Model) / sizeof(int32_t)); ++i)
    w[i] = __ldg(r + i);
  return m;
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
