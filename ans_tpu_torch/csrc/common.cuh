// Shared pieces of the lane-engine kernels: the fmt-2 constants and the
// block-wide exclusive scan that turns per-thread byte-round counts into
// ranks in lane order.
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

// Threads per block for a kernel that spreads S lanes over one block.
inline int block_threads(int S) {
  if (S >= 1024) return 1024;
  return S < 32 ? 32 : S;
}

}  // namespace lane

extern "C" const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
