// The header the earlier K7, K8 and K9 included, kept here since it left
// csrc/ with them (bench_steps copies it over its copy of csrc/ with them).
// Shared pieces of the byte-splitter kernels (K7, K8, K9): each is a scan
// over variable-length items whose result drives a scatter or a gather.
// All three run the same three launches: a tile's total per block, one
// block that turns the tile totals into exclusive offsets, and the tile
// pass that writes or reads at offset + in-tile prefix.
#pragma once

#include "common.cuh"

namespace bytescan {

constexpr int THREADS = 256;  // per block of the tile kernels
constexpr int ITEMS = 4;      // items per thread: one control byte's worth
constexpr int TILE = THREADS * ITEMS;

// Block-wide exclusive scan of one counter per thread, in thread order;
// `total` receives the block's sum.  blockDim.x must be a multiple of 32
// and at most 1024, sh holds 33 ints, and every thread of the block must
// call it.  Two barriers; a second call on the same sh needs a barrier of
// its own in between.
__device__ __forceinline__ int block_exclusive_scan1(int v, int& total,
                                                     int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(lane::FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < nwarps ? sh[lane] : 0;
    int w = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(lane::FULL_MASK, w, d);
      if (lane >= d) w += y;
    }
    sh[lane] = w - own;
    if (lane == 31) sh[32] = w;
  }
  __syncthreads();
  total = sh[32];
  return sh[warp] + incl - v;
}

// One block: tile totals -> exclusive tile offsets, and the grand total.
// It walks the ntiles totals in chunks of blockDim.x with a running carry.
static __global__ void __launch_bounds__(1024)
scan_totals_kernel(const int32_t* __restrict__ tot, int64_t ntiles,
                   int64_t* __restrict__ off, int64_t* __restrict__ total) {
  __shared__ int sh[33];
  int64_t carry = 0;
  for (int64_t base = 0; base < ntiles; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int v = i < ntiles ? tot[i] : 0;
    int chunk;
    __syncthreads();  // the previous chunk's reads of sh are done
    const int excl = block_exclusive_scan1(v, chunk, sh);
    if (i < ntiles) off[i] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

inline int64_t tiles(int64_t items) { return (items + TILE - 1) / TILE; }

}  // namespace bytescan
