// A chained scan with decoupled look-back across the blocks of one launch
// (K2, K7, K8, K9).
//
// Blocks run in no order.  A block takes its chunk of consecutive items by
// an atomic ticket, so every chunk before it is held by a block that has
// already started and the look-back never waits on a block that has not.
// Each chunk has one 64-bit status word, zeroed by the caller before the
// launch: (value << 2) | flag, so that a flag and its value are read
// together and no ordering between words is needed.  A block publishes its
// aggregate (AGGREGATE) as soon as it has counted, and its inclusive prefix
// (PREFIX) once its look-back has found its exclusive one; chunk 0 publishes
// its prefix at once.
#pragma once

#include "common.cuh"

namespace lookback {

constexpr uint64_t AGGREGATE = 1, PREFIX = 2;  // flags of a status word
// status words a lane reads in one round trip unless the kernel says
// otherwise: 64 chunks a window.  Wider windows (K2's 8) lost on the byte
// kernels: hundreds of short blocks poll the same few lines of the status
// array, and each wider read slowed the others
constexpr int LOOK = 2;

// The chunk of this block: thread 0 draws the ticket, every thread returns
// it (one barrier; every thread of the block must call it).
__device__ __forceinline__ int64_t take_ticket(unsigned int* ticket) {
  __shared__ int64_t chunk_s;
  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1u);
  __syncthreads();
  return chunk_s;
}

__device__ __forceinline__ void publish(uint64_t* p, uint64_t value,
                                        uint64_t flag) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p),
               "l"((value << 2) | flag)
               : "memory");
}

// A status word as it stands: relaxed, so that a lane's loads are all in
// flight at once (the flag and its value are one word; nothing else is read
// on the strength of it).
__device__ __forceinline__ uint64_t status_of(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v += __shfl_xor_sync(lane::FULL_MASK, v, d);
  return v;
}

// The sum of the values of all chunks before `chunk` (> 0), by one whole
// warp: lane i reads the status words of chunks chunk - 1 - WORDS i - k
// (k < WORDS), 32 WORDS chunks a window, nearest first.  The nearest chunk
// with its prefix ends the walk, and the walk waits only for the words
// between it and `chunk`: a word past it is not waited for, so a slow block
// further back holds no one up.  A window without a prefix is waited for
// whole, its aggregates are added, and the walk goes a window further back.
template <int WORDS = LOOK>
__device__ __forceinline__ uint64_t look_back(const uint64_t* status,
                                              int64_t chunk) {
  const int me = threadIdx.x & 31;
  uint64_t excl = 0;
  for (int64_t j0 = chunk - 1 - WORDS * me;; j0 -= 32 * WORDS) {
    uint64_t sum;
    int last;  // the first lane holding a prefix, 32 if none
    while (true) {
      uint64_t w[WORDS];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        // before chunk 0: a prefix of 0 (loaded from chunk 0's word and
        // replaced, so that no load waits on a condition)
        const int64_t j = j0 - k;
        const uint64_t v = status_of(status + (j >= 0 ? j : 0));
        w[k] = j >= 0 ? v : PREFIX;
      }
      // this lane's values back to its nearest prefix, or all of them, and
      // whether a word among those is unpublished
      sum = 0;
      bool found = false, waiting = false;
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        if (!found) {
          sum += w[k] >> 2;
          waiting |= (w[k] & 3) == 0;
        }
        found |= (w[k] & 3) == PREFIX;
      }
      const unsigned prefixes = __ballot_sync(lane::FULL_MASK, found);
      last = prefixes ? __ffs(prefixes) - 1 : 32;
      if (!__any_sync(lane::FULL_MASK, waiting && me <= last)) break;
    }
    if (last < 32) return excl + warp_sum(me <= last ? sum : 0);
    excl += warp_sum(sum);
  }
}

// The exclusive prefix of `chunk`, whose own value is `agg`, by warp 0 of
// the block (the other warps return 0 and must not read it): it looks back
// (chunk 0 need not), WORDS status words a lane, and publishes the chunk's
// inclusive prefix.
template <int WORDS = LOOK>
__device__ __forceinline__ uint64_t exclusive_prefix(uint64_t* status,
                                                     int64_t chunk,
                                                     uint64_t agg) {
  if (threadIdx.x >= 32) return 0;
  const uint64_t ex = chunk == 0 ? 0 : look_back<WORDS>(status, chunk);
  if (threadIdx.x == 0 && chunk > 0) publish(status + chunk, ex + agg, PREFIX);
  return ex;
}

}  // namespace lookback
