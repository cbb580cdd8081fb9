// The lockstep decode step of K3, K4 and K5, designed for Hopper: the byte
// reads of one step for the lanes of one block.
//
// What it computes: a lane reads rc renorm bytes (round j < 3 holds every
// lane's j-th one) and ne exception bytes (round 3 + j), each round's bytes
// lie in lane order, and the rounds follow each other from the cursor.
// How:
//
//   * static round slots.  Three renorm and (NES = 3) three exception slots
//     or (NES = 0) none; a round nobody reads in has count zero.  Nothing is
//     indexed by a run-time round number, so nothing lives in local memory.
//   * one packed scan.  A thread's count in a round is at most 16 and a
//     warp's at most 512, so three rounds share one 32-bit word, ten bits
//     each: one 5-stage shuffle scan serves three rounds (two words for
//     six).
//   * one barrier a step.  Each warp publishes its packed totals; after the
//     barrier every warp reads all (at most 32) of them itself, one per
//     lane, and a warp-wide integer reduction (redux.sync) per round gives
//     the round's offset for this warp, with the earlier rounds' totals
//     folded in.  The scratch is double-buffered by the caller (step & 1).
//   * the stream staged in shared memory (Stream<true>).  The cursor only
//     moves forward and a step consumes at most step_max = S * rounds
//     bytes, so a ring of at least 2 * step_max + 16 bytes is refilled by
//     16-byte cp.async copies one step ahead of its use: started right
//     after the barrier of step t, awaited before the barrier of step t+1.
//     A lane's byte is then a shared-memory load.  The stream is addressed
//     from its 16-byte aligned-down base; the first granule is loaded byte
//     by byte from the stream's first byte on, and the last, partial one is
//     copied with its true size (the rest zero-filled), so nothing outside
//     [stream, stream + length) is read.
//   * or, where the tables leave no room for a ring (Stream<false>), the
//     same step on global loads (each checked against the stream's end),
//     with an L2 prefetch ahead of the cursor.
//   * one window a round.  A thread's lanes are neighbours in lane order,
//     so what they read in one round is one run of bytes: one offset, one
//     bounds check and one (funnel-shifted) load per round and group of
//     four lanes, then a byte-permute per lane hands the bytes out.  No
//     per-lane address, and the only branches are uniform (a round the
//     frame lacks is skipped); a step that reads at or past the end of the
//     stream sets `bad`, as before, and what is decoded then is dropped.
//
// With 1024 threads the block is bound by how many instructions its 32
// warps execute and by the shared-memory and shuffle units' throughput, not
// by the latency of one thread's chain (the probe's chains at 1024 threads
// show it): the step is written for few instructions first.
#pragma once

#include "common.cuh"

namespace lockstep {

using lane::FULL_MASK;

constexpr int FIELD_BITS = 10;
constexpr uint32_t FIELD_MASK = (1u << FIELD_BITS) - 1;

// Packed words of per-round counts: word 0 the renorm rounds, word 1 (NES
// = 3) the exception rounds.
template <int NES>
struct Rounds {
  static_assert(NES == 0 || NES == 3, "exception slots: none or three");
  static constexpr int NW = NES ? 2 : 1;
};

// One in each of the first k (0..3) fields: the rounds a lane with k
// exception bytes reads in.
__device__ __forceinline__ uint32_t fields(int k) {
  return 0x00100401u & ((1u << (FIELD_BITS * k)) - 1u);
}

// Before the barrier: the warp's inclusive scan of the packed counts;
// excl is this thread's exclusive prefix inside its warp, and lane 31
// publishes the warp's totals in sw[word][warp].
template <int NW>
__device__ __forceinline__ void warp_scan_publish(const uint32_t (&cnt)[NW],
                                                  uint32_t (&excl)[NW],
                                                  uint32_t (*sw)[32]) {
  const int ln = threadIdx.x & 31;
  uint32_t incl[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) incl[w] = cnt[w];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, incl[w], d);
      if (ln >= d) incl[w] += y;
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    excl[w] = incl[w] - cnt[w];
    if (ln == 31) sw[w][threadIdx.x >> 5] = incl[w];
  }
}

// After the barrier: base[3 * w + r] is the offset from the cursor of the
// first byte this warp's lanes read in round r of word w (the earlier
// rounds' block totals plus the earlier warps' counts in this round), and
// total the bytes of the whole step.  Lane i holds warp i's totals.  Every
// slot is reduced, also one the frame lacks.  With `if (r < rounds) base =
// __reduce_add_sync(...)` here, a branch on the (uniform) round count,
// ptxas -O3 of CUDA 12.9 gave code that decoded wrongly, the same way on
// every run and already with one warp (S = 32); the same source built with
// -Xptxas -O0 or with -G decoded exactly (NVIDIA H100 80GB HBM3).
template <int NW>
__device__ __forceinline__ void block_bases(const uint32_t (*sw)[32],
                                            uint32_t (&base)[3 * NW],
                                            uint32_t& total) {
  const int ln = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t run = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t word = ln < nwarps ? sw[w][ln] : 0u;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const uint32_t f = (word >> (FIELD_BITS * r)) & FIELD_MASK;
      base[3 * w + r] =
          __reduce_add_sync(FULL_MASK, run + (ln < warp ? f : 0u));
      run += f;
    }
  }
  total = __reduce_add_sync(FULL_MASK, run);
}

__device__ __forceinline__ void cp_async16(uint8_t* smem_dst,
                                           const uint8_t* gmem_src,
                                           uint32_t src_bytes) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const uint8_t* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The stream as one block reads it.  Offsets count from `data`: the stream
// itself (RING = false), or its 16-byte aligned-down base (RING = true), in
// which case the stream's first byte is at offset `lead`.  Offsets are 32
// bits wide: the wrapper refuses a stream of 2^31 bytes or more.  Every
// thread of the block holds the same cursor and calls every method.
template <bool RING>
struct Stream {
  const uint8_t* data;
  uint32_t end;       // offsets below it hold stream bytes
  uint32_t cursor;    // offset of the next unread byte (it passes `end`
                      // only on a corrupt stream, by less than 2^31)
  uint32_t step_max;  // the most one step consumes
  // RING only: `ring` holds granule g (16 bytes) at 16 g mod ring_bytes
  uint8_t* ring;
  uint32_t mask;      // ring_bytes - 1 (a power of two)
  uint32_t granules;  // ceil(end / 16)
  uint32_t filled;    // granules below it have been requested

  // Must be followed by a __syncthreads() before the first step.
  // ring_bytes is a power of two >= 2 * step_max + 16.
  __device__ __forceinline__ void begin(const uint8_t* stream,
                                        uint32_t stream_len,
                                        uint32_t step_max_, uint8_t* ring_,
                                        uint32_t ring_bytes) {
    step_max = step_max_;
    if constexpr (RING) {
      const uint32_t lead =
          static_cast<uint32_t>(reinterpret_cast<uintptr_t>(stream) & 15u);
      data = stream - lead;
      end = lead + stream_len;
      cursor = lead;
      ring = ring_;
      mask = ring_bytes - 1;
      granules = stream_len ? (end + 15) >> 4 : 0;
      // the first granule byte by byte: nothing below the stream is read
      if (threadIdx.x < 16 && granules > 0) {
        const uint32_t j = threadIdx.x;
        ring[j] = (j >= lead && j < end) ? data[j] : uint8_t(0);
      }
      filled = granules > 0 ? 1 : 0;
      fill();
      wait();
    } else {
      data = stream;
      end = stream_len;
      cursor = 0;
      ahead();
    }
  }

  // Bytes from the cursor to the end of the stream.
  __device__ __forceinline__ uint32_t left() const {
    return cursor < end ? end - cursor : 0u;
  }

  // Request every granule the ring has room for: those below the cursor's
  // own granule are free once the step's barrier has passed.
  __device__ __forceinline__ void fill() {
    if constexpr (RING) {
      const uint32_t limit = min(granules, (cursor >> 4) + ((mask + 1) >> 4));
      for (uint32_t g = filled + threadIdx.x; g < limit; g += blockDim.x) {
        const uint32_t at = g << 4;
        cp_async16(ring + (at & mask), data + at, min(end - at, 16u));
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      filled = max(filled, limit);
    }
  }

  // RING = false: bring the lines of the next step into L2.
  __device__ __forceinline__ void ahead() {
    if constexpr (!RING) {
      const uint32_t p = cursor + step_max + threadIdx.x * 128u;
      if (threadIdx.x * 128u < step_max && p < end) prefetch_l2(data + p);
    }
  }

  // This thread's requests have landed (visible to the block after the
  // next barrier).
  __device__ __forceinline__ void wait() {
    if constexpr (RING) asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

// The renorm-round word of a lane whose state (after the symbol step) is
// st: a one in field j when st < thr[j], the j-th renorm threshold (0 for a
// round the frame does not have).
__device__ __forceinline__ uint32_t renorm_need(uint32_t st,
                                                const uint32_t (&thr)[3]) {
  return (st < thr[0] ? 1u : 0u) | (st < thr[1] ? 1u << FIELD_BITS : 0u) |
         (st < thr[2] ? 1u << (2 * FIELD_BITS) : 0u);
}

// The byte reads of one step for the LPT lanes of this thread.  need[0][l]
// has a one in field j when lane l reads a renorm byte in round j (shifted
// into st[l]), need[1][l] (NES = 3) when it reads an exception byte in
// round 3 + j (shifted into low[l]); both high-first; fields j >= NR of
// word 0 and j >= NE of word 1 are zero in every lane.  A thread's lanes
// are neighbours in lane order, so the bytes its lanes read in one round
// lie side by side in the stream: the thread takes them as one window of
// up to four bytes per group of four lanes (two aligned words of the ring
// and a funnel shift) and hands them out in lane order.  The step's bytes
// are one run from the cursor, so one comparison of its total against the
// bytes left decides `bad`.  sw is this step's scratch, [NW][32] words, the
// caller alternating two of them.  One __syncthreads(); every thread of
// the block calls it.
template <int LPT, int NES, bool RING>
__device__ __forceinline__ void read_step(
    Stream<RING>& s, int NR, int NE,
    const uint32_t (&need)[Rounds<NES>::NW][LPT], uint32_t (&st)[LPT],
    uint32_t (&low)[LPT], bool& bad, uint32_t (*sw)[32]) {
  constexpr int NW = Rounds<NES>::NW;
  constexpr int G = LPT < 4 ? LPT : 4;  // lanes that share a window
  // The groups unroll fully up to 8 lanes a thread; the 16-lane instance
  // (S = 16384) keeps its loops rolled (fully unrolled, ptxas -O3 of CUDA 12.9
  // gave code that read the later rounds' bytes at wrong positions).
  constexpr int GROUP_UNROLL = LPT <= 8 ? LPT / G : 1;
  uint32_t cnt[NW] = {};
#pragma unroll GROUP_UNROLL
  for (int g = 0; g < LPT / G; ++g)
#pragma unroll
    for (int l = 0; l < G; ++l)
#pragma unroll
      for (int w = 0; w < NW; ++w) cnt[w] += need[w][g * G + l];
  uint32_t run[NW];
  warp_scan_publish<NW>(cnt, run, sw);
  s.wait();
  __syncthreads();
  s.fill();
  uint32_t base[3 * NW], total;
  block_bases<NW>(sw, base, total);

  const uint32_t rem = s.left();
  bad |= total > rem;
  const uint32_t q = s.cursor;
  const uint8_t* from = s.data + q;
  const uint32_t* ring32 = reinterpret_cast<const uint32_t*>(s.ring);
#pragma unroll GROUP_UNROLL
  for (int g = 0; g < LPT / G; ++g) {
    uint32_t mine[NW] = {};  // this group's counts
#pragma unroll
    for (int l = 0; l < G; ++l)
#pragma unroll
      for (int w = 0; w < NW; ++w) mine[w] += need[w][g * G + l];
#pragma unroll
    for (int r = 0; r < 3 * NW; ++r) {
      const int w = r / 3, sh = FIELD_BITS * (r % 3);
      if (r % 3 >= (w == 0 ? NR : NE)) continue;  // the frame lacks it
      const uint32_t o = base[r] + ((run[w] >> sh) & FIELD_MASK);
      uint32_t win;
      if constexpr (RING && G == 1) {
        win = s.ring[(q + o) & s.mask];
      } else if constexpr (RING) {
        const uint32_t a = (q + o) & s.mask;
        // (the funnel shift takes its amount modulo 32)
        win = __funnelshift_r(ring32[a >> 2], ring32[((a + 4) & s.mask) >> 2],
                              8 * a);
      } else {
        const uint32_t k = (mine[w] >> sh) & FIELD_MASK;  // bytes to take
        win = 0;
#pragma unroll
        for (int i = 0; i < G; ++i)
          win |= (i < k && o + i < rem ? uint32_t(from[o + i]) : 0u)
                 << (8 * i);
      }
#pragma unroll
      for (int l = 0; l < G; ++l) {
        const bool take = need[w][g * G + l] & (1u << sh);
        uint32_t& dst = w == 0 ? st[g * G + l] : low[g * G + l];
        dst = take ? __byte_perm(dst, win, 0x2104) : dst;  // dst << 8 | byte
        win = take ? win >> 8 : win;
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) run[w] += mine[w];
  }
  s.cursor = total > rem ? s.end : q + total;  // never past the end
  s.ahead();
}

// Store the LPT consecutive i32 outputs of a thread: 16-byte stores where a
// thread owns four lanes or more (dst is then 16-byte aligned: the row
// length and the thread's first lane are multiples of four).
template <int LPT>
__device__ __forceinline__ void store_lanes(int32_t* dst,
                                            const uint32_t (&v)[LPT]) {
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int l = 0; l < LPT; l += 4)
      *reinterpret_cast<int4*>(dst + l) =
          make_int4(static_cast<int>(v[l]), static_cast<int>(v[l + 1]),
                    static_cast<int>(v[l + 2]), static_cast<int>(v[l + 3]));
  } else {
#pragma unroll
    for (int l = 0; l < LPT; ++l) dst[l] = static_cast<int32_t>(v[l]);
  }
}

}  // namespace lockstep
