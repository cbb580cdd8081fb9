// The card's step probe: how long one primitive takes when each one needs
// the last one's result.
//
// Replaces the TPU tool tools/mosaic_probe.py (`_mk` / `run`): a serial
// dependency chain of one primitive, ITERS * UNROLL deep, timed per op.
// What is carried over is what it measures, not its list of ops: the
// Mosaic rolls and row lookups are the TPU's building blocks; here the
// chains are the ones csrc/*.cu are built from.
//
// One block of `threads` threads (32: one warp; 1024: the block shape of
// the lockstep decodes K3/K4).  Every thread starts from its input value,
// applies the chain's primitive iters * UNROLL times, and writes its final
// value; thread 0 also writes the SM clock before and after the loop.  The
// values are integers, and ans_tpu_torch/probe.py computes every chain's
// final values in plain PyTorch: kernel against plain is exact.
//
// What bounds it: nothing to compare against.  A probe moves no data worth
// a bytes bound and its work is the latency it measures; its run time is
// iters * UNROLL times the primitive's latency by construction.
//
// Chains (the `chain` argument):
//    0 add            v += p0 (inline PTX, so the chain is not folded)
//    1 cmp_select     v = v >= p0 ? v - p0 : v + p1
//    2 shift_or       v = (v >> 1) | p0
//    3 umulhi         v = __umulhi(v, p0) + p1   (the encode's divide)
//    4 shfl_up        v = (lane ? shfl_up(v, 1) : v) + 1
//    5 ballot_popc    v += popc(ballot(v & 1) & lanemask_lt)
//    6 smem_load      v = tab[v & 4095] (a 16 KB table in shared memory)
//    7 lookup2        K4's lookup: e = rows[slot_sym[v & (M-1)]];
//                     v = e.x * (v >> log2m) + (v & (M-1)) - e.y + e.z
//    8 syncthreads    v += 1; __syncthreads()
//    9 gload          v = (v + buf[v & (buf_len-1)]) * 2654435761 + 12345:
//                     a dependent one-byte global load (buf_len a power of
//                     two; a buffer inside L2 or far past it)
//   15 redux_add      v += __reduce_add_sync(v & 3): the warp-wide integer
//                     reduction lockstep's block_bases is built from
//   10 scan_old       lane::block_exclusive_scan over six rounds, counts
//                     (v >> 2r) & 3: v = v * 1664525 + 1 + the sum over the
//                     rounds of this thread's byte offset + the step total
//   11 scan_new       the same values from lockstep's packed scan
//   12 read_old       one lockstep byte read as the decodes made it before
//                     lockstep.cuh (read_merge below, kept here for the
//                     comparison): LPT lanes a thread (4 at 1024 threads,
//                     else 1), rc = v & 3, ne = (v >> 2) & 3;
//                     v = (st ^ low) * 2654435761 + 1
//   13 read_global    the same by lockstep::read_step on global loads
//   14 read_ring      the same through the shared-memory ring
//   16 encode_step    K6's state chain: one lane::encode_step a step, its
//                     row [f, base, magic] read from a shared-memory tile at
//                     an address the state does not enter; v is the state
//                     (started at A_L | v & (A_L - 1)), and the final value
//                     is the state plus the sum of the packed words
//   17 group_search   K5's lookup: slot = v & (M-1); the bucket load,
//                     `levels` probes, the group row, the divide and the
//                     per-rank table load; v = ((f * (v >> log2m) + x - j*f)
//                     ^ table[rank]) * 2654435761 + 1
#include "lockstep.cuh"

namespace {

constexpr int UNROLL = 16;
constexpr uint32_t GOLD = 2654435761u;

// The grouped frame of chain 17 (K5's tables) and the row tile of chain 16.
struct Grouped {
  const int4* groups;       // (NG, 4) rows [f, magic, slot0, rank0]
  const int32_t* bases;     // the groups' first slots
  const uint16_t* buckets;  // ((M - 1 >> shift) + 1,)
  const int32_t* table;     // (sigma,) per-rank value
  int NG, levels, shift, sigma, log2m;
  const int4* enc_rows;     // (enc_count, 4) rows [f, base, magic, 0]
  int enc_count, enc_log2m;
};

struct Args {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tab;
  const uint16_t* slot_g;
  const int4* rows_g;
  int sigma, log2m;
  const uint8_t* buf;
  int64_t buf_len;
  uint32_t p0, p1, ring_bytes;
  int iters;
  long long* cycles;
  Grouped g;
};

// The byte reads of one lockstep decode step as K3-K5 made them before
// lockstep.cuh: rc[l] renorm bytes (round j < NR holds every lane's j-th
// one) and ne[l] exception bytes (round NR + j); each round's block-wide
// exclusive scan (two barriers) gives a lane its rank, and its byte sits at
// cursor + (the earlier rounds' totals) + rank: one conditional global byte
// load per lane and round.  A read at or past stream_len sets `bad` and
// reads 0.  Returns the cursor after the step.
template <int LPT>
__device__ __forceinline__ int64_t read_merge(
    const uint8_t* __restrict__ stream, int64_t stream_len, int64_t cursor,
    int NR, int NE, const int (&rc)[LPT], const int (&ne)[LPT],
    uint32_t (&st)[LPT], uint32_t (&low)[LPT], bool& bad,
    lane::ScanScratch& s) {
  constexpr int MAX_ROUNDS = lane::MAX_ROUNDS;
  int cnt[MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < NR) cnt[j] += rc[l] > j;
      if (j < NE) cnt[NR + j] += ne[l] > j;
    }
  }
  int excl[MAX_ROUNDS], tot[MAX_ROUNDS];
  lane::block_exclusive_scan(NR + NE, cnt, excl, tot, s);

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
#pragma unroll
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

template <int CHAIN>
__device__ __forceinline__ uint32_t op(uint32_t v, const Args& a,
                                       const uint32_t* tab,
                                       const uint16_t* slot_sym,
                                       const int4* rows) {
  if constexpr (CHAIN == 0) {
    asm volatile("add.u32 %0, %0, %1;" : "+r"(v) : "r"(a.p0));
    return v;
  } else if constexpr (CHAIN == 1) {
    return v >= a.p0 ? v - a.p0 : v + a.p1;
  } else if constexpr (CHAIN == 2) {
    return (v >> 1) | a.p0;
  } else if constexpr (CHAIN == 3) {
    return __umulhi(v, a.p0) + a.p1;
  } else if constexpr (CHAIN == 4) {
    const uint32_t y = __shfl_up_sync(lane::FULL_MASK, v, 1);
    return ((threadIdx.x & 31) ? y : v) + 1;
  } else if constexpr (CHAIN == 5) {
    const uint32_t lt = (1u << (threadIdx.x & 31)) - 1u;
    return v + __popc(__ballot_sync(lane::FULL_MASK, v & 1) & lt);
  } else if constexpr (CHAIN == 6) {
    return tab[v & 4095];
  } else if constexpr (CHAIN == 7) {
    const uint32_t M = 1u << a.log2m;
    const uint32_t slot = v & (M - 1);
    const int4 e = rows[slot_sym[slot]];
    return static_cast<uint32_t>(e.x) * (v >> a.log2m) + slot -
           static_cast<uint32_t>(e.y) + static_cast<uint32_t>(e.z);
  } else if constexpr (CHAIN == 8) {
    __syncthreads();
    return v + 1;
  } else if constexpr (CHAIN == 15) {
    return v + __reduce_add_sync(lane::FULL_MASK, v & 3u);
  } else {
    static_assert(CHAIN == 9, "a scalar chain");
    return (v + a.buf[v & static_cast<uint32_t>(a.buf_len - 1)]) * GOLD +
           12345u;
  }
}

// chains 0-9 and 15: one value a thread
template <int CHAIN>
__global__ void __launch_bounds__(1024) scalar_kernel(Args a) {
  extern __shared__ int4 smem[];
  __shared__ uint32_t tab[CHAIN == 6 ? 4096 : 1];
  int4* rows = smem;
  uint16_t* slot_sym = reinterpret_cast<uint16_t*>(rows + a.sigma);
  if constexpr (CHAIN == 6)
    for (int i = threadIdx.x; i < 4096; i += blockDim.x) tab[i] = a.tab[i];
  if constexpr (CHAIN == 7) {
    for (int i = threadIdx.x; i < a.sigma; i += blockDim.x)
      rows[i] = a.rows_g[i];
    for (int i = threadIdx.x; i < (1 << a.log2m); i += blockDim.x)
      slot_sym[i] = a.slot_g[i];
  }
  uint32_t v = a.x[threadIdx.x];
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < a.iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = op<CHAIN>(v, a, tab, slot_sym, rows);
  }
  const long long t1 = clock64();
  a.out[threadIdx.x] = v;
  if (threadIdx.x == 0) {
    a.cycles[0] = t0;
    a.cycles[1] = t1;
  }
}

// chains 10, 11: one block scan a step
template <bool NEW>
__global__ void __launch_bounds__(1024) scan_kernel(Args a) {
  __shared__ lane::ScanScratch old_scratch[2];
  __shared__ uint32_t scratch[2][2][32];
  uint32_t v = a.x[threadIdx.x];
  __syncthreads();
  const long long t0 = clock64();
  const int steps = a.iters * UNROLL;
  for (int i = 0; i < steps; ++i) {
    uint32_t sum = 0;
    if constexpr (NEW) {
      uint32_t cnt[2] = {0, 0}, excl[2], base[6], total;
#pragma unroll
      for (int r = 0; r < 6; ++r)
        cnt[r / 3] |= ((v >> (2 * r)) & 3u) << (lockstep::FIELD_BITS * (r % 3));
      lockstep::warp_scan_publish<2>(cnt, excl, scratch[i & 1]);
      __syncthreads();
      lockstep::block_bases<2>(scratch[i & 1], base, total);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        sum += base[r] + ((excl[r / 3] >> (lockstep::FIELD_BITS * (r % 3))) &
                          lockstep::FIELD_MASK);
      sum += total;
    } else {
      int cnt[lane::MAX_ROUNDS], excl[lane::MAX_ROUNDS],
          tot[lane::MAX_ROUNDS];
#pragma unroll
      for (int r = 0; r < 6; ++r) cnt[r] = (v >> (2 * r)) & 3u;
      lane::block_exclusive_scan(6, cnt, excl, tot, old_scratch[i & 1]);
      uint32_t before = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        sum += before + excl[r];
        before += tot[r];
      }
      sum += before;
    }
    v = v * 1664525u + 1u + sum;
  }
  const long long t1 = clock64();
  a.out[threadIdx.x] = v;
  if (threadIdx.x == 0) {
    a.cycles[0] = t0;
    a.cycles[1] = t1;
  }
}

// chains 12-14: one lockstep byte read a step, LPT lanes a thread
template <int LPT, int HOW>  // HOW: 0 read_merge, 1 global, 2 ring
__global__ void __launch_bounds__(1024) read_kernel(Args a) {
  extern __shared__ int4 smem[];
  __shared__ lane::ScanScratch old_scratch[2];
  __shared__ uint32_t scratch[2][2][32];
  uint32_t v[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) v[l] = a.x[threadIdx.x * LPT + l];
  lockstep::Stream<HOW == 2> src;
  if constexpr (HOW > 0)
    src.begin(a.buf, static_cast<uint32_t>(a.buf_len), blockDim.x * LPT * 6,
              reinterpret_cast<uint8_t*>(smem), a.ring_bytes);
  int64_t cursor = 0;
  bool bad = false;
  __syncthreads();
  const long long t0 = clock64();
  const int steps = a.iters * UNROLL;
  for (int i = 0; i < steps; ++i) {
    int rc[LPT], ne[LPT];
    uint32_t low[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      rc[l] = v[l] & 3u;
      ne[l] = (v[l] >> 2) & 3u;
    }
    if constexpr (HOW == 0) {
      cursor = read_merge<LPT>(a.buf, a.buf_len, cursor, 3, 3, rc, ne,
                                     v, low, bad, old_scratch[i & 1]);
    } else {
      uint32_t need[2][LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        need[0][l] = lockstep::fields(rc[l]);
        need[1][l] = lockstep::fields(ne[l]);
        low[l] = 0;
      }
      lockstep::read_step<LPT, 3, HOW == 2>(src, 3, 3, need, v, low, bad,
                                            scratch[i & 1]);
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) v[l] = (v[l] ^ low[l]) * GOLD + 1u;
  }
  const long long t1 = clock64();
#pragma unroll
  for (int l = 0; l < LPT; ++l) a.out[threadIdx.x * LPT + l] = v[l];
  if (threadIdx.x == 0) {
    a.cycles[0] = t0;
    a.cycles[1] = t1;
    a.cycles[2] = bad;
  }
}

// chain 16: K6's state chain, its rows in a shared-memory tile
__global__ void __launch_bounds__(1024) encode_kernel(Args a) {
  extern __shared__ int4 smem[];
  int4* rows = smem;  // enc_count
  for (int i = threadIdx.x; i < a.g.enc_count; i += blockDim.x)
    rows[i] = a.g.enc_rows[i];
  uint32_t st = lane::A_L | (a.x[threadIdx.x] & (lane::A_L - 1));
  uint32_t words = 0;
  __syncthreads();
  const long long t0 = clock64();
  const int steps = a.iters * UNROLL;
  // enc_count is a power of two and a multiple of the block: the row of
  // (step, thread), neighbours side by side as in K6's tile
  uint32_t at = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    const int4 row = rows[at & (a.g.enc_count - 1)];
    words += lane::encode_step(st, static_cast<uint32_t>(row.x),
                               static_cast<uint32_t>(row.y),
                               static_cast<uint32_t>(row.z), a.g.enc_log2m);
    at += blockDim.x;
  }
  const long long t1 = clock64();
  a.out[threadIdx.x] = st + words;
  if (threadIdx.x == 0) {
    a.cycles[0] = t0;
    a.cycles[1] = t1;
  }
}

// chain 17: K5's lookup, its tables in shared memory
__global__ void __launch_bounds__(1024) group_kernel(Args a) {
  extern __shared__ int4 smem[];
  const Grouped& g = a.g;
  const uint32_t M = 1u << g.log2m;
  const int nbounds = g.NG + (1 << g.levels);
  const int nbuckets = static_cast<int>((M - 1) >> g.shift) + 1;
  int4* groups = smem;
  int32_t* bases = reinterpret_cast<int32_t*>(groups + g.NG);
  int32_t* table = bases + nbounds;
  uint16_t* buckets = reinterpret_cast<uint16_t*>(table + g.sigma);
  for (int i = threadIdx.x; i < g.NG; i += blockDim.x) groups[i] = g.groups[i];
  for (int i = threadIdx.x; i < nbounds; i += blockDim.x)
    bases[i] = i < g.NG ? g.bases[i] : static_cast<int32_t>(M);
  for (int i = threadIdx.x; i < g.sigma; i += blockDim.x)
    table[i] = g.table[i];
  for (int i = threadIdx.x; i < nbuckets; i += blockDim.x)
    buckets[i] = g.buckets[i];
  uint32_t v = a.x[threadIdx.x];
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < a.iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t slot = v & (M - 1);
      int m = buckets[slot >> g.shift];
      for (int bit = (1 << g.levels) >> 1; bit > 0; bit >>= 1) {
        const int probe = m + bit;
        m = slot >= static_cast<uint32_t>(bases[probe]) ? probe : m;
      }
      const int4 r = groups[m];
      const uint32_t f = static_cast<uint32_t>(r.x);
      const uint32_t x = slot - static_cast<uint32_t>(r.z);
      const uint32_t j = f == 1 ? x : lane::gm_div(x, f, r.y);
      const uint32_t rank = static_cast<uint32_t>(r.w) + j;
      const uint32_t s0 = f * (v >> g.log2m) + (x - j * f);
      v = (s0 ^ static_cast<uint32_t>(table[rank])) * GOLD + 1u;
    }
  }
  const long long t1 = clock64();
  a.out[threadIdx.x] = v;
  if (threadIdx.x == 0) {
    a.cycles[0] = t0;
    a.cycles[1] = t1;
  }
}

template <typename K>
cudaError_t run(K kernel, const Args& a, int threads, size_t smem,
                cudaStream_t cs) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<1, threads, smem, cs>>>(a);
  return cudaGetLastError();
}

template <int HOW>
cudaError_t run_read(const Args& a, int threads, cudaStream_t cs) {
  const size_t smem = HOW == 2 ? a.ring_bytes : 0;
  return threads == 1024 ? run(read_kernel<4, HOW>, a, threads, smem, cs)
                         : run(read_kernel<1, HOW>, a, threads, smem, cs);
}

}  // namespace

// x, out: (threads,) i32, or (threads * LPT,) for chains 12-14 (LPT = 4 at
// 1024 threads, else 1); tab: (4096,) i32; slot_sym: (2^log2m,) u16; rows:
// (sigma, 4) i32; buf: (buf_len,) u8; cycles: (3,) i64 (clock before, clock
// after, whether a read passed the end of buf).  ring_bytes: chain 14's
// ring, a power of two >= 2 * threads * LPT * 6 + 16.  Chain 17 reads K5's
// tables of one grouped frame (g_groups (g_NG, 4) i32, g_bases g_NG i32,
// g_buckets u16, g_table (g_sigma,) i32; g_levels, g_shift, g_log2m as
// decode_grouped takes them); chain 16 reads enc_rows, (enc_count, 4) i32
// rows [f, base, magic, 0] of a frame of 2^enc_log2m slots, enc_count a
// power of two >= threads.  Returns the launch's cudaError_t.
extern "C" int op_probe(int chain, int threads, int iters, const void* x,
                        void* out, const void* tab, const void* slot_sym,
                        const void* rows, int sigma, int log2m,
                        const void* buf, int64_t buf_len, unsigned p0,
                        unsigned p1, int ring_bytes, void* cycles,
                        const void* g_groups, const void* g_bases,
                        const void* g_buckets, const void* g_table, int g_NG,
                        int g_levels, int g_shift, int g_sigma, int g_log2m,
                        const void* enc_rows, int enc_count, int enc_log2m,
                        void* cuda_stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || iters < 0 ||
      enc_count < threads || (enc_count & (enc_count - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Grouped g{static_cast<const int4*>(g_groups),
                  static_cast<const int32_t*>(g_bases),
                  static_cast<const uint16_t*>(g_buckets),
                  static_cast<const int32_t*>(g_table), g_NG, g_levels,
                  g_shift, g_sigma, g_log2m,
                  static_cast<const int4*>(enc_rows), enc_count, enc_log2m};
  const Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
               static_cast<const uint32_t*>(tab),
               static_cast<const uint16_t*>(slot_sym),
               static_cast<const int4*>(rows), sigma, log2m,
               static_cast<const uint8_t*>(buf), buf_len, p0, p1,
               static_cast<uint32_t>(ring_bytes), iters,
               static_cast<long long*>(cycles), g};
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const size_t lookup = 16 * size_t(sigma) + 2 * (size_t(1) << log2m);
  cudaError_t e;
  switch (chain) {
    case 0: e = run(scalar_kernel<0>, a, threads, 0, cs); break;
    case 1: e = run(scalar_kernel<1>, a, threads, 0, cs); break;
    case 2: e = run(scalar_kernel<2>, a, threads, 0, cs); break;
    case 3: e = run(scalar_kernel<3>, a, threads, 0, cs); break;
    case 4: e = run(scalar_kernel<4>, a, threads, 0, cs); break;
    case 5: e = run(scalar_kernel<5>, a, threads, 0, cs); break;
    case 6: e = run(scalar_kernel<6>, a, threads, 0, cs); break;
    case 7: e = run(scalar_kernel<7>, a, threads, lookup, cs); break;
    case 8: e = run(scalar_kernel<8>, a, threads, 0, cs); break;
    case 9: e = run(scalar_kernel<9>, a, threads, 0, cs); break;
    case 10: e = run(scan_kernel<false>, a, threads, 0, cs); break;
    case 11: e = run(scan_kernel<true>, a, threads, 0, cs); break;
    case 12: e = run_read<0>(a, threads, cs); break;
    case 13: e = run_read<1>(a, threads, cs); break;
    case 14: e = run_read<2>(a, threads, cs); break;
    case 15: e = run(scalar_kernel<15>, a, threads, 0, cs); break;
    case 16: e = run(encode_kernel, a, threads, 16 * size_t(enc_count), cs);
      break;
    case 17: {
      const size_t nbuckets = (((size_t(1) << g_log2m) - 1) >> g_shift) + 1;
      e = run(group_kernel, a, threads,
              16 * size_t(g_NG) +
                  4 * (size_t(g_NG) + (size_t(1) << g_levels) + g_sigma) +
                  2 * nbuckets,
              cs);
      break;
    }
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
