// K2: placement of the encode scan's bytes into the fmt-2 stream, with the
// stream offsets of every step computed in the same single pass.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_place.py `_kernel`, reached
// through `place` and `_call`, which carries its byte cursor from one grid
// step to the next in scratch.
//
// What it computes: for step t, the six byte rounds (renorm round j for
// lanes with rc > j, exception round j for lanes with nb > j).  The rounds
// of a step follow each other in the stream, and the steps follow each
// other: a lane's byte in round r of step t goes to base(t) + the bytes of
// the step's rounds before r + rank, where rank is the exclusive prefix of
// the round's mask over the lanes and base(t) is the byte count of all
// steps before t.  Both kinds of round are read high-first by the decoder:
// renorm round j carries emission slot rc-1-j of the packed word,
// exception round j carries byte nb-1-j of the value's low bytes.  It also
// writes base(t) for every step and, after them, the stream's length.
//
// What bounds it on the card: bytes.  Each position is read once (12
// bytes: the packed word, nb and the low bytes) and each stream byte
// written once; a step's own work is a block scan over its lanes.  What
// a step cannot know by itself is base(t): on the TPU the grid runs in
// order and carries it, here blocks run in no order.
//
// What the design does about it: a block takes a chunk of consecutive
// steps by an atomic ticket, so that every chunk before it is held by a
// block that has already started: one step of S / 16 threads from S = 512
// up (256 threads at S = 4096, so that several blocks share an SM and hide
// each other's waits), else eight steps of a warp each.  Each thread owns 16
// (or fewer) neighbouring lanes and reads them with 16-byte loads, so one
// block scan gives the ranks of every round of every step of the chunk and
// the chunk's byte count.  The chunks' offsets come from a chained scan
// with decoupled look-back (lookback.cuh): the block publishes its count in
// a status word at once, stages its bytes in shared memory, then one warp
// reads its predecessors' status words 64 at a time (one round trip to
// L2), summing counts back to the nearest chunk that has published its
// inclusive prefix, and publishes its own.  All bytes of a
// chunk are one contiguous run of the stream, written with 16-byte stores on
// its aligned interior and byte stores at its two ends.  The TPU kernel's
// routing network, its section cutting and its VMEM batch sizing are not
// carried over: the stream is written flat (sections are contiguous
// step-aligned slices of it).
//
// A launch places a batch of D streams (the sections of a blocked container;
// one stream is the batch of one) as one chain: the tickets run over the
// (stream, chunk) pairs stream-major, so stream d's first chunk looks back
// into stream d - 1's last, and the D streams come out concatenated in one
// buffer, their step offsets and lengths global positions in it (what the
// batched decode reads back; the container's writer slices it).  Forward
// progress holds as for one stream: a chunk's predecessors hold lower
// tickets.  One chain, and not a status region and ticket a stream, keeps
// lookback.cuh as it is: a stream's start is the chain's prefix at its
// first chunk, and no stream waits for a second launch to learn it.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 1024;  // the block, at most
constexpr int LANES_A_THREAD = 16;  // from S = 512 up
constexpr int STEP_BLOCK = 256;  // a block of several steps (S < 512)

// Threads a step: S / 16 (32 to 1024), so that a block (256 threads at
// S = 4096) keeps few registers and several blocks share an SM, hiding each
// other's waits on memory and on the look-back.
inline int threads_per_step(int S) {
  const int t = (S + LANES_A_THREAD - 1) / LANES_A_THREAD;
  return min(THREADS, max(32, (t + 31) / 32 * 32));
}

// status words a lane of the look-back (lookback.cuh) reads in one round
// trip: 64 chunks a window.  Eight (256 chunks, about as many as are in
// flight), which K2's own copy of the look-back read, were slower
// (bench_steps' row "look-back eight words a lane")
constexpr int LOOK = 2;

// The values of lanes [l, l + VEC) of the row at `row`.  FAST: all of them
// in range and the rows 16-byte aligned, one vector load; else lane by lane
// (a lane past S or n reads 0, loaded from a safe address and replaced, so
// that no load waits on a condition).
template <int VEC, bool FAST>
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ p,
                                           int64_t row, int l, int S,
                                           int64_t n, int32_t (&v)[VEC]) {
  const int64_t idx = row + l;
  if constexpr (FAST && VEC == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + idx));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (FAST && VEC == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p + idx));
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool in = FAST || (l + k < S && idx + k < n);
      const int32_t x = __ldg(p + (in ? idx + k : 0));
      v[k] = in ? x : 0;
    }
  }
}

// A thread's round counts over its LPT lanes from the packed words and nb.
template <int LPT, bool FAST>
__device__ __forceinline__ void count_lanes(
    const int32_t* __restrict__ packed, const int32_t* __restrict__ nb,
    int64_t row, int l0, int S, int64_t n, int (&cnt)[lane::MAX_ROUNDS]) {
  constexpr int VEC = LPT < 4 ? LPT : 4;
#pragma unroll
  for (int m = 0; m < LPT; m += VEC) {
    int32_t w[VEC], e[VEC];
    load_lanes<VEC, FAST>(packed, row, l0 + m, S, n, w);
    load_lanes<VEC, FAST>(nb, row, l0 + m, S, n, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int rc = (w[k] >> 24) & 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cnt[j] += rc > j;
        cnt[3 + j] += e[k] > j;
      }
    }
  }
}

// A thread's bytes into the chunk's staging buffer, each round's at pos[r]
// on: renorm round j carries emission slot rc-1-j of the packed word,
// exception round j byte nb-1-j of the low bytes.
template <int LPT, bool FAST>
__device__ __forceinline__ void stage_lanes(
    const int32_t* __restrict__ packed, const int32_t* __restrict__ nb,
    const int32_t* __restrict__ excw, int64_t row, int l0, int S, int64_t n,
    uint32_t (&pos)[lane::MAX_ROUNDS], uint8_t* bytes) {
  constexpr int VEC = LPT < 4 ? LPT : 4;
#pragma unroll 2
  for (int m = 0; m < LPT; m += VEC) {
    int32_t w[VEC], x[VEC], e[VEC];
    load_lanes<VEC, FAST>(packed, row, l0 + m, S, n, w);
    load_lanes<VEC, FAST>(excw, row, l0 + m, S, n, x);
    load_lanes<VEC, FAST>(nb, row, l0 + m, S, n, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const uint32_t wk = static_cast<uint32_t>(w[k]);
      const uint32_t xk = static_cast<uint32_t>(x[k]);
      const int rc = (wk >> 24) & 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (rc > j) bytes[pos[j]++] = (wk >> (8 * (rc - 1 - j))) & 0xFF;
        if (e[k] > j)
          bytes[pos[3 + j]++] = (xk >> (8 * (e[k] - 1 - j))) & 0xFF;
      }
    }
  }
}

// One chunk of G steps by G * TPS threads (TPS threads a step, a multiple
// of 32; LPT lanes a thread).
template <int LPT>
__global__ void __launch_bounds__(THREADS)
    place_kernel(const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ nb,
                 const int32_t* __restrict__ excw,
                 const int64_t* __restrict__ n_of, int T, int S, int TPS,
                 int G, int64_t chunks_a_stream, bool vec,
                 uint8_t* __restrict__ stream, int64_t cap,
                 int64_t* __restrict__ offsets, uint64_t* status,
                 unsigned int* ticket) {
  extern __shared__ uint32_t staged[];  // the chunk's bytes, then 16 spare
  __shared__ lane::ScanScratch scratch;
  __shared__ uint64_t excl_s;
  const int64_t chunk = lookback::take_ticket(ticket);
  // the chunk's stream d (its inputs, length and step offsets) and its
  // place among that stream's chunks
  const int64_t d = chunk / chunks_a_stream;
  const int64_t first = d * T * S;  // the stream's first position
  packed += first;
  nb += first;
  excw += first;
  const int64_t n = n_of[d];
  const int g = threadIdx.x / TPS;
  const int64_t t = (chunk - d * chunks_a_stream) * G + g;
  const int l0 = (threadIdx.x % TPS) * LPT;
  const int64_t row = t * S;

  // the counts: packed words and nb alone (the low bytes are read when the
  // bytes are staged, so that few registers stay live across the scan and
  // several blocks share an SM); a thread whose lanes are all in range and
  // aligned reads them with vector loads
  const bool fast = vec && l0 + LPT <= S && row + l0 + LPT <= n;
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
  if (fast)
    count_lanes<LPT, true>(packed, nb, row, l0, S, n, cnt);
  else
    count_lanes<LPT, false>(packed, nb, row, l0, S, n, cnt);
  int excl[lane::MAX_ROUNDS], total[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(lane::MAX_ROUNDS, cnt, excl, total, scratch);

  // the block scan ran over the chunk's steps one after the other: a
  // step's rounds start at its first warp's offsets and end at the next
  // step's first warp's (slot nwarps holds the block's totals)
  const int w0 = g * (TPS / 32), w1 = w0 + TPS / 32;
  uint32_t before = 0, agg = 0;  // bytes of the chunk before this step; all
#pragma unroll
  for (int r = 0; r < lane::MAX_ROUNDS; ++r) {
    before += scratch.w[r][w0];
    agg += total[r];
  }
  uint32_t pos[lane::MAX_ROUNDS];
  uint32_t at = before;
#pragma unroll
  for (int r = 0; r < lane::MAX_ROUNDS; ++r) {
    pos[r] = at + excl[r] - scratch.w[r][w0];
    at += scratch.w[r][w1] - scratch.w[r][w0];
  }
  if (threadIdx.x == 0)
    lookback::publish(status + chunk, agg,
                      chunk == 0 ? lookback::PREFIX : lookback::AGGREGATE);

  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  if (fast)
    stage_lanes<LPT, true>(packed, nb, excw, row, l0, S, n, pos, bytes);
  else
    stage_lanes<LPT, false>(packed, nb, excw, row, l0, S, n, pos, bytes);
  // staged first: by then the predecessors' counts are mostly published (a
  // look-back started before staging spun on them, and its reads slowed
  // every block down)
  const uint64_t ex = lookback::exclusive_prefix<LOOK>(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t p0 = static_cast<int64_t>(excl_s);
  // step t of stream d at offsets[t][d] (the streams' ends, row T, lie
  // side by side)
  const int64_t D = gridDim.x / chunks_a_stream;
  if (t < T && threadIdx.x % TPS == 0) offsets[t * D + d] = p0 + before;
  if (t == T - 1 && threadIdx.x % TPS == 0) offsets[T * D + d] = p0 + agg;

  // the run [p0, p1): byte stores up to the first 16-byte boundary and
  // after the last one, 16-byte stores between (a stream shorter than
  // the run, the caller's stated length, takes what fits)
  const int64_t p1 = min(p0 + static_cast<int64_t>(agg), cap);
  const uintptr_t base = reinterpret_cast<uintptr_t>(stream);
  const int64_t up = ((base + p0 + 15) & ~uintptr_t(15)) - base;
  const int64_t down = ((base + p1) & ~uintptr_t(15)) - base;
  const int64_t a0 = min(up, max(p1, p0)), a1 = max(a0, down);
  for (int64_t p = p0 + threadIdx.x; p < a0; p += blockDim.x)
    stream[p] = bytes[p - p0];
  for (int64_t p = a1 + threadIdx.x; p < p1; p += blockDim.x)
    stream[p] = bytes[p - p0];
  const int shift = 8 * ((a0 - p0) & 3);
  for (int64_t p = a0 + 16 * static_cast<int64_t>(threadIdx.x); p < a1;
       p += 16 * static_cast<int64_t>(blockDim.x)) {
    const uint32_t* src = staged + ((p - p0) >> 2);
    uint32_t v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = src[k];
    uint4 out;
    out.x = __funnelshift_r(v[0], v[1], shift);
    out.y = __funnelshift_r(v[1], v[2], shift);
    out.z = __funnelshift_r(v[2], v[3], shift);
    out.w = __funnelshift_r(v[3], v[4], shift);
    *reinterpret_cast<uint4*>(stream + p) = out;
  }
}

template <int LPT>
int launch(const void* packed, const void* nb, const void* excw,
           const void* n, int D, int T, int S, void* stream, int64_t cap,
           void* offsets, void* status, cudaStream_t cuda_stream) {
  const int TPS = threads_per_step(S);
  const int G = max(1, min(STEP_BLOCK / TPS, T));
  const int64_t chunks_a_stream = (static_cast<int64_t>(T) + G - 1) / G;
  const int64_t chunks = D * chunks_a_stream;
  if (chunks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(lane::MAX_ROUNDS) * S * G + 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        place_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  uint64_t* st = static_cast<uint64_t*>(status);
  // vector loads need every row 16-byte aligned
  const bool vec = S % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(packed) |
                     reinterpret_cast<uintptr_t>(nb) |
                     reinterpret_cast<uintptr_t>(excw)) & 15) == 0;
  place_kernel<LPT><<<static_cast<unsigned>(chunks), TPS * G, smem,
                      cuda_stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(nb),
      static_cast<const int32_t*>(excw), static_cast<const int64_t*>(n), T,
      S, TPS, G, chunks_a_stream, vec, static_cast<uint8_t*>(stream), cap,
      static_cast<int64_t*>(offsets), st,
      reinterpret_cast<unsigned int*>(st + chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed/nb/excw: (D, T, S) i32; n: (D,) i64 device array, the positions
// of each stream; stream: (cap,) u8 out, the D streams one after the other;
// offsets: (T + 1, D) i64 out, the offset in `stream` of each step of each
// stream, then (row T) each stream's end; status: D * T + 1 u64, zero (a status
// word for each chunk, then the ticket).  Bytes at or past `cap` are not
// written.  S must be at most 16384 (6 S bytes of shared memory a block).
// Returns the launch's cudaError_t.
extern "C" int place(const void* packed, const void* nb, const void* excw,
                     const void* n, int D, int T, int S, void* stream,
                     int64_t cap, void* offsets, void* status,
                     void* cuda_stream) {
  if (T == 0 || D == 0) return 0;
  if (D < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tps = threads_per_step(S);
  const int lpt = (S + tps - 1) / tps;
  int (*go)(const void*, const void*, const void*, const void*, int, int,
            int, void*, int64_t, void*, void*, cudaStream_t) = nullptr;
  if (lpt <= 1) go = launch<1>;
  else if (lpt <= 2) go = launch<2>;
  else if (lpt <= 4) go = launch<4>;
  else if (lpt <= 8) go = launch<8>;
  else if (lpt <= 16) go = launch<16>;
  if (go == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return go(packed, nb, excw, n, D, T, S, stream, cap, offsets, status,
            static_cast<cudaStream_t>(cuda_stream));
}
