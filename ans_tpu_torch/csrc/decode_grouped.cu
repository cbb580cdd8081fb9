// K5: lockstep decode of one fmt-2 stream under the frequency-grouped slot
// layout (frames with more than 2^13 live symbols).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_decode.py `_kernel_grouped`
// (with `_read_merge`), reached through `stage_grouped` and `_call_grouped`.
//
// What it computes, per step t and lane: slot = state & (M-1); the group m
// whose slots hold it (the last of the NG sorted group slot boundaries at or
// below the slot) and its first slot lb; x = slot - lb and j = x / f
// (f = g_f[m]) by the Granlund-Montgomery multiply-high, f == 1 selected
// around it; rank = g_rank0[m] + j; st0 = f * (state >> log2m) + (x - j*f).
// The renorm and exception byte counts (st0 < L >> 8j for j < NR; nb[rank])
// are known before any read, so the bytes come in by the lockstep step
// (lockstep.cuh).  The value is table[rank] + the exception bytes, or the
// rank itself when there is no table.  The TPU kernel's per-section cursor
// reset, split windows and bit-packed plane scans are not carried over.
//
// What bounds it on the card: the lockstep, as K3 and K4.  All S lanes
// share one byte cursor, so one stream decodes in one block on one SM, and
// at 1024 threads a step costs what the 32 warps execute on the SM's integer
// pipe and the bank conflicts of their random shared-memory loads (the
// search's probes, the 16-byte group row, the per-rank table), not the
// latency of one lane's chain (python3 -m ans_tpu_torch.probe, chain
// group_search).  Neither the bytes moved nor the arithmetic come near the
// card's rates; only a batch of streams, one per block, could.
//
// What the design does about it: the step is lockstep.cuh's (the stream
// staged in a shared-memory ring by cp.async one step ahead, static round
// slots in one packed scan, one barrier, one byte window per round and
// thread, 16-byte output stores).  The search is short: the boundaries are
// sorted, so a host-built bucket table first[slot >> shift] (u16, at most
// 1024 entries) names the group that holds the bucket's first slot, and
// `levels` probes (m + bit over the boundaries, padded with M) finish it,
// `levels` being what the bucket that spans most groups needs (1 on
// ANSfold-7 over 2^20-value data against a full search's 8).  The searches
// of a thread's LPT = S/1024 lanes advance level by level together, so
// their probes overlap.  Group rows [f, magic, slot0, rank0] are one
// 16-byte shared-memory load.  The per-rank table and nb live in shared
// memory when they fit (SMEM_TABLE; nb stored as ten times the count, the
// shift that makes its round mask); otherwise (raw-value tables up to 2^20
// entries) they are read from global memory through __ldg, the value's load
// started before the step's scan so its latency overlaps it.  Where the
// tables leave the ring no room the stream takes global loads (ring_bytes
// = 0; the wrapper chooses both).  Every read is checked against the
// stream length.
//
// A launch decodes a batch of D streams, each under its own frame (the
// blocks of a pseudo-adaptive container) or all under one (the sections of
// a blocked container; one stream is the batch of one): one block a
// stream, each reading its row of the model array (ops/model_batch.py:
// where its tables lie in the concatenated ones, its sigma, log2m, NR, NE
// and bucket shift and levels; one row with stride 0 for a shared frame,
// every offset 0), loading its tables into its own shared memory, reading
// its own byte range [stream_off[b], stream_off[b + 1]) of the
// concatenated payloads, its states and length n[b], and writing its
// (T, S) outputs.  A stream with n = 0 reads and writes nothing.  The
// lockstep is per stream, so the blocks run side by side.  Shared memory,
// the exception slots (NES), the ring and whether the per-rank tables go
// to shared memory are one choice for the launch, by the batch's largest
// frame; a stream reads only the rounds of its own frame.
#include "lockstep.cuh"

namespace {

// Stream b's row of the model array: the fields of ops/tables.py
// GroupedDecDevice, (offset, length) of each tensor, then each int
// (table_len 0: the rank is the value; nb_len 0: the frame has no
// exception bytes).
struct Model {
  int32_t groups_off, groups_len, bases_off, bases_len, table_off, table_len,
      nb_off, nb_len, buckets_off, buckets_len, depth, sigma, frame_size,
      log2m, NR, NE, shift, levels;
};

template <int LPT, int NES, bool RING, bool SMEM_TABLE>
__global__ void __launch_bounds__(1024)
decode_grouped_kernel(const uint8_t* __restrict__ stream,
                      const int64_t* __restrict__ stream_off,
                      const int32_t* __restrict__ states,
                      const int4* __restrict__ groups_g,
                      const int32_t* __restrict__ bases_g,
                      const uint16_t* __restrict__ buckets_g,
                      const int32_t* __restrict__ table_g,
                      const uint8_t* __restrict__ nb_g,
                      const int32_t* __restrict__ models, int model_stride,
                      const int64_t* __restrict__ n_of, int T, int S,
                      uint32_t ring_bytes,
                      int32_t* __restrict__ out, int32_t* __restrict__ err) {
  constexpr int NW = lockstep::Rounds<NES>::NW;
  // The lane loops unroll fully up to 8 lanes a thread (lockstep.cuh).
  constexpr int LANE_UNROLL = LPT <= 8 ? LPT : 1;
  extern __shared__ int4 smem[];
  __shared__ uint32_t scratch[2][NW][32];
  // stream blockIdx.x of the batch: its bytes, states, length and outputs
  const int64_t n = n_of[blockIdx.x];
  if (n <= 0) return;  // an empty stream reads and writes nothing
  // ... and its frame
  const Model model =
      lane::model_row<Model>(models, model_stride, blockIdx.x);
  groups_g += model.groups_off;
  bases_g += model.bases_off;
  buckets_g += model.buckets_off;
  table_g += model.table_off;
  nb_g += model.nb_off;
  const int NG = model.groups_len, levels = model.levels;
  const int shift = model.shift, sigma = model.sigma, log2m = model.log2m;
  const int NR = model.NR, NE = NES > 0 ? model.NE : 0;
  const int64_t stream_len =
      stream_off[blockIdx.x + 1] - stream_off[blockIdx.x];
  stream += stream_off[blockIdx.x];
  states += static_cast<int64_t>(blockIdx.x) * S;
  out += static_cast<int64_t>(blockIdx.x) * T * S;
  const uint32_t M = 1u << log2m;
  const bool has_table = model.table_len > 0;
  const int nbounds = NG + (1 << levels);  // boundaries a probe may touch
  const int nbuckets = static_cast<int>((M - 1) >> shift) + 1;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);            // ring_bytes
  int4* groups = smem + ring_bytes / 16;                       // NG
  int32_t* bases = reinterpret_cast<int32_t*>(groups + NG);    // nbounds
  int32_t* table_s = bases + nbounds;                          // sigma
  uint16_t* buckets = reinterpret_cast<uint16_t*>(
      table_s + (SMEM_TABLE && has_table ? sigma : 0));        // nbuckets
  uint8_t* nb_s = reinterpret_cast<uint8_t*>(buckets + nbuckets);  // sigma
  for (int i = threadIdx.x; i < NG; i += blockDim.x) groups[i] = groups_g[i];
  for (int i = threadIdx.x; i < nbounds; i += blockDim.x)
    bases[i] = i < NG ? bases_g[i] : static_cast<int32_t>(M);
  for (int i = threadIdx.x; i < nbuckets; i += blockDim.x)
    buckets[i] = buckets_g[i];
  if constexpr (SMEM_TABLE) {
    if (has_table)
      for (int i = threadIdx.x; i < sigma; i += blockDim.x)
        table_s[i] = table_g[i];
    if constexpr (NES > 0)  // zero for a frame without exception bytes
      for (int i = threadIdx.x; i < sigma; i += blockDim.x)
        nb_s[i] = NE > 0 ? static_cast<uint8_t>(
                               lockstep::FIELD_BITS *
                               min(static_cast<int>(nb_g[i]), NE))
                         : uint8_t(0);
  }
  lockstep::Stream<RING> src;
  src.begin(stream, static_cast<uint32_t>(stream_len),
            static_cast<uint32_t>(S) * (NR + NE), ring, ring_bytes);
  __syncthreads();

  const int l0 = threadIdx.x * LPT;
  const bool owns = l0 < S;  // S < 32 leaves threads idle
  uint32_t st[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l)
    st[l] = owns ? static_cast<uint32_t>(states[l0 + l]) : lane::A_L;

  uint32_t thr[3];  // renorm thresholds; 0 for a round the frame lacks
#pragma unroll
  for (int j = 0; j < 3; ++j) thr[j] = j < NR ? lane::A_L >> (8 * j) : 0u;

  bool bad = false;
  for (int t = 0; t < T; ++t) {
    const int64_t row = static_cast<int64_t>(t) * S + l0;
    // lanes of this thread inside the n values (all of them but in the
    // last step)
    const int64_t left = n - row;
    const int live = !owns ? 0 : left < LPT ? static_cast<int>(left) : LPT;
    // The group m: the bucket names the group of its first slot, then one
    // level of every lane's search at a time (LPT independent probes)
    // takes m to the last boundary at or below the slot.
    int m[LPT];
    uint32_t slot[LPT];
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) {
      slot[l] = st[l] & (M - 1);
      m[l] = buckets[slot[l] >> shift];
    }
    for (int bit = (1 << levels) >> 1; bit > 0; bit >>= 1) {
#pragma unroll LANE_UNROLL
      for (int l = 0; l < LPT; ++l) {
        const int probe = m[l] + bit;
        m[l] = slot[l] >= static_cast<uint32_t>(bases[probe]) ? probe : m[l];
      }
    }
    uint32_t need[NW][LPT], val[LPT];
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) {
      const bool valid = l < live;
      const int4 g = groups[m[l]];
      const uint32_t f = static_cast<uint32_t>(g.x);
      const uint32_t x = slot[l] - static_cast<uint32_t>(g.z);
      const uint32_t j = f == 1 ? x : lane::gm_div(x, f, g.y);
      const uint32_t rank = static_cast<uint32_t>(g.w) + j;
      const uint32_t s0 = f * (st[l] >> log2m) + (x - j * f);
      if (valid) st[l] = s0;
      need[0][l] = lockstep::renorm_need(valid ? s0 : ~0u, thr);
      if constexpr (NES > 0) {
        // ten times the exception-byte count: the ones below it are the
        // rounds the lane reads in
        const uint32_t sh =
            SMEM_TABLE ? nb_s[rank]
            : NE > 0   ? lockstep::FIELD_BITS *
                           min(static_cast<int>(__ldg(nb_g + rank)), NE)
                       : 0u;
        need[1][l] = valid ? 0x00100401u & ~(~0u << sh) : 0u;
      }
      val[l] = !has_table   ? rank
               : SMEM_TABLE ? static_cast<uint32_t>(table_s[rank])
                            : static_cast<uint32_t>(__ldg(table_g + rank));
    }
    uint32_t low[LPT] = {};
    lockstep::read_step<LPT, NES, RING>(src, NR, NE, need, st, low, bad,
                                        scratch[t & 1]);
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) val[l] += low[l];
    if (owns) lockstep::store_lanes<LPT>(out + row, val);
  }
  if (bad) *err = 1;
}

struct Args {
  const void *stream, *states, *groups, *bases, *buckets, *table, *nb;
  const void *models, *stream_off, *n;
  int model_stride, D;
  int table_bytes, NE, T, S;  // the batch's largest tables, NE
  uint32_t ring_bytes;
  bool smem_table;
  void *out, *err;
  cudaStream_t cs;
};

template <int LPT, int NES, bool RING, bool SMEM_TABLE>
cudaError_t launch(const Args& a) {
  auto kernel = decode_grouped_kernel<LPT, NES, RING, SMEM_TABLE>;
  const size_t smem = a.ring_bytes + size_t(a.table_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.D, lane::block_threads(a.S), smem, a.cs>>>(
      static_cast<const uint8_t*>(a.stream),
      static_cast<const int64_t*>(a.stream_off),
      static_cast<const int32_t*>(a.states),
      static_cast<const int4*>(a.groups),
      static_cast<const int32_t*>(a.bases),
      static_cast<const uint16_t*>(a.buckets),
      static_cast<const int32_t*>(a.table),
      static_cast<const uint8_t*>(a.nb),
      static_cast<const int32_t*>(a.models), a.model_stride,
      static_cast<const int64_t*>(a.n), a.T, a.S, a.ring_bytes,
      static_cast<int32_t*>(a.out),
      static_cast<int32_t*>(a.err));
  return cudaGetLastError();
}

template <int LPT, int NES>
cudaError_t launch_nes(const Args& a) {
  if (a.smem_table)
    return a.ring_bytes ? launch<LPT, NES, true, true>(a)
                        : launch<LPT, NES, false, true>(a);
  return a.ring_bytes ? launch<LPT, NES, true, false>(a)
                      : launch<LPT, NES, false, false>(a);
}

template <int LPT>
cudaError_t launch_lpt(const Args& a) {
  return a.NE > 0 ? launch_nes<LPT, 3>(a) : launch_nes<LPT, 0>(a);
}

}  // namespace

// stream: the D streams' bytes, stream b at [stream_off[b], stream_off[b +
// 1]) (stream_off: (D + 1,) i64 device array; each stream at any address and
// shorter than 2^31 bytes); states: (D, S) i32; the streams' tables, each
// after the other: groups (NG, 4) i32 rows [f, magic, slot0, rank0]; bases,
// at least NG i32, the groups' first slots in order; buckets ((2^log2m - 1
// >> shift) + 1,) u16, the group holding each bucket's first slot, from
// which at most 2^levels - 1 further groups begin inside the bucket; table
// (sigma,) i32 per-rank value or high part, or none (the rank is the value);
// nb (sigma,) u8 exception bytes per rank, where the frame's NE > 0;
// models: the streams' rows of struct Model (i32), stream b's at models +
// model_stride * b (stride 0: one row for all); table_bytes: the largest
// shared memory a row's tables take in this launch's layout; NR, NE: the
// largest renorm and exception rounds of the rows; n: (D,) i64 device
// array, the positions of each stream; out: (D, T, S) i32; err: one i32,
// set to 1 when a read passes the end of its stream.  ring_bytes: 0 for the
// instance on global loads, else the size of the shared-memory ring, a
// power of two >= 2 * S * (NR + NE) + 16.  smem_table: whether the per-rank
// tables are staged in shared memory.  Returns the launch's cudaError_t.
extern "C" int decode_grouped(const void* stream, const void* stream_off,
                              const void* states, const void* groups,
                              const void* bases, const void* buckets,
                              const void* table, const void* nb,
                              const void* models, int model_stride,
                              int table_bytes, int NR, int NE, const void* n,
                              int D, int T, int S, int ring_bytes,
                              int smem_table, void* out, void* err,
                              void* cuda_stream) {
  if (T == 0 || D == 0) return 0;
  if (NR < 0 || NR > 3 || NE < 0 || NE > 3 || ring_bytes < 0 ||
      (ring_bytes & (ring_bytes - 1)) ||
      (ring_bytes && ring_bytes < 2 * S * (NR + NE) + 16) || D < 0 ||
      (S > 1024 && S % 1024) || model_stride < 0 || table_bytes < 0 ||
      (NE > 0 && nb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpt = S > 1024 ? S / 1024 : 1;
  const Args a{stream, states, groups, bases, buckets, table, nb, models,
               stream_off, n, model_stride, D, table_bytes, NE, T, S,
               static_cast<uint32_t>(ring_bytes), smem_table != 0, out,
               err, static_cast<cudaStream_t>(cuda_stream)};
  cudaError_t e;
  switch (lpt) {
    case 1: e = launch_lpt<1>(a); break;
    case 2: e = launch_lpt<2>(a); break;
    case 4: e = launch_lpt<4>(a); break;
    case 8: e = launch_lpt<8>(a); break;
    case 16: e = launch_lpt<16>(a); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
