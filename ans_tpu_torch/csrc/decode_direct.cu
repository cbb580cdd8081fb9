// K4: lockstep decode of one fmt-2 stream through the frame's per-slot
// table (the direct engine).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_decode.py `_kernel` (with
// `_read_merge` and `_prefixc`), reached through `stage` and `_call`.
//
// What it computes, per step t and lane: slot = state & (M-1); the slot's
// table entry gives the owning symbol's frequency f, first slot lb and
// output word; st0 = f * (state >> log2m) + slot - lb.  The renorm bytes
// (st0 < L >> 8j, j < NR) and exception bytes (nb) a lane reads are known
// before any read, each round's rank is an exclusive prefix over the
// lanes, the bytes are merged high-first, and the value is high + the
// exception bytes.  The slot order (value-cumulative or frequency-grouped)
// is in the table, so one kernel serves both layouts.
//
// What bounds it on the card: the lockstep.  All S lanes share one byte
// cursor, so the T steps of one stream run one after the other inside one
// block on one SM.  One warp runs a step in about 0.4 us, the latency of
// its chain: two dependent shared-memory loads (the lookup), one warp
// scan, one barrier, a handful of warp reductions, one window load.  The
// 32 warps of S = 4096 take 2.5 us a step (20.9 ms for n = 2^25 on
// ANSfold-2; NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and python3 -m
// ans_tpu_torch.probe): what they execute on the SM's integer pipe, and
// the bank conflicts of their random 16-byte rows, set the time, not the
// latency.  Neither the bytes moved nor the arithmetic come near the
// card's rates; only a batch of streams, one per block, could.
//
// What the design does about it (lockstep.cuh has the step): the table is
// two-level, a u16 symbol index per slot (2M bytes), then one 16-byte row
// [f, lb, high, nb] per live symbol, both in shared memory; the stream is
// staged in a shared-memory ring by cp.async one step ahead of the cursor;
// the rounds have static slots and share one packed scan; a step has one
// barrier; the byte reads of a round are one window load per thread;
// a thread stores its LPT = S/1024 outputs 16 bytes at a time.  A frame
// whose tables leave no room for the ring takes the second instance: the
// same step on global loads, with an L2 prefetch ahead of the cursor
// (ring_bytes = 0; the wrapper chooses).  Every read is checked against
// the stream length.
//
// A launch decodes a batch of D streams, each under its own frame (the
// blocks of a pseudo-adaptive container) or all under one (the sections of
// a blocked container; one stream is the batch of one): one block a
// stream, each reading its row of the model array (ops/model_batch.py:
// where its tables lie in the concatenated ones, its sigma, log2m, NR and
// NE; one row with stride 0 for a shared frame, every offset 0), loading
// its tables into its own shared memory, reading its own byte range
// [stream_off[b], stream_off[b + 1]) of the concatenated payloads, its
// states and length n[b], and writing its (T, S) outputs.  A stream with
// n = 0 reads and writes nothing.  The lockstep is per stream, so the
// blocks run side by side.  Shared memory, the exception slots (NES) and
// the ring are one choice for the launch, by the batch's largest frame; a
// stream reads only the rounds of its own frame.
#include "lockstep.cuh"

namespace {

// Stream b's row of the model array: the fields of ops/tables.py
// DirectDevice, (offset, length) of each tensor, then each int.
struct Model {
  int32_t slot_sym_off, slot_sym_len, rows_off, rows_len, sigma, frame_size,
      log2m, NR, NE;
};

template <int LPT, int NES, bool RING>
__global__ void __launch_bounds__(1024)
decode_direct_kernel(const uint8_t* __restrict__ stream,
                     const int64_t* __restrict__ stream_off,
                     const int32_t* __restrict__ states,
                     const int4* __restrict__ rows_g,
                     const uint16_t* __restrict__ slot_g,
                     const int32_t* __restrict__ models, int model_stride,
                     const int64_t* __restrict__ n_of, int T, int S,
                     uint32_t ring_bytes, int32_t* __restrict__ out,
                     int32_t* __restrict__ err) {
  constexpr int NW = lockstep::Rounds<NES>::NW;
  extern __shared__ int4 smem[];
  __shared__ uint32_t scratch[2][NW][32];
  // stream blockIdx.x of the batch: its bytes, states, length and outputs
  const int64_t n = n_of[blockIdx.x];
  if (n <= 0) return;  // an empty stream reads and writes nothing
  // ... and its frame
  const Model model =
      lane::model_row<Model>(models, model_stride, blockIdx.x);
  rows_g += model.rows_off;
  slot_g += model.slot_sym_off;
  const int sigma = model.sigma, log2m = model.log2m;
  const int NR = model.NR, NE = NES > 0 ? model.NE : 0;
  const int64_t stream_len =
      stream_off[blockIdx.x + 1] - stream_off[blockIdx.x];
  stream += stream_off[blockIdx.x];
  states += static_cast<int64_t>(blockIdx.x) * S;
  out += static_cast<int64_t>(blockIdx.x) * T * S;
  const uint32_t M = 1u << log2m;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);      // ring_bytes
  int4* rows = smem + ring_bytes / 16;                       // sigma rows
  uint16_t* slot_sym = reinterpret_cast<uint16_t*>(rows + sigma);  // M
  // a row's exception-byte count becomes the rounds it reads in
  for (int i = threadIdx.x; i < sigma; i += blockDim.x) {
    int4 e = rows_g[i];
    e.w = static_cast<int>(lockstep::fields(min(max(e.w, 0), NE)));
    rows[i] = e;
  }
  for (uint32_t i = threadIdx.x; i < M; i += blockDim.x)
    slot_sym[i] = slot_g[i];
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
    uint32_t need[NW][LPT], val[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const bool valid = l < live;
      const uint32_t slot = st[l] & (M - 1);
      const int4 e = rows[slot_sym[slot]];
      const uint32_t s0 = static_cast<uint32_t>(e.x) * (st[l] >> log2m) +
                          (slot - static_cast<uint32_t>(e.y));
      if (valid) st[l] = s0;
      need[0][l] = lockstep::renorm_need(valid ? s0 : ~0u, thr);
      if constexpr (NES > 0)
        need[1][l] = valid ? static_cast<uint32_t>(e.w) : 0u;
      val[l] = static_cast<uint32_t>(e.z);
    }
    uint32_t low[LPT] = {};
    lockstep::read_step<LPT, NES, RING>(src, NR, NE, need, st, low, bad,
                                        scratch[t & 1]);
#pragma unroll
    for (int l = 0; l < LPT; ++l) val[l] += low[l];
    if (owns) lockstep::store_lanes<LPT>(out + row, val);
  }
  if (bad) *err = 1;
}

struct Args {
  const void *stream, *states, *rows, *slot_sym, *models;
  const void *stream_off, *n;
  int model_stride, D;
  int table_bytes, NE, T, S;  // the batch's largest tables, NE
  uint32_t ring_bytes;
  void *out, *err;
  cudaStream_t cs;
};

template <int LPT, int NES, bool RING>
cudaError_t launch(const Args& a) {
  auto kernel = decode_direct_kernel<LPT, NES, RING>;
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
      static_cast<const int4*>(a.rows),
      static_cast<const uint16_t*>(a.slot_sym),
      static_cast<const int32_t*>(a.models), a.model_stride,
      static_cast<const int64_t*>(a.n), a.T, a.S, a.ring_bytes,
      static_cast<int32_t*>(a.out), static_cast<int32_t*>(a.err));
  return cudaGetLastError();
}

template <int LPT>
cudaError_t launch_lpt(const Args& a) {
  if (a.NE > 0)
    return a.ring_bytes ? launch<LPT, 3, true>(a) : launch<LPT, 3, false>(a);
  return a.ring_bytes ? launch<LPT, 0, true>(a) : launch<LPT, 0, false>(a);
}

}  // namespace

// stream: the D streams' bytes, stream b at [stream_off[b], stream_off[b +
// 1]) (stream_off: (D + 1,) i64 device array; each stream at any address and
// shorter than 2^31 bytes); states: (D, S) i32; rows: the streams' (sigma,
// 4) i32 rows [freq, base, high, nb], slot_sym: their (2^log2m,) u16, each
// table after the other; models: the streams' rows of struct Model (i32),
// stream b's at models + model_stride * b (stride 0: one row for all);
// table_bytes: the largest 16 sigma + 2^(log2m + 1) of the rows; NR, NE: the
// largest renorm and exception rounds of the rows; n: (D,) i64 device
// array, the positions of each stream; out: (D, T, S) i32; err: one i32, set
// to 1 when a read passes the end of its stream.  ring_bytes: 0 for the
// instance on global loads, else the size of the shared-memory ring, a
// power of two >= 2 * S * (NR + NE) + 16.  Returns the launch's
// cudaError_t.
extern "C" int decode_direct(const void* stream, const void* stream_off,
                             const void* states, const void* rows,
                             const void* slot_sym, const void* models,
                             int model_stride, int table_bytes, int NR,
                             int NE, const void* n, int D, int T, int S,
                             int ring_bytes, void* out, void* err,
                             void* cuda_stream) {
  if (T == 0 || D == 0) return 0;
  if (NR < 0 || NR > 3 || NE < 0 || NE > 3 || ring_bytes < 0 ||
      (ring_bytes & (ring_bytes - 1)) ||
      (ring_bytes && ring_bytes < 2 * S * (NR + NE) + 16) || D < 0 ||
      (S > 1024 && S % 1024) || model_stride < 0 || table_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpt = S > 1024 ? S / 1024 : 1;
  const Args a{stream, states, rows, slot_sym, models, stream_off, n,
               model_stride, D, table_bytes, NE, T, S,
               static_cast<uint32_t>(ring_bytes), out, err,
               static_cast<cudaStream_t>(cuda_stream)};
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
