// K4: lockstep decode of one fmt-2 stream through the frame's per-slot
// table (the direct engine).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_decode.py `_kernel` (with
// `_read_merge` and `_prefixc`), reached through `stage` and `_call`.
//
// What it computes, per step t and lane: slot = state & (M-1); the slot's
// table entry gives the owning symbol's frequency f, first slot lb and
// output word; st0 = f * (state >> log2m) + slot - lb.  From there the
// step is K3's (decode_search.cu): the renorm bytes (st0 < L >> 8j,
// j < NR) and exception bytes (nb) a lane reads are known before any
// read, each round's rank is an exclusive prefix over the lanes, the
// bytes are merged high-first, and the value is high + the exception
// bytes.  The slot order (value-cumulative or frequency-grouped) is in
// the table, so one kernel serves both layouts.
//
// What bounds it on the card: the lockstep, as for K3: one stream decodes
// inside one block on one SM, and each step is a chain of dependent
// shared-memory loads, block scans behind two barriers and one round of
// dependent global byte loads.  Latency sets the time, not bandwidth.
//
// What the design does about it: the search's chain of `depth` dependent
// probes becomes two dependent loads.  The table is two-level: a u16
// symbol index per slot (2M bytes), then one 16-byte row [f, lb, high,
// nb] per live symbol, both in shared memory (up to the 227 KB a block
// may opt into; a frame that does not fit is not eligible and the
// wrapper raises).  A full word per slot would take 8M bytes or more and
// shut out M = 2^15; the TPU's freq<<16|offset and packed23 word
// packings are Mosaic's and are not carried over.  Lanes stay in
// registers, LPT = S/1024 per thread; every read is checked against the
// stream length.
#include "common.cuh"

namespace {

template <int LPT>
__global__ void __launch_bounds__(1024)
decode_direct_kernel(const uint8_t* __restrict__ stream, int64_t stream_len,
                     const int32_t* __restrict__ states,
                     const int4* __restrict__ rows_g,
                     const uint16_t* __restrict__ slot_g, int sigma,
                     int log2m, int NR, int NE, int64_t n, int T, int S,
                     int32_t* __restrict__ out, int32_t* __restrict__ err) {
  extern __shared__ int4 smem[];
  __shared__ lane::ScanScratch scratch[2];
  const uint32_t M = 1u << log2m;
  int4* rows = smem;                                           // sigma rows
  uint16_t* slot_sym = reinterpret_cast<uint16_t*>(rows + sigma);  // M
  for (int i = threadIdx.x; i < sigma; i += blockDim.x) rows[i] = rows_g[i];
  for (uint32_t i = threadIdx.x; i < M; i += blockDim.x)
    slot_sym[i] = slot_g[i];
  __syncthreads();

  const int l0 = threadIdx.x * LPT;
  const bool owns = l0 < S;  // S < 32 leaves threads idle
  uint32_t st[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l)
    st[l] = owns ? static_cast<uint32_t>(states[l0 + l]) : lane::A_L;

  int64_t cursor = 0;
  bool bad = false;
  for (int t = 0; t < T; ++t) {
    const int64_t row = static_cast<int64_t>(t) * S + l0;
    int rc[LPT], ne[LPT];
    uint32_t high[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const bool valid = owns && row + l < n;
      const uint32_t slot = st[l] & (M - 1);
      const int4 e = rows[slot_sym[slot]];
      const uint32_t s0 = static_cast<uint32_t>(e.x) * (st[l] >> log2m) +
                          (slot - static_cast<uint32_t>(e.y));
      if (valid) st[l] = s0;
      int r = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r += valid && j < NR && st[l] < (lane::A_L >> (8 * j));
      rc[l] = r;
      ne[l] = valid ? e.w : 0;
      high[l] = static_cast<uint32_t>(e.z);
    }
    uint32_t low[LPT];
    cursor = lane::read_merge<LPT>(stream, stream_len, cursor, NR, NE, rc, ne,
                                   st, low, bad, scratch[t & 1]);
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      if (owns) out[row + l] = static_cast<int32_t>(high[l] + low[l]);
  }
  if (bad) *err = 1;
}

template <int LPT>
cudaError_t launch(const void* stream, int64_t stream_len, const void* states,
                   const void* rows, const void* slot_sym, int sigma,
                   int log2m, int NR, int NE, int64_t n, int T, int S,
                   void* out, void* err, cudaStream_t cs) {
  auto kernel = decode_direct_kernel<LPT>;
  const size_t smem = 16 * size_t(sigma) + 2 * (size_t(1) << log2m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<1, lane::block_threads(S), smem, cs>>>(
      static_cast<const uint8_t*>(stream), stream_len,
      static_cast<const int32_t*>(states), static_cast<const int4*>(rows),
      static_cast<const uint16_t*>(slot_sym), sigma, log2m, NR, NE, n, T, S,
      static_cast<int32_t*>(out), static_cast<int32_t*>(err));
  return cudaGetLastError();
}

}  // namespace

// stream: (stream_len,) u8; states: (S,) i32; rows: (sigma, 4) i32 rows
// [freq, base, high, nb]; slot_sym: (2^log2m,) u16; out: (T, S) i32; err:
// one i32, set to 1 when a read passes the end of the stream.  Returns the
// launch's cudaError_t.
extern "C" int decode_direct(const void* stream, int64_t stream_len,
                             const void* states, const void* rows,
                             const void* slot_sym, int sigma, int log2m,
                             int NR, int NE, int64_t n, int T, int S,
                             void* out, void* err, void* cuda_stream) {
  if (T == 0) return 0;
  const int lpt = S > 1024 ? S / 1024 : 1;
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  cudaError_t e;
  switch (lpt) {
    case 1: e = launch<1>(stream, stream_len, states, rows, slot_sym, sigma,
                          log2m, NR, NE, n, T, S, out, err, cs); break;
    case 2: e = launch<2>(stream, stream_len, states, rows, slot_sym, sigma,
                          log2m, NR, NE, n, T, S, out, err, cs); break;
    case 4: e = launch<4>(stream, stream_len, states, rows, slot_sym, sigma,
                          log2m, NR, NE, n, T, S, out, err, cs); break;
    case 8: e = launch<8>(stream, stream_len, states, rows, slot_sym, sigma,
                          log2m, NR, NE, n, T, S, out, err, cs); break;
    case 16: e = launch<16>(stream, stream_len, states, rows, slot_sym, sigma,
                            log2m, NR, NE, n, T, S, out, err, cs); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
