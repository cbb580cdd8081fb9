// K3: lockstep decode of one fmt-2 stream with the pivot search.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_decode.py `_kernel_search`
// (with `_read_merge` and `_prefixc`), reached through `stage_search`
// and `_call_search`.
//
// What it computes, per step t and lane: slot = state & (M-1); a bitwise
// binary search over the cumulative bases of the present symbols gives
// the dense id m and its bracket [lb, ub); st0 = (ub-lb)*(state >> log2m)
// + slot - lb.  How many renorm bytes (st0 < L >> 8j, j < NR) and
// exception bytes (nb[m]) the lane reads is known before any byte is
// read, so each round's rank is an exclusive prefix over the lanes; the
// byte at cursor + round base + rank is merged high-first.  The value is
// high[m] + the exception bytes.  The cursor runs over the concatenated
// sections; the TPU kernel's per-section cursor reset and split windows
// are not carried over.
//
// What bounds it on the card: the lockstep.  All S lanes share one byte
// cursor, so the T steps of one stream run one after the other inside one
// block on one SM.  One warp's chain (`depth` dependent shared-memory
// probes, one warp scan, one barrier, a handful of warp reductions, one
// window load) takes about 0.6 us; the 32 warps of S = 4096 take 5.7 us a
// step at depth 11 (46.5 ms for n = 2^25 on ANSfold-2; NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py and python3 -m ans_tpu_torch.probe): the
// bank conflicts of 11 random probes a lane, and what the warps execute
// on the SM's integer pipe, set the time, not the latency.  Neither the
// bytes moved nor the arithmetic come near the card's rates; only a batch
// of streams, one per block, could.
//
// What the design does about it (lockstep.cuh has the step): the pivots
// and the per-symbol high/nb tables live in shared memory; the search
// keeps the dense id in place (probe m | bit, read the bracket after the
// loop: five instructions a level) and the searches of a thread's
// LPT = S/1024 lanes advance level by level together, so their probes
// overlap instead of queueing lane after lane; the stream is staged
// in a shared-memory ring by cp.async one step ahead of the cursor; the
// rounds have static slots and share one packed scan; a step has one
// barrier; the byte reads of a round are one window load per thread;
// a thread stores its outputs 16 bytes at a time.  A frame whose tables
// leave no room for the ring takes the second instance: the same step on
// global loads, with an L2 prefetch ahead of the cursor (ring_bytes = 0;
// the wrapper chooses).  Every read is checked against the stream length:
// a corrupt blob sets the error flag instead of reading out of bounds.
//
// A launch decodes a batch of D streams, each under its own frame (the
// blocks of a pseudo-adaptive container) or all under one (the sections of
// a blocked container; one stream is the batch of one): one block a
// stream, each reading its row of the model array (ops/model_batch.py:
// where its tables lie in the concatenated ones, its depth, sigma, log2m,
// NR and NE; one row with stride 0 for a shared frame, every offset 0),
// loading its tables into its own shared memory, reading its own byte
// range [stream_off[b], stream_off[b + 1]) of the concatenated payloads,
// its states and length n[b], and writing its (T, S) outputs.  A stream
// with n = 0 reads and writes nothing.  The lockstep is per stream, so the
// blocks run side by side.  Shared memory, the exception slots (NES) and
// the ring are one choice for the launch, by the batch's largest frame; a
// stream reads only the rounds of its own frame.
#include "lockstep.cuh"

namespace {

// Stream b's row of the model array: the fields of ops/tables.py
// SearchDevice, (offset, length) of each tensor, then each int.
struct Model {
  int32_t bases_off, bases_len, high_off, high_len, nb_off, nb_len, depth,
      sigma, frame_size, log2m, NR, NE;
};

template <int LPT, int NES, bool RING>
__global__ void __launch_bounds__(1024)
decode_search_kernel(const uint8_t* __restrict__ stream,
                     const int64_t* __restrict__ stream_off,
                     const int32_t* __restrict__ states,
                     const int32_t* __restrict__ bases_g,
                     const int32_t* __restrict__ high_g,
                     const int32_t* __restrict__ nb_g,
                     const int32_t* __restrict__ models, int model_stride,
                     const int64_t* __restrict__ n_of, int T, int S,
                     uint32_t ring_bytes, int32_t* __restrict__ out,
                     int32_t* __restrict__ err) {
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
  bases_g += model.bases_off;
  high_g += model.high_off;
  nb_g += model.nb_off;
  const int depth = model.depth, sigma = model.sigma, log2m = model.log2m;
  const int NR = model.NR, NE = NES > 0 ? model.NE : 0;
  const int64_t stream_len =
      stream_off[blockIdx.x + 1] - stream_off[blockIdx.x];
  stream += stream_off[blockIdx.x];
  states += static_cast<int64_t>(blockIdx.x) * S;
  out += static_cast<int64_t>(blockIdx.x) * T * S;
  const int P = 1 << depth;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);  // ring_bytes
  int32_t* bases = reinterpret_cast<int32_t*>(ring + ring_bytes);  // P + 1
  int32_t* high = bases + P + 1;    // sigma
  int32_t* nbt = high + sigma;      // sigma
  for (int i = threadIdx.x; i <= P; i += blockDim.x) bases[i] = bases_g[i];
  for (int i = threadIdx.x; i < sigma; i += blockDim.x) {
    high[i] = high_g[i];
    // a symbol's exception-byte count becomes the rounds it reads in
    nbt[i] = static_cast<int>(lockstep::fields(min(max(nb_g[i], 0), NE)));
  }
  lockstep::Stream<RING> src;
  src.begin(stream, static_cast<uint32_t>(stream_len),
            static_cast<uint32_t>(S) * (NR + NE), ring, ring_bytes);
  __syncthreads();

  const int l0 = threadIdx.x * LPT;
  const bool owns = l0 < S;  // S < 32 leaves threads idle
  const uint32_t M = 1u << log2m;
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
    // The dense id m, bit by bit from the top: with the bits above k
    // chosen, level k probes bases[m | 1 << k], the first base of the upper
    // half of what is left (bases is the sorted array of cumulative bases,
    // padded with M).  One level of every lane's search at a time: LPT
    // independent probes.  The bracket is bases[m], bases[m + 1].
    int m[LPT];
    uint32_t slot[LPT];
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) {
      m[l] = 0;
      slot[l] = st[l] & (M - 1);
    }
    for (int bit = P >> 1; bit > 0; bit >>= 1) {
#pragma unroll LANE_UNROLL
      for (int l = 0; l < LPT; ++l) {
        const int probe = m[l] | bit;
        m[l] = slot[l] >= static_cast<uint32_t>(bases[probe]) ? probe : m[l];
      }
    }
    uint32_t need[NW][LPT], val[LPT];
#pragma unroll LANE_UNROLL
    for (int l = 0; l < LPT; ++l) {
      const bool valid = l < live;
      const uint32_t lb = static_cast<uint32_t>(bases[m[l]]);
      const uint32_t ub = static_cast<uint32_t>(bases[m[l] + 1]);
      const uint32_t s0 = (ub - lb) * (st[l] >> log2m) + (slot[l] - lb);
      if (valid) st[l] = s0;
      need[0][l] = lockstep::renorm_need(valid ? s0 : ~0u, thr);
      if constexpr (NES > 0)
        need[1][l] = valid ? static_cast<uint32_t>(nbt[m[l]]) : 0u;
      val[l] = static_cast<uint32_t>(high[m[l]]);
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
  const void *stream, *states, *bases, *high, *nb, *models;
  const void *stream_off, *n;
  int model_stride, D;
  int depth, sigma, NE, T, S;  // the batch's largest depth and sigma, NE
  uint32_t ring_bytes;
  void *out, *err;
  cudaStream_t cs;
};

template <int LPT, int NES, bool RING>
cudaError_t launch(const Args& a) {
  auto kernel = decode_search_kernel<LPT, NES, RING>;
  const size_t smem =
      a.ring_bytes +
      sizeof(int32_t) * ((size_t(1) << a.depth) + 1 + 2 * size_t(a.sigma));
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
      static_cast<const int32_t*>(a.bases),
      static_cast<const int32_t*>(a.high), static_cast<const int32_t*>(a.nb),
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
// shorter than 2^31 bytes); states: (D, S) i32; bases: the streams' (2^depth
// + 1,) i32 search bases, high/nb: their (sigma,) i32 tables, each table
// after the other; models: the streams' rows of struct Model (i32), stream
// b's at models + model_stride * b (stride 0: one row for all); max_depth,
// max_sigma: the largest depth and sigma of the rows; NR, NE: the largest
// renorm and exception rounds of the rows; n: (D,) i64 device array, the
// positions of each stream; out: (D, T, S) i32; err: one i32, set to 1 when
// a read passes the end of its stream.  ring_bytes: 0 for the instance on
// global loads, else the size of the shared-memory ring, a power of two >=
// 2 * S * (NR + NE) + 16.  Returns the launch's cudaError_t.
extern "C" int decode_search(const void* stream, const void* stream_off,
                             const void* states, const void* bases,
                             const void* high, const void* nb,
                             const void* models, int model_stride,
                             int max_depth, int max_sigma, int NR, int NE,
                             const void* n, int D, int T, int S,
                             int ring_bytes, void* out, void* err,
                             void* cuda_stream) {
  if (T == 0 || D == 0) return 0;
  if (NR < 0 || NR > 3 || NE < 0 || NE > 3 || ring_bytes < 0 ||
      (ring_bytes & (ring_bytes - 1)) ||
      (ring_bytes && ring_bytes < 2 * S * (NR + NE) + 16) || D < 0 ||
      (S > 1024 && S % 1024) || model_stride < 0 || max_depth < 0 ||
      max_depth > 24 || max_sigma < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpt = S > 1024 ? S / 1024 : 1;
  const Args a{stream, states, bases, high, nb, models, stream_off, n,
               model_stride, D, max_depth, max_sigma, NE, T, S,
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
