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
// cursor, so one stream decodes inside one block, on one SM; each step is
// a chain of dependent shared-memory probes (depth of them), block-wide
// scans with two barriers, and one round of dependent global byte loads.
// Latency, not bandwidth or arithmetic, sets the time.
//
// What the design does about it: the pivots and the per-symbol high/nb
// tables live in shared memory; each thread owns LPT = S/1024 consecutive
// lanes (at most 1024 threads), whose states stay in registers across all
// T steps; all byte loads of a step are issued together after the scan
// (lane::read_merge, shared with K5).
// Every read is checked against the stream length: a corrupt blob sets
// the error flag instead of reading out of bounds.  Decoding a batch of
// streams, one per block, is what fills the card; that is later work.
#include "common.cuh"

namespace {

template <int LPT>
__global__ void __launch_bounds__(1024)
decode_search_kernel(const uint8_t* __restrict__ stream, int64_t stream_len,
                     const int32_t* __restrict__ states,
                     const int32_t* __restrict__ bases_g,
                     const int32_t* __restrict__ high_g,
                     const int32_t* __restrict__ nb_g, int depth, int sigma,
                     int log2m, int NR, int NE, int64_t n, int T, int S,
                     int32_t* __restrict__ out, int32_t* __restrict__ err) {
  extern __shared__ int32_t smem[];
  __shared__ lane::ScanScratch scratch[2];
  const int P = 1 << depth;
  int32_t* bases = smem;            // P + 1 entries
  int32_t* high = bases + P + 1;    // sigma
  int32_t* nbt = high + sigma;      // sigma
  for (int i = threadIdx.x; i <= P; i += blockDim.x) bases[i] = bases_g[i];
  for (int i = threadIdx.x; i < sigma; i += blockDim.x) {
    high[i] = high_g[i];
    nbt[i] = nb_g[i];
  }
  __syncthreads();

  const int l0 = threadIdx.x * LPT;
  const bool owns = l0 < S;  // S < 32 leaves threads idle
  const uint32_t M = 1u << log2m;
  uint32_t st[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l)
    st[l] = owns ? static_cast<uint32_t>(states[l0 + l]) : lane::A_L;

  int64_t cursor = 0;
  bool bad = false;
  for (int t = 0; t < T; ++t) {
    const int64_t row = static_cast<int64_t>(t) * S + l0;
    int m[LPT], rc[LPT], ne[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const bool valid = owns && row + l < n;
      const uint32_t slot = st[l] & (M - 1);
      int mm = 0;
      uint32_t lb = 0, ub = M;
      for (int k = depth - 1; k >= 0; --k) {
        const uint32_t pv =
            static_cast<uint32_t>(bases[(mm << (k + 1)) | (1 << k)]);
        const bool take = slot >= pv;
        mm = 2 * mm + take;
        lb = take ? pv : lb;
        ub = take ? ub : pv;
      }
      const uint32_t s0 = (ub - lb) * (st[l] >> log2m) + (slot - lb);
      if (valid) st[l] = s0;
      int r = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r += valid && j < NR && st[l] < (lane::A_L >> (8 * j));
      m[l] = mm;
      rc[l] = r;
      ne[l] = valid ? nbt[mm] : 0;
    }
    uint32_t low[LPT];
    cursor = lane::read_merge<LPT>(stream, stream_len, cursor, NR, NE, rc, ne,
                                   st, low, bad, scratch[t & 1]);
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      if (owns) out[row + l] = static_cast<int32_t>(high[m[l]] + low[l]);
  }
  if (bad) *err = 1;
}

template <int LPT>
cudaError_t launch(const void* stream, int64_t stream_len, const void* states,
                   const void* bases, const void* high, const void* nb,
                   int depth, int sigma, int log2m, int NR, int NE,
                   int64_t n, int T, int S, void* out, void* err,
                   cudaStream_t cs) {
  auto kernel = decode_search_kernel<LPT>;
  const size_t smem =
      sizeof(int32_t) * ((size_t(1) << depth) + 1 + 2 * size_t(sigma));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<1, lane::block_threads(S), smem, cs>>>(
      static_cast<const uint8_t*>(stream), stream_len,
      static_cast<const int32_t*>(states), static_cast<const int32_t*>(bases),
      static_cast<const int32_t*>(high), static_cast<const int32_t*>(nb),
      depth, sigma, log2m, NR, NE, n, T, S, static_cast<int32_t*>(out),
      static_cast<int32_t*>(err));
  return cudaGetLastError();
}

}  // namespace

// stream: (stream_len,) u8; states: (S,) i32; bases: (2^depth + 1,) i32;
// high/nb: (sigma,) i32; out: (T, S) i32; err: one i32, set to 1 when a
// read passes the end of the stream.  Returns the launch's cudaError_t.
extern "C" int decode_search(const void* stream, int64_t stream_len,
                             const void* states, const void* bases,
                             const void* high, const void* nb, int depth,
                             int sigma, int log2m, int NR, int NE, int64_t n,
                             int T, int S, void* out, void* err,
                             void* cuda_stream) {
  if (T == 0) return 0;
  const int lpt = S > 1024 ? S / 1024 : 1;
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  cudaError_t e;
  switch (lpt) {
    case 1: e = launch<1>(stream, stream_len, states, bases, high, nb, depth,
                          sigma, log2m, NR, NE, n, T, S, out, err, cs); break;
    case 2: e = launch<2>(stream, stream_len, states, bases, high, nb, depth,
                          sigma, log2m, NR, NE, n, T, S, out, err, cs); break;
    case 4: e = launch<4>(stream, stream_len, states, bases, high, nb, depth,
                          sigma, log2m, NR, NE, n, T, S, out, err, cs); break;
    case 8: e = launch<8>(stream, stream_len, states, bases, high, nb, depth,
                          sigma, log2m, NR, NE, n, T, S, out, err, cs); break;
    case 16: e = launch<16>(stream, stream_len, states, bases, high, nb,
                            depth, sigma, log2m, NR, NE, n, T, S, out, err,
                            cs); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
