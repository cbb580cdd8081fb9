// K6: the reverse rANS encode scan in rank space, under the
// frequency-grouped slot layout (frames with more than 2^13 live symbols).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_encode.py `_kernel` with
// grouped=True (the branch at :137-158), reached through
// `encode_scan_grouped` and `_call`.
//
// What it computes: K1's scan (csrc/encode_scan.cu, lane::encode_step),
// with the symbol's freq, base and magic found in rank space.  The input is
// a rank, or a symbol id mapped to its rank through rank_of (rank =
// rank_of[sym & 0xFFFFFF]).  A bitwise binary search over the NG group rank
// boundaries gives the group m and its first rank lbr; f = g_f[m],
// base = g_slot0[m] + (rank - lbr) * f, magic = g_magic[m].  A symbol or a
// rank outside the tables sets the error flag and codes as rank 0.
//
// What bounds it on the card: latency, as K1.  One thread per lane walks
// T steps; each step is a chain of dependent loads (the symbol, its rank,
// depth shared-memory probes, the group row) ahead of K1's arithmetic.
//
// What the design does about it: the NG-sized group rows [f, magic, slot0,
// rank0] (one 16-byte load) and the rank boundaries live in shared memory,
// at most 16*2896 + 4*4097 bytes since NG <= sqrt(2M); the sigma-sized
// rank_of is read from global memory through __ldg.  The next step's
// symbol, rank and group row are fetched before the current step's
// arithmetic, so their latency overlaps it.  The tables stay NG-sized: no
// per-rank freq/base table is built.
#include "common.cuh"

namespace {

struct Tables {
  const int4* groups;      // shared: NG rows [f, magic, slot0, rank0]
  const int32_t* bases;    // shared: 2^depth + 1 rank boundaries
  const int32_t* rank_of;  // global, or nullptr when the input is ranks
  int64_t n_rank_of;
  int depth;
  uint32_t sigma;
};

// [f, base, magic] of the symbol at idx (zeros past n).
__device__ __forceinline__ int4 lookup(const int32_t* __restrict__ syms,
                                       const Tables& tb, int64_t idx,
                                       int64_t n, int32_t* err) {
  if (idx >= n) return make_int4(0, 0, 0, 0);
  uint32_t r = static_cast<uint32_t>(__ldg(syms + idx));
  if (tb.rank_of != nullptr) {
    const uint32_t s = r & 0xFFFFFFu;
    if (s >= tb.n_rank_of) {
      *err = 1;
      r = 0;
    } else {
      r = static_cast<uint32_t>(__ldg(tb.rank_of + s));
    }
  }
  if (r >= tb.sigma) {
    *err = 1;  // rank outside the frame: flag it, encode it as rank 0
    r = 0;
  }
  int m = 0;
  uint32_t lbr = 0;
  for (int k = tb.depth - 1; k >= 0; --k) {
    const uint32_t pv =
        static_cast<uint32_t>(tb.bases[(m << (k + 1)) | (1 << k)]);
    const bool take = r >= pv;
    m = 2 * m + take;
    lbr = take ? pv : lbr;
  }
  const int4 g = tb.groups[m];
  const uint32_t f = static_cast<uint32_t>(g.x);
  return make_int4(g.x, static_cast<int32_t>(g.z + (r - lbr) * f), g.y, 0);
}

__global__ void encode_scan_grouped_kernel(
    const int32_t* __restrict__ syms, const int4* __restrict__ groups_g,
    const int32_t* __restrict__ bases_g, const int32_t* __restrict__ rank_of,
    int64_t n_rank_of, int NG, int depth, int sigma, int64_t n, int T, int S,
    int log2m, int32_t* __restrict__ packed, int32_t* __restrict__ states,
    int32_t* __restrict__ err) {
  extern __shared__ int4 smem[];
  int4* groups = smem;
  int32_t* bases = reinterpret_cast<int32_t*>(groups + NG);
  const int P = 1 << depth;
  for (int i = threadIdx.x; i < NG; i += blockDim.x) groups[i] = groups_g[i];
  for (int i = threadIdx.x; i <= P; i += blockDim.x) bases[i] = bases_g[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const Tables tb{groups, bases, rank_of, n_rank_of, depth,
                  static_cast<uint32_t>(sigma)};
  uint32_t st = lane::A_L;
  int64_t idx = static_cast<int64_t>(T - 1) * S + lane;
  int4 next = T > 0 ? lookup(syms, tb, idx, n, err) : make_int4(0, 0, 0, 0);
  for (int t = T - 1; t >= 0; --t, idx -= S) {
    const int4 row = next;
    if (t > 0) next = lookup(syms, tb, idx - S, n, err);
    uint32_t word;
    if (idx < n) {
      word = lane::encode_step(st, static_cast<uint32_t>(row.x),
                               static_cast<uint32_t>(row.y),
                               static_cast<uint32_t>(row.z), log2m);
    } else {
      const uint32_t b = st & 0xFF;  // pad position: no bytes, state kept
      word = b | (b << 8) | (b << 16);
    }
    packed[idx] = static_cast<int32_t>(word);
  }
  states[lane] = static_cast<int32_t>(st);
}

}  // namespace

// syms: (T, S) i32 ranks, or symbol ids when rank_of (n_rank_of i32
// entries) is not null; groups: (NG, 4) i32 rows [f, magic, slot0, rank0];
// bases: (2^depth + 1,) i32 group rank boundaries padded with sigma;
// packed: (T, S) i32 out; states: (S,) i32 out; err: one i32, set to 1 when
// a symbol or a rank lies outside the tables.  Returns the cudaError_t.
extern "C" int encode_scan_grouped(const void* syms, const void* groups,
                                   const void* bases, const void* rank_of,
                                   int64_t n_rank_of, int NG, int depth,
                                   int sigma, int64_t n, int T, int S,
                                   int log2m, void* packed, void* states,
                                   void* err, void* stream) {
  const int threads = S < 256 ? (S < 32 ? 32 : S) : 256;
  const int blocks = (S + threads - 1) / threads;
  const size_t smem =
      16 * size_t(NG) + sizeof(int32_t) * ((size_t(1) << depth) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_scan_grouped_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  encode_scan_grouped_kernel<<<blocks, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(syms), static_cast<const int4*>(groups),
      static_cast<const int32_t*>(bases),
      static_cast<const int32_t*>(rank_of), n_rank_of, NG, depth, sigma, n,
      T, S, log2m, static_cast<int32_t*>(packed),
      static_cast<int32_t*>(states), static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
