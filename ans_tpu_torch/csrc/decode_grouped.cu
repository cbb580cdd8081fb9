// K5: lockstep decode of one fmt-2 stream under the frequency-grouped slot
// layout (frames with more than 2^13 live symbols).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_decode.py `_kernel_grouped`
// (with `_read_merge`), reached through `stage_grouped` and `_call_grouped`.
//
// What it computes, per step t and lane: slot = state & (M-1); a bitwise
// binary search over the NG group slot boundaries gives the group m and its
// first slot lb; x = slot - lb and j = x / f (f = g_f[m]) by the
// Granlund-Montgomery multiply-high, f == 1 selected around it; rank =
// g_rank0[m] + j; st0 = f * (state >> log2m) + (x - j*f).  The renorm and
// exception byte counts (st0 < L >> 8j for j < NR; nb[rank]) are known
// before any read, so the bytes come in as in K3 (lane::read_merge: block
// ranks per round, one global cursor, high-first merge).  The value is
// table[rank] + the exception bytes, or the rank itself when there is no
// table.  The TPU kernel's per-section cursor reset, split windows and
// bit-packed plane scans are not carried over.
//
// What bounds it on the card: the lockstep, as K3.  All S lanes share one
// byte cursor, so one stream decodes in one block on one SM; each step is
// a chain of dependent shared-memory probes, a divide, block-wide scans
// behind two barriers and a round of dependent byte loads.
//
// What the design does about it: one block per stream, LPT = S/1024 lanes
// per thread with their states in registers; the group rows [f, magic,
// slot0, rank0] and the slot boundaries (NG <= 2896, at most ~63 KB) live
// in shared memory.  The per-rank table and nb live there too when they fit
// (SMEM_TABLE; fold-7 on 2^20-value data: sigma ~20k, ~100 KB); otherwise
// (raw-value tables up to ~2^20 entries) they are read from global memory
// through __ldg, issued before the step's block scan so their latency
// overlaps it.  Every stream read is checked against the stream length.
#include "common.cuh"

namespace {

template <int LPT, bool SMEM_TABLE>
__global__ void __launch_bounds__(1024)
decode_grouped_kernel(const uint8_t* __restrict__ stream, int64_t stream_len,
                      const int32_t* __restrict__ states,
                      const int4* __restrict__ groups_g,
                      const int32_t* __restrict__ bases_g,
                      const int32_t* __restrict__ table_g,
                      const uint8_t* __restrict__ nb_g, int NG, int depth,
                      int sigma, int log2m, int NR, int NE, int64_t n, int T,
                      int S, int32_t* __restrict__ out,
                      int32_t* __restrict__ err) {
  extern __shared__ int4 smem[];
  __shared__ lane::ScanScratch scratch[2];
  const int P = 1 << depth;
  const bool has_table = table_g != nullptr;
  int4* groups = smem;                                       // NG
  int32_t* bases = reinterpret_cast<int32_t*>(groups + NG);  // P + 1
  int32_t* table_s = bases + P + 1;                          // sigma
  uint8_t* nb_s = reinterpret_cast<uint8_t*>(
      table_s + (has_table ? sigma : 0));                    // sigma
  for (int i = threadIdx.x; i < NG; i += blockDim.x) groups[i] = groups_g[i];
  for (int i = threadIdx.x; i <= P; i += blockDim.x) bases[i] = bases_g[i];
  if (SMEM_TABLE) {
    if (has_table)
      for (int i = threadIdx.x; i < sigma; i += blockDim.x)
        table_s[i] = table_g[i];
    if (NE > 0)
      for (int i = threadIdx.x; i < sigma; i += blockDim.x) nb_s[i] = nb_g[i];
  }
  __syncthreads();
  auto table_at = [&](uint32_t r) -> uint32_t {
    return static_cast<uint32_t>(SMEM_TABLE ? table_s[r] : __ldg(table_g + r));
  };
  auto nb_at = [&](uint32_t r) -> int {
    return SMEM_TABLE ? nb_s[r] : __ldg(nb_g + r);
  };

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
    uint32_t val[LPT];
    int rc[LPT], ne[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const bool valid = owns && row + l < n;
      const uint32_t slot = st[l] & (M - 1);
      int m = 0;
      uint32_t lb = 0;
      for (int k = depth - 1; k >= 0; --k) {
        const uint32_t pv =
            static_cast<uint32_t>(bases[(m << (k + 1)) | (1 << k)]);
        const bool take = slot >= pv;
        m = 2 * m + take;
        lb = take ? pv : lb;
      }
      const int4 g = groups[m];
      const uint32_t f = static_cast<uint32_t>(g.x);
      const uint32_t x = slot - lb;
      const uint32_t j = f == 1 ? x : lane::gm_div(x, f, g.y);
      const uint32_t rank = static_cast<uint32_t>(g.w) + j;
      if (valid) st[l] = f * (st[l] >> log2m) + (x - j * f);
      int r = 0;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        r += valid && jj < NR && st[l] < (lane::A_L >> (8 * jj));
      rc[l] = r;
      ne[l] = valid && NE > 0 ? nb_at(rank) : 0;
      val[l] = owns && has_table ? table_at(rank) : rank;
    }
    uint32_t low[LPT];
    cursor = lane::read_merge<LPT>(stream, stream_len, cursor, NR, NE, rc, ne,
                                   st, low, bad, scratch[t & 1]);
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      if (owns) out[row + l] = static_cast<int32_t>(val[l] + low[l]);
  }
  if (bad) *err = 1;
}

// Shared bytes of the group rows and slot boundaries, and of the per-rank
// table and nb.
size_t group_bytes(int NG, int depth) {
  return 16 * size_t(NG) + sizeof(int32_t) * ((size_t(1) << depth) + 1);
}
size_t table_bytes(bool has_table, int sigma, int NE) {
  return (has_table ? sizeof(int32_t) * size_t(sigma) : 0) +
         (NE > 0 ? size_t(sigma) : 0);
}

// dynamic shared memory a block may take beside the scan scratch
constexpr size_t SMEM_LIMIT = 220 * 1024;

template <int LPT, bool SMEM_TABLE>
cudaError_t launch(const void* stream, int64_t stream_len, const void* states,
                   const void* groups, const void* bases, const void* table,
                   const void* nb, int NG, int depth, int sigma, int log2m,
                   int NR, int NE, int64_t n, int T, int S, void* out,
                   void* err, cudaStream_t cs) {
  auto kernel = decode_grouped_kernel<LPT, SMEM_TABLE>;
  const size_t smem =
      group_bytes(NG, depth) +
      (SMEM_TABLE ? table_bytes(table != nullptr, sigma, NE) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<1, lane::block_threads(S), smem, cs>>>(
      static_cast<const uint8_t*>(stream), stream_len,
      static_cast<const int32_t*>(states), static_cast<const int4*>(groups),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(table),
      static_cast<const uint8_t*>(nb), NG, depth, sigma, log2m, NR, NE, n, T,
      S, static_cast<int32_t*>(out), static_cast<int32_t*>(err));
  return cudaGetLastError();
}

template <int LPT>
cudaError_t launch_lpt(bool smem_table, const void* stream,
                       int64_t stream_len, const void* states,
                       const void* groups, const void* bases,
                       const void* table, const void* nb, int NG, int depth,
                       int sigma, int log2m, int NR, int NE, int64_t n, int T,
                       int S, void* out, void* err, cudaStream_t cs) {
  return smem_table
             ? launch<LPT, true>(stream, stream_len, states, groups, bases,
                                 table, nb, NG, depth, sigma, log2m, NR, NE,
                                 n, T, S, out, err, cs)
             : launch<LPT, false>(stream, stream_len, states, groups, bases,
                                  table, nb, NG, depth, sigma, log2m, NR, NE,
                                  n, T, S, out, err, cs);
}

}  // namespace

// stream: (stream_len,) u8; states: (S,) i32; groups: (NG, 4) i32 rows
// [f, magic, slot0, rank0]; bases: (2^depth + 1,) i32 group slot boundaries
// padded with M; table: (sigma,) i32 per-rank value or high part, or null
// (the rank is the value); nb: (sigma,) u8 exception bytes per rank, read
// when NE > 0; out: (T, S) i32; err: one i32, set to 1 when a read passes
// the end of the stream.  Returns the launch's cudaError_t.
extern "C" int decode_grouped(const void* stream, int64_t stream_len,
                              const void* states, const void* groups,
                              const void* bases, const void* table,
                              const void* nb, int NG, int depth, int sigma,
                              int log2m, int NR, int NE, int64_t n, int T,
                              int S, void* out, void* err,
                              void* cuda_stream) {
  if (T == 0) return 0;
  const int lpt = S > 1024 ? S / 1024 : 1;
  const bool smem_table = group_bytes(NG, depth) +
                              table_bytes(table != nullptr, sigma, NE) <=
                          SMEM_LIMIT;
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  cudaError_t e;
  switch (lpt) {
    case 1: e = launch_lpt<1>(smem_table, stream, stream_len, states, groups,
                              bases, table, nb, NG, depth, sigma, log2m, NR,
                              NE, n, T, S, out, err, cs); break;
    case 2: e = launch_lpt<2>(smem_table, stream, stream_len, states, groups,
                              bases, table, nb, NG, depth, sigma, log2m, NR,
                              NE, n, T, S, out, err, cs); break;
    case 4: e = launch_lpt<4>(smem_table, stream, stream_len, states, groups,
                              bases, table, nb, NG, depth, sigma, log2m, NR,
                              NE, n, T, S, out, err, cs); break;
    case 8: e = launch_lpt<8>(smem_table, stream, stream_len, states, groups,
                              bases, table, nb, NG, depth, sigma, log2m, NR,
                              NE, n, T, S, out, err, cs); break;
    case 16: e = launch_lpt<16>(smem_table, stream, stream_len, states,
                                groups, bases, table, nb, NG, depth, sigma,
                                log2m, NR, NE, n, T, S, out, err, cs); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
