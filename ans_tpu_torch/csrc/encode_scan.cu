// K1: the reverse rANS encode scan of the lane format (fmt 2).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_encode.py `_kernel`
// (grouped=False), reached through `encode_scan` and `_call`.
//
// What it computes: for every lane, walk the steps t = T-1 .. 0; look up
// the symbol's freq, base and Granlund-Montgomery magic; emit up to three
// renorm bytes while state >= ub (ub = f << (31 - log2m)); divide by f
// with a multiply-high; state = (q << log2m) + r + base.  Each (step,
// lane) gets the packed word r0 | r1<<8 | r2<<16 | rc<<24, where byte
// slot i is the low byte of the state after the first i conditional
// shifts (so unused slots repeat the last byte, or the state's low byte
// when rc = 0), and each lane its final state.  An absent symbol (freq 0)
// codes as freq 1; a symbol outside the table sets the error flag and
// codes as symbol 0.
//
// What bounds it on the card: the latency of one lane's state chain.  The
// scan is sequential in t and independent across lanes; a step's
// arithmetic (lane::encode_step) is a chain of about forty dependent
// instructions, and T of them follow each other whatever else the card
// does.  The lookup in front of it (the symbol from device memory, then
// its table row) does not depend on the state.
//
// What the design does about it (encode_ahead.cuh has the mechanism, K6
// runs on it too): a block owns 32 lanes, so S = 4096 spreads over 128 of
// the 132 SMs; lookup warps resolve the rows of a tile of 32 steps ahead
// of the one chain warp, and the chain reads each step's row with one
// shared-memory load, in a loop with no branch.  The (sigma, 4) table sits
// in shared memory behind the tile when it fits (sigma <= 12,288: 192 KB
// of rows beside the 32 KB tile), so a row is one shared-memory load after
// the symbol's global load; a larger, sparser table is read through __ldg.
// Division keeps the TPU kernel's magic (an exact `__umulhi` sequence)
// rather than the card's slow 32-bit divide.
//
// A launch scans a batch of D streams, each under its own table (the
// blocks of a pseudo-adaptive container) or all under one (the sections of
// a blocked container; one stream is the batch of one): the grid is
// (S / 32, D), and stream d's blocks read its row of the model array
// (ops/model_batch.py: where its table lies in the concatenated rows, its
// sigma and log2m; one row with stride 0 for a shared table, every offset
// 0), its symbols and its own length n[d], and write its words and states.
// Whether the tables go to shared memory is one choice for the launch, by
// the batch's largest.
#include "encode_ahead.cuh"

namespace {

// Stream d's row of the model array: the fields of ops/tables.py
// EncDevice, (offset, length) of each tensor, then each int.
struct Model {
  int32_t words_off, words_len, frame_size, log2m;
};

// the rows of the table that fit in shared memory beside the tile
constexpr int SMEM_TABLE_ROWS = 12288;

// The lookup of one position: its symbol, then its row.
template <bool SMEM_TABLE>
struct Find {
  const int32_t* syms;   // global: (T, S) symbol ids
  const int4* table_g;   // global: (sigma, 4) rows [f, base, magic, 0]
  int table_at;          // ahead::smem[table_at ..]: the same rows
  uint32_t sigma;
  int32_t* err;

  __device__ __forceinline__ uint32_t fetch(int64_t idx) const {
    return static_cast<uint32_t>(__ldg(syms + idx));
  }

  __device__ __forceinline__ void prefetch(int64_t idx) const {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(syms + idx));
  }

  // The rows [max(f, 1), base, magic, 0] of a batch of symbols x (zero rows
  // where in[b] is not set).  Every row load is started before any is
  // looked at: a symbol outside the table reads row 0 and is flagged.
  template <int B>
  __device__ __forceinline__ void rows(const uint32_t (&x)[B],
                                       const bool (&in)[B],
                                       int4 (&row)[B]) const {
    int4 r[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const uint32_t s = x[b] < sigma ? x[b] : 0u;
      r[b] = SMEM_TABLE ? ahead::smem[table_at + s] : __ldg(table_g + s);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (in[b] && x[b] >= sigma) *err = 1;  // flag it, code symbol 0
      // an absent symbol (freq 0) codes as freq 1, as the plain version
      row[b] = in[b] ? make_int4(max(r[b].x, 1), r[b].y, r[b].z, 0)
                     : make_int4(0, 0, 0, 0);
    }
  }
};

template <bool SMEM_TABLE>
__global__ void encode_scan_kernel(const int32_t* __restrict__ syms,
                                   const int4* __restrict__ table,
                                   const int32_t* __restrict__ models,
                                   int model_stride,
                                   const int64_t* __restrict__ n_of, int T,
                                   int S, int32_t* __restrict__ packed,
                                   int32_t* __restrict__ states,
                                   int32_t* __restrict__ err) {
  // stream blockIdx.y of the batch: its table, symbols, length, words and
  // states
  const Model model =
      lane::model_row<Model>(models, model_stride, blockIdx.y);
  table += model.words_off;
  const int sigma = model.words_len;
  const int log2m = model.log2m;
  const int64_t at = static_cast<int64_t>(blockIdx.y) * T * S;
  syms += at;
  packed += at;
  states += static_cast<int64_t>(blockIdx.y) * S;
  const int64_t n = n_of[blockIdx.y];
  const int table_at = ahead::TILE_ROWS;
  if (SMEM_TABLE) {
    for (int i = threadIdx.x; i < sigma; i += blockDim.x)
      ahead::smem[table_at + i] = table[i];
    __syncthreads();
  }
  const Find<SMEM_TABLE> find{syms, table, table_at,
                              static_cast<uint32_t>(sigma), err};
  ahead::scan_block(T, S, n, log2m, find, packed, states);
}

template <bool SMEM_TABLE>
int launch(const void* syms, const void* table, const void* models,
           int model_stride, int sigma, const void* n, int D, int T, int S,
           void* packed, void* states, void* err, cudaStream_t stream) {
  const dim3 blocks((S + ahead::L - 1) / ahead::L, D);
  const size_t smem =
      16 * (size_t(ahead::TILE_ROWS) + (SMEM_TABLE ? size_t(sigma) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_scan_kernel<SMEM_TABLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  encode_scan_kernel<SMEM_TABLE><<<blocks, ahead::THREADS, smem, stream>>>(
      static_cast<const int32_t*>(syms), static_cast<const int4*>(table),
      static_cast<const int32_t*>(models), model_stride,
      static_cast<const int64_t*>(n), T, S, static_cast<int32_t*>(packed),
      static_cast<int32_t*>(states), static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// syms: (D, T, S) i32; table: the streams' (sigma, 4) i32 rows [freq,
// base, magic, 0], one table after the other; models: the streams' rows of
// struct Model (i32), stream d's at models + model_stride * d (stride 0: one
// row for all); max_sigma: the largest words_len of the rows; n: (D,) i64
// device array, the positions of each stream; packed: (D, T, S) i32 out;
// states: (D, S) i32 out; err: one i32, set to 1 when a symbol lies outside
// its stream's table.  D <= 65535.  Returns the launch's cudaError_t.
extern "C" int encode_scan(const void* syms, const void* table,
                           const void* models, int model_stride,
                           int max_sigma, const void* n, int D, int T, int S,
                           void* packed, void* states, void* err,
                           void* stream) {
  if (S == 0 || D == 0) return 0;
  if (D < 0 || D > 65535 || model_stride < 0 || max_sigma < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return max_sigma <= SMEM_TABLE_ROWS
             ? launch<true>(syms, table, models, model_stride, max_sigma, n,
                            D, T, S, packed, states, err, s)
             : launch<false>(syms, table, models, model_stride, max_sigma, n,
                             D, T, S, packed, states, err, s);
}
