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
// What bounds it on the card: the latency of one lane's state chain.  The
// scan is sequential in t; a step's arithmetic (three compares and shifts,
// a multiply-high divide, a multiply and a few adds) is a chain of about
// forty dependent instructions, and T of them follow each other whatever
// else the card does.  The lookup in front of it (the symbol from device
// memory, its rank through rank_of, `depth` shared-memory probes, the group
// row) is a chain several times longer, but independent of the state.
//
// What the design does about it (encode_ahead.cuh has the mechanism): the
// lookups run a tile of 32 steps ahead of the chain, in warps of their
// own, four of them in flight a thread and their searches advancing level
// by level together, and hand the rows [f, base, magic] over in shared
// memory; the chain's loop has no branch; a block owns 32 lanes, so
// S = 4096 spreads over 128 of the 132 SMs.  The NG-sized
// group rows [f, magic, slot0, rank0] (one 16-byte load) and the rank
// boundaries live in shared memory, at most 16*2896 + 4*4097 bytes since
// NG <= sqrt(2M); the sigma-sized rank_of is read from global memory
// through __ldg.  The tables stay NG-sized: no per-rank freq/base table is
// built.
//
// A launch scans a batch of D streams, each under its own tables or all
// under one set, as K1 does: the grid is (S / 32, D), stream d's blocks
// reading its row of the model array (ops/model_batch.py: where its group
// rows, rank boundaries and rank_of lie in the concatenated tables, its
// depth, sigma and log2m), its inputs and length n[d] and writing its words
// and states.  The shared memory of a launch holds the batch's largest
// group table.
#include "encode_ahead.cuh"

namespace {

// Stream d's row of the model array: the fields of ops/tables.py
// GroupedEncDevice, (offset, length) of each tensor, then each int
// (rank_of_off -1: the stream's inputs are ranks).
struct Model {
  int32_t groups_off, groups_len, bases_off, bases_len, rank_of_off,
      rank_of_len, depth, sigma, frame_size, log2m;
};

// The lookup of one position: its symbol or rank, then its row.
struct Find {
  const int32_t* syms;     // global: (T, S) ranks or symbol ids
  int groups_at;           // ahead::smem[groups_at ..]: NG rows [f, magic,
                           // slot0, rank0], then 2^depth + 1 rank boundaries
  int NG;
  const int32_t* rank_of;  // global, or nullptr when the input is ranks
  int64_t n_rank_of;
  int depth;
  uint32_t sigma;
  int32_t* err;

  __device__ __forceinline__ uint32_t fetch(int64_t idx) const {
    return static_cast<uint32_t>(__ldg(syms + idx));
  }

  __device__ __forceinline__ void prefetch(int64_t idx) const {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(syms + idx));
  }

  // The rows [f, base, magic, 0] of a batch of ranks or symbol ids x (zero
  // rows where in[b] is not set).  The batch's rank_of loads start
  // together, and its searches advance level by level together: B
  // independent probes a level, where one lookup after the other would
  // queue B * depth dependent ones.
  template <int B>
  __device__ __forceinline__ void rows(const uint32_t (&x)[B],
                                       const bool (&in)[B],
                                       int4 (&row)[B]) const {
    const int4* groups = ahead::smem + groups_at;
    const int32_t* bases = reinterpret_cast<const int32_t*>(groups + NG);
    // every load is started before any result is looked at: an index
    // outside the table reads entry 0 and is flagged afterwards
    uint32_t r[B];
    bool bad[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      r[b] = x[b];
      bad[b] = false;
      if (rank_of != nullptr) {
        const uint32_t s = x[b] & 0xFFFFFFu;
        bad[b] = s >= n_rank_of;
        r[b] = static_cast<uint32_t>(__ldg(rank_of + (bad[b] ? 0u : s)));
      }
    }
    int m[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      bad[b] |= r[b] >= sigma;  // a rank outside the frame
      if (bad[b]) {
        if (in[b]) *err = 1;  // flag it, code rank 0
        r[b] = 0;
      }
      m[b] = 0;
    }
    for (int bit = (1 << depth) >> 1; bit > 0; bit >>= 1) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int probe = m[b] | bit;
        m[b] = r[b] >= static_cast<uint32_t>(bases[probe]) ? probe : m[b];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int4 g = groups[m[b]];
      const uint32_t f = static_cast<uint32_t>(g.x);
      row[b] = in[b] ? make_int4(g.x,
                                 static_cast<int32_t>(
                                     g.z +
                                     (r[b] - static_cast<uint32_t>(g.w)) * f),
                                 g.y, 0)
                     : make_int4(0, 0, 0, 0);
    }
  }
};

// Blocks an SM should hold: 1440 threads, five blocks of THREADS = 288,
// as many as the tile and a group table leave shared memory for.  The
// bound holds a thread to 40 registers: at 42 (the model row's fields in
// registers) a warp takes one more allocation granule and an SM holds four
// blocks (32 sections of ANSfold-7 over zipf20, NVIDIA H100 80GB HBM3,
// 700 W: 289 us a launch at 42 registers, 268 at 40 with 8 bytes spilled).
constexpr int MIN_BLOCKS = 1440 / ahead::THREADS > 0 ? 1440 / ahead::THREADS
                                                     : 1;

__global__ void __launch_bounds__(ahead::THREADS, MIN_BLOCKS)
encode_scan_grouped_kernel(
    const int32_t* __restrict__ syms, const int4* __restrict__ groups_g,
    const int32_t* __restrict__ bases_g, const int32_t* __restrict__ rank_of,
    const int32_t* __restrict__ models, int model_stride,
    const int64_t* __restrict__ n_of, int T, int S,
    int32_t* __restrict__ packed, int32_t* __restrict__ states,
    int32_t* __restrict__ err) {
  // stream blockIdx.y of the batch: its tables, inputs, length, words and
  // states
  const Model model =
      lane::model_row<Model>(models, model_stride, blockIdx.y);
  groups_g += model.groups_off;
  bases_g += model.bases_off;
  const int NG = model.groups_len;
  const int depth = model.depth;
  const int sigma = model.sigma;
  const int log2m = model.log2m;
  const int64_t n_rank_of = model.rank_of_len;
  if (model.rank_of_off < 0)
    rank_of = nullptr;
  else
    rank_of += model.rank_of_off;
  const int64_t at = static_cast<int64_t>(blockIdx.y) * T * S;
  syms += at;
  packed += at;
  states += static_cast<int64_t>(blockIdx.y) * S;
  const int64_t n = n_of[blockIdx.y];
  const int groups_at = ahead::TILE_ROWS;
  int4* groups = ahead::smem + groups_at;
  int32_t* bases = reinterpret_cast<int32_t*>(groups + NG);
  const int P = 1 << depth;
  for (int i = threadIdx.x; i < NG; i += blockDim.x) groups[i] = groups_g[i];
  for (int i = threadIdx.x; i <= P; i += blockDim.x) bases[i] = bases_g[i];
  __syncthreads();
  const Find find{syms, groups_at, NG, rank_of, n_rank_of, depth,
                  static_cast<uint32_t>(sigma), err};
  ahead::scan_block(T, S, n, log2m, find, packed, states);
}

}  // namespace

// syms: (D, T, S) i32 ranks, or symbol ids for a stream whose row has a
// rank_of (rank_of_len i32 entries); groups: the streams' (NG, 4) i32 rows
// [f, magic, slot0, rank0], bases: their (2^depth + 1,) i32 group rank
// boundaries padded with sigma, rank_of: their symbol -> rank maps, each
// table after the other (rank_of null when no stream has one); models: the
// streams' rows of struct Model (i32), stream d's at models + model_stride
// * d (stride 0: one row for all); max_groups / max_depth: the largest
// groups_len and depth of the rows; n: (D,) i64 device array, the positions
// of each stream; packed: (D, T, S) i32 out; states: (D, S) i32 out; err:
// one i32, set to 1 when a symbol or a rank lies outside its stream's
// tables.  D <= 65535.  Returns the cudaError_t.
extern "C" int encode_scan_grouped(const void* syms, const void* groups,
                                   const void* bases, const void* rank_of,
                                   const void* models, int model_stride,
                                   int max_groups, int max_depth,
                                   const void* n, int D, int T, int S,
                                   void* packed, void* states, void* err,
                                   void* stream) {
  if (S == 0 || D == 0) return 0;
  if (D < 0 || D > 65535 || model_stride < 0 || max_groups < 0 ||
      max_depth < 0 || max_depth > 24)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NG = max_groups, depth = max_depth;
  const int threads = ahead::THREADS;
  const dim3 blocks((S + ahead::L - 1) / ahead::L, D);
  const size_t smem =
      16 * (size_t(ahead::TILE_ROWS) + NG) +
      sizeof(int32_t) * ((size_t(1) << depth) + 1);
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
      static_cast<const int32_t*>(rank_of),
      static_cast<const int32_t*>(models), model_stride,
      static_cast<const int64_t*>(n), T, S, static_cast<int32_t*>(packed),
      static_cast<int32_t*>(states), static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
