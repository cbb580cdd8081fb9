// The earlier form of K1, before it moved onto csrc/encode_ahead.cuh (one
// thread a lane, the row lookup on the state chain).  Kept only for
// `python3 -m ans_tpu_torch.bench_steps`, which builds it in a copy of
// csrc/ and times it beside the kernel as it is; no codec path builds or
// calls it.
//
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
// when rc = 0), and each lane its final state.
//
// What bounds it on the card: latency.  The scan is sequential in t and
// independent across lanes, so S lanes give S threads: at S = 4096 that
// is 16 blocks of 256, on 16 of the 132 SMs.  Each step is a short chain
// of dependent integer operations behind two dependent loads (the symbol,
// then its table row); bytes moved (8 per symbol) are far below the
// memory system's rate.
//
// What the design does about it: one thread per lane, reading the (T, S)
// symbols at t*S + lane so a warp reads 32 consecutive words and writes
// 32 consecutive packed words; the table row [freq, base, magic, 0] is one
// 16-byte load; the next step's symbol and table row are loaded before
// the current step's arithmetic, so their latency overlaps it.  Division
// keeps the TPU kernel's magic (an exact `__umulhi` sequence) rather than
// the card's slow 32-bit divide.  Batching streams to fill the card is
// later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ int4 load_row(const int32_t* __restrict__ syms,
                                         const int4* __restrict__ table,
                                         int64_t idx, int64_t n, int sigma,
                                         int32_t* err) {
  if (idx >= n) return make_int4(0, 0, 0, 0);
  int s = __ldg(syms + idx);
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(sigma)) {
    *err = 1;  // symbol outside the table: flag it, encode it as symbol 0
    s = 0;
  }
  return __ldg(table + s);
}

__global__ void encode_scan_kernel(const int32_t* __restrict__ syms,
                                   const int4* __restrict__ table, int sigma,
                                   int64_t n, int T, int S, int log2m,
                                   int32_t* __restrict__ packed,
                                   int32_t* __restrict__ states,
                                   int32_t* __restrict__ err) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  uint32_t st = lane::A_L;
  int64_t idx = static_cast<int64_t>(T - 1) * S + lane;
  int4 next = T > 0 ? load_row(syms, table, idx, n, sigma, err)
                    : make_int4(0, 0, 0, 0);
  for (int t = T - 1; t >= 0; --t, idx -= S) {
    const int4 row = next;
    if (t > 0) next = load_row(syms, table, idx - S, n, sigma, err);
    uint32_t word;
    if (idx < n) {
      // an absent symbol (freq 0) codes as freq 1, as the plain version
      word = lane::encode_step(st, max(static_cast<uint32_t>(row.x), 1u),
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

// syms: (T, S) i32; table: (sigma, 4) i32 rows [freq, base, magic, 0];
// packed: (T, S) i32 out; states: (S,) i32 out; err: one i32, set to 1
// when a symbol lies outside the table.  Returns the launch's cudaError_t.
extern "C" int encode_scan(const void* syms, const void* table, int sigma,
                           int64_t n, int T, int S, int log2m, void* packed,
                           void* states, void* err, void* stream) {
  const int threads = S < 256 ? (S < 32 ? 32 : S) : 256;
  const int blocks = (S + threads - 1) / threads;
  encode_scan_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(syms), static_cast<const int4*>(table),
      sigma, n, T, S, log2m, static_cast<int32_t*>(packed),
      static_cast<int32_t*>(states), static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
