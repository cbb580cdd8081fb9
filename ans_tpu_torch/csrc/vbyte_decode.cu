// K9: vbyte decode: a stream of 7-bit groups, LSB first, bit 7 set on
// every byte but an element's last -> u32 values.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_bytesplit.py
// `_vb_dec_kernel`, reached through `vbyte_stage` and `_vb_dec_call`,
// and the two stream checks of `_scan_vbyte`.
//
// What it computes: a byte with bit 7 clear terminates an element; the
// exclusive prefix of the terminator flags over the whole stream is the
// element's index; the element's value is the shift-or of its bytes'
// low 7 bits.
//
// What bounds it on the card: bytes.  It reads the stream and writes 4n
// bytes; a few integer operations a byte.
//
// What the design does about it: one launch, a chained scan with
// decoupled look-back (lookback.cuh), so that no cursor is carried from
// chunk to chunk and the stream is read from device memory once.  Chunks
// are cut at 16-byte boundaries of the address space: a block takes a chunk
// of CHUNK bytes by an atomic ticket and each thread reads GRANULES 16-byte
// granules of it, granule g of thread t the chunk's g THREADS + t, each with
// one 16-byte load, all issued before any is used (the stream's first and
// last chunks take byte loads; bytes outside the stream read 0).
// The chunk goes into shared memory behind a halo of the 8 bytes before it:
// an element's terminator may lie in this chunk and its up to four
// continuation bytes in the one before, and the check for an element
// longer than 5 bytes needs the 5 bytes before a terminator.  The block
// counts its terminators, publishes the count at once, then each thread
// rebuilds the values its terminators end from a 24-byte window (a
// granule and the 8 bytes before it, out of shared memory) and stages them
// in shared memory, and only then does the block look back for its first
// element's index.  The chunk's values are one contiguous run of the output,
// clipped to n, written with 16-byte stores on its aligned interior and
// 4-byte stores at its two ends.  Registers are capped so that five blocks
// share an SM.  Errors go to a flag word: bit 0 when the stream holds fewer
// than n elements (the last chunk knows the total), bit 1 when one of the
// first n elements is longer than 5 bytes.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;  // a block
constexpr int GRANULES = 2;   // 16-byte granules a thread
constexpr int MIN_BLOCKS = 5;  // blocks an SM holds (registers capped to fit)
constexpr int CHUNK = 16 * GRANULES * THREADS;  // stream bytes a block
static_assert(GRANULES <= lane::MAX_ROUNDS,
              "one block scan takes six counters");
// shared memory: 8 spare bytes and the 8-byte halo, the chunk's bytes, then
// its values (a terminator each byte at most)
constexpr int SMEM = 16 + CHUNK + 4 * CHUNK;

// The 16 stream bytes from position p on (p may be negative at the
// stream's unaligned head), 0 outside the stream, by byte loads; `valid`
// gets a bit for each byte inside it.
__device__ __forceinline__ uint4 load_edge(const uint8_t* __restrict__ data,
                                           int64_t len, int64_t p,
                                           uint32_t& valid) {
  uint32_t w[4] = {0, 0, 0, 0};
  valid = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int64_t s = p + b;
    const bool in = s >= 0 && s < len;
    const uint32_t y = __ldg(data + (in ? s : 0));
    if (in) {
      w[b >> 2] |= y << (8 * (b & 3));
      valid |= 1u << b;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 8 stream bytes before position p, 0 where they lie before the
// stream: one 8-byte load where data + p is 8-byte aligned and p >= 8.
__device__ __forceinline__ uint2 bytes_before(const uint8_t* __restrict__ data,
                                              int64_t p) {
  if (p >= 8 && (reinterpret_cast<uintptr_t>(data + p) & 7) == 0)
    return __ldg(reinterpret_cast<const uint2*>(data + p - 8));
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int64_t s = p - 8 + b;
    if (s >= 0) w[b >> 2] |= static_cast<uint32_t>(data[s]) << (8 * (b & 3));
  }
  return make_uint2(w[0], w[1]);
}

// One bit for each byte of w with bit 7 clear (a terminator), byte 0 in
// bit 0.
__device__ __forceinline__ uint32_t terminators(uint32_t w) {
  const uint32_t t = (~w & 0x80808080u) >> 7;  // bits 0, 8, 16, 24
  return (t * 0x204081u) >> 21 & 0xFu;         // to bits 21-24, no carries
}

// The value of the element whose terminator is byte s + 7 of the window w
// and which has k < 5 continuation bytes before it (s is known at compile
// time once the caller's loop is unrolled; w[6] is 0).
__device__ __forceinline__ uint32_t value_of(const uint32_t (&w)[7], int s,
                                             int k) {
  const int q = s >> 2, sh = 8 * (s & 3);
  const uint32_t lo = __funnelshift_r(w[q], w[q + 1], sh);
  const uint32_t hi = __funnelshift_r(w[q + 1], w[q + 2], sh);
  // the element's bytes, its first in the low byte
  const uint64_t y = ((static_cast<uint64_t>(hi) << 32) | lo) >> (8 * (7 - k));
  const uint32_t l = static_cast<uint32_t>(y);
  const uint32_t h = static_cast<uint32_t>(y >> 32);
  return (l & 0x7Fu) | ((l >> 1) & 0x3F80u) | ((l >> 2) & 0x1FC000u) |
         ((l >> 3) & 0xFE00000u) | (h << 28);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    vbyte_decode_kernel(const uint8_t* __restrict__ data, int64_t len,
                        int64_t n, int mis, uint32_t* __restrict__ out,
                        uint64_t* status, unsigned int* ticket,
                        int64_t* __restrict__ total, int* __restrict__ err) {
  extern __shared__ uint4 smem[];
  __shared__ lane::ScanScratch scratch;
  __shared__ uint64_t excl_s;
  const int64_t chunk = lookback::take_ticket(ticket);
  // granule g of thread t is the chunk's granule g THREADS + t, so that each
  // of a warp's loads is one coalesced run; `first` is the stream position
  // of the chunk's first byte
  const int64_t first = chunk * CHUNK - mis;
  uint8_t* sbytes = reinterpret_cast<uint8_t*>(smem);
  // a chunk inside the stream takes one 16-byte load a granule, all issued
  // before any is used (a branch between them would make each wait for the
  // one before); the stream's first and last chunks take byte loads
  uint4 q[GRANULES];
  uint32_t valid[GRANULES];
  if (first >= 0 && first + CHUNK <= len) {
#pragma unroll
    for (int g = 0; g < GRANULES; ++g) {
      q[g] = __ldg(reinterpret_cast<const uint4*>(
          data + first + 16 * (g * THREADS + threadIdx.x)));
      valid[g] = 0xFFFFu;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GRANULES; ++g)
      q[g] = load_edge(data, len, first + 16 * (g * THREADS + threadIdx.x),
                       valid[g]);
  }
  uint32_t mine[GRANULES];  // a bit for each terminator in the stream
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    smem[1 + g * THREADS + threadIdx.x] = q[g];
    mine[g] = (terminators(q[g].x) | terminators(q[g].y) << 4 |
               terminators(q[g].z) << 8 | terminators(q[g].w) << 12) &
              valid[g];
    cnt[g] = __popc(mine[g]);
  }
  if (threadIdx.x == 0)
    *reinterpret_cast<uint2*>(sbytes + 8) =
        chunk == 0 ? make_uint2(0, 0) : bytes_before(data, first);
  // the granules in stream order: all threads' granule 0, then granule 1
  int excl[lane::MAX_ROUNDS], tot[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(GRANULES, cnt, excl, tot, scratch);
  uint32_t agg = 0;
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) agg += tot[g];
  if (threadIdx.x == 0)
    lookback::publish(status + chunk, agg,
                      chunk == 0 ? lookback::PREFIX : lookback::AGGREGATE);

  // the scan's barriers made the granules and the halo visible: each
  // granule's values from a window of its 16 bytes and the 8 before it
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + 1 + CHUNK / 16);
  int bad = CHUNK;  // the chunk's index of my first element past 5 bytes
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GRANULES; ++g) {
    const int idx = g * THREADS + threadIdx.x;
    int r = at + excl[g];  // the chunk's index of the granule's first value
    at += tot[g];
    const uint2 before = *reinterpret_cast<const uint2*>(sbytes + 16 * idx + 8);
    const uint4 q = smem[1 + idx];
    const uint32_t w[7] = {before.x, before.y, q.x, q.y, q.z, q.w, 0};
    // bytes outside the stream are 0, so a walk back stops at its start
    const uint32_t win = terminators(w[0]) | terminators(w[1]) << 4 |
                         terminators(w[2]) << 8 | terminators(w[3]) << 12 |
                         terminators(w[4]) << 16 | terminators(w[5]) << 20;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (mine[g] >> j & 1) {
        // continuation bytes before the terminator at window byte 8 + j
        const uint32_t below = win & ((1u << (8 + j)) - 1);
        const int k = 7 + j - (31 - __clz(below));
        if (k >= 5) bad = min(bad, r);
        vals[r++] = k >= 5 ? 0u : value_of(w, j + 1, min(k, 4));
      }
    }
  }
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t e0 = static_cast<int64_t>(excl_s);  // the chunk's first element
  if (bad < CHUNK && e0 + bad < n) atomicOr(err, 2);
  if (threadIdx.x == 0 && chunk == gridDim.x - 1) {
    *total = e0 + agg;
    if (e0 + agg < n) atomicOr(err, 1);
  }

  // the run out[e0, e1): 4-byte stores up to the first 16-byte boundary and
  // after the last one, 16-byte stores between
  const int64_t e1 = min(e0 + static_cast<int64_t>(agg), n);
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const int64_t up = static_cast<int64_t>(
      (((base + 4 * e0 + 15) & ~uintptr_t(15)) - base) >> 2);
  const int64_t down =
      static_cast<int64_t>((((base + 4 * e1) & ~uintptr_t(15)) - base) >> 2);
  const int64_t a0 = min(up, max(e1, e0)), a1 = max(a0, down);
  for (int64_t e = e0 + threadIdx.x; e < a0; e += THREADS)
    out[e] = vals[e - e0];
  for (int64_t e = a1 + threadIdx.x; e < e1; e += THREADS)
    out[e] = vals[e - e0];
  for (int64_t e = a0 + 4 * static_cast<int64_t>(threadIdx.x); e < a1;
       e += 4 * THREADS) {
    const uint32_t* src = vals + (e - e0);
    *reinterpret_cast<uint4*>(out + e) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

}  // namespace

// data: (len,) u8, len > 0, at any address; out: (n,) u32, 4-byte aligned;
// scratch: chunks + 3 i64, zero: a status word for each chunk, the ticket,
// the terminators in the stream (written by the kernel), and the flag word
// in the low half of the last (bit 0: fewer than n elements, bit 1: an
// element longer than 5 bytes); chunks: ceil((data % 16 + len) / CHUNK), as
// the caller sized the scratch.  Returns the launch's cudaError_t.
extern "C" int vbyte_decode(const void* data, int64_t len, int64_t n,
                            void* out, void* scratch, int64_t chunks,
                            void* cuda_stream) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  if (len <= 0 || chunks != (mis + len + CHUNK - 1) / CHUNK ||
      (reinterpret_cast<uintptr_t>(out) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vbyte_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto* sc = static_cast<int64_t*>(scratch);
  uint64_t* status = reinterpret_cast<uint64_t*>(sc);
  vbyte_decode_kernel<<<static_cast<unsigned>(chunks), THREADS, SMEM,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(data), len, n, mis,
      static_cast<uint32_t*>(out), status,
      reinterpret_cast<unsigned int*>(status + chunks), sc + chunks + 1,
      reinterpret_cast<int*>(sc + chunks + 2));
  return static_cast<int>(cudaGetLastError());
}
