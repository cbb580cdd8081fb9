// K8: streamvbyte decode: control bytes (2 bits an element, length - 1)
// and 1-4 little-endian data bytes an element -> u32 values.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_bytesplit.py
// `_svb_dec_kernel`, reached through `svb_stage` and `_svb_dec_call`,
// and the per-step data offsets `_svb_offsets` computes outside it.
//
// What it computes: keys from the control bytes give the lengths; their
// exclusive prefix gives each element's start in the data bytes; the
// element is its 1-4 bytes, little-endian.
//
// What bounds it on the card: bytes.  It reads n/4 control bytes and the
// data bytes and writes 4n bytes; a few integer operations an element.
//
// What the design does about it: one launch, a chained scan with
// decoupled look-back (lookback.cuh), so that every byte is read from
// device memory once and no offsets pass runs outside the kernel.  A block
// takes a chunk of CHUNK consecutive elements (CHUNK / 4 control bytes) by
// an atomic ticket.  Thread t owns the chunk's control bytes g THREADS + t
// (g < BYTES), so that each of a warp's control loads is one 32-byte
// sector and each of its stores one run of 512 bytes; the loads are issued
// together, one byte each (wider loads would give a thread neighbouring
// control bytes, and its 16-byte stores a 64-byte stride).  One block scan
// of the control bytes' data lengths (4 + popc(c & 0x55) + 2 popc(c & 0xAA))
// gives each one's start in the chunk's data and the chunk's data length,
// which the block publishes at once.  Warp 0 then looks back for the
// chunk's first data byte, one status word a lane.  The data loads cannot
// start before it: what hides that wait is the other blocks on the SM, so
// a block keeps ~17 KB of shared memory and its registers are capped for
// six blocks an SM.
// The chunk's data range is loaded into shared memory as the aligned
// 16-byte granules that hold it, all issued before any is stored (the
// data's unaligned first and last granules, and a chunk whose range passes
// the data's end, take byte loads; bytes outside the data read 0).  Each
// control byte's four values come out of five shared-memory words, aligned
// by funnel shifts and masked by their keys, with no loop over bytes, and
// leave as one 16-byte store.  The last chunk writes the data length the
// n elements take, which the caller holds against the data's length.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;  // a block
constexpr int BYTES = 4;      // control bytes a thread
constexpr int MIN_BLOCKS = 6;  // blocks an SM holds (registers capped to fit)
// status words a lane of the look-back reads in one round trip: 32 chunks a
// window.  Two, as K7 and K9 read, were no faster here, and with six blocks
// an SM slower (bench_steps' rows "look-back ... words a lane")
constexpr int LOOK = 1;
constexpr int CHUNK = 4 * BYTES * THREADS;  // elements a block
static_assert(BYTES <= lane::MAX_ROUNDS, "one block scan takes six counters");
// the chunk's data, at most 4 bytes an element, as the 16-byte granules
// from the one that holds its first byte on (one more for the head, one
// for the tail)
constexpr int GRANULES = CHUNK / 4 + 2;
constexpr int LOADS = (GRANULES + THREADS - 1) / THREADS;  // granules a thread
// shared memory: the granules, then 16 bytes that the last control byte's
// five words may reach past them
constexpr int SMEM = 16 * GRANULES + 16;

// The 16 data bytes from position p on (p may be negative at the data's
// unaligned head), 0 outside [0, len), by byte loads.
__device__ __forceinline__ uint4 load_edge(const uint8_t* __restrict__ data,
                                           int64_t len, int64_t p) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int64_t s = p + b;
    const bool in = s >= 0 && s < len;
    const uint32_t y = __ldg(data + (in ? s : 0));
    if (in) w[b >> 2] |= y << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The data length of control byte c whose first `live` elements exist.
__device__ __forceinline__ int length_of(uint32_t c, int live) {
  const uint32_t k = c & ((1u << (2 * live)) - 1);
  return live + __popc(k & 0x55u) + 2 * __popc(k & 0xAAu);
}

// This thread's control bytes of the chunk and their data lengths.  A
// chunk inside n loads them together; the last chunk loads control byte 0
// in place of those past ceil(n/4) (so that no load waits on a condition),
// and keys past n count 0.
__device__ __forceinline__ void load_control(
    const uint8_t* __restrict__ control, int64_t chunk, int64_t n,
    uint32_t (&ctrl)[BYTES], int (&cnt)[lane::MAX_ROUNDS]) {
  const int64_t c0 = chunk * (CHUNK / 4) + threadIdx.x;
  if ((chunk + 1) * CHUNK <= n) {
#pragma unroll
    for (int g = 0; g < BYTES; ++g)
      ctrl[g] = __ldg(control + c0 + g * THREADS);
#pragma unroll
    for (int g = 0; g < BYTES; ++g) cnt[g] = length_of(ctrl[g], 4);
  } else {
    const int64_t used = (n + 3) / 4;
#pragma unroll
    for (int g = 0; g < BYTES; ++g) {
      const int64_t c = c0 + g * THREADS;
      ctrl[g] = __ldg(control + (c < used ? c : 0));
      const int64_t live = min(int64_t(4), max(int64_t(0), n - 4 * c));
      cnt[g] = length_of(ctrl[g], static_cast<int>(live));
    }
  }
}

// The four values of control byte c whose data starts at byte s of the
// staged words: the 16 bytes from s on, aligned by funnel shifts, then each
// element masked to its length and shifted out in turn.
__device__ __forceinline__ void values_of(const uint32_t* __restrict__ words,
                                          int s, uint32_t c,
                                          uint32_t (&v)[4]) {
  const uint32_t* w = words + (s >> 2);
  const uint32_t sh = 8 * (s & 3);
  uint32_t u0 = __funnelshift_r(w[0], w[1], sh);
  uint32_t u1 = __funnelshift_r(w[1], w[2], sh);
  uint32_t u2 = __funnelshift_r(w[2], w[3], sh);
  const uint32_t u3 = __funnelshift_r(w[3], w[4], sh);
  // key k: k + 1 bytes, mask 0xFFFFFFFF >> 8 (3 - k)
  const uint32_t k0 = c & 3, k1 = (c >> 2) & 3, k2 = (c >> 4) & 3,
                 k3 = (c >> 6) & 3;
  v[0] = u0 & (0xFFFFFFFFu >> (24 - 8 * k0));
  uint32_t b = 8 * (k0 + 1);
  u0 = __funnelshift_rc(u0, u1, b);
  u1 = __funnelshift_rc(u1, u2, b);
  u2 = __funnelshift_rc(u2, u3, b);
  v[1] = u0 & (0xFFFFFFFFu >> (24 - 8 * k1));
  b = 8 * (k1 + 1);
  u0 = __funnelshift_rc(u0, u1, b);
  u1 = __funnelshift_rc(u1, u2, b);
  v[2] = u0 & (0xFFFFFFFFu >> (24 - 8 * k2));
  u0 = __funnelshift_rc(u0, u1, 8 * (k2 + 1));
  v[3] = u0 & (0xFFFFFFFFu >> (24 - 8 * k3));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    svb_decode_kernel(const uint8_t* __restrict__ control,
                      const uint8_t* __restrict__ data, int64_t data_len,
                      int64_t n, uint32_t* __restrict__ out,
                      uint64_t* status, unsigned int* ticket,
                      int64_t* __restrict__ total) {
  extern __shared__ uint4 staged[];
  __shared__ lane::ScanScratch scratch;
  __shared__ uint64_t excl_s;
  const int64_t chunk = lookback::take_ticket(ticket);
  uint32_t ctrl[BYTES];
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
  load_control(control, chunk, n, ctrl, cnt);
  // the control bytes in stream order: all threads' byte 0, then byte 1
  int excl[lane::MAX_ROUNDS], tot[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(BYTES, cnt, excl, tot, scratch);
  int start[BYTES];  // each control byte's first data byte in the chunk
  uint32_t agg = 0;
#pragma unroll
  for (int g = 0; g < BYTES; ++g) {
    start[g] = agg + excl[g];
    agg += tot[g];
  }
  if (threadIdx.x == 0)
    lookback::publish(status + chunk, agg,
                      chunk == 0 ? lookback::PREFIX : lookback::AGGREGATE);
  const uint64_t ex = lookback::exclusive_prefix<LOOK>(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t off = static_cast<int64_t>(excl_s);  // the chunk's first byte
  if (threadIdx.x == 0 && chunk == gridDim.x - 1) *total = off + agg;

  // the data [off, off + agg) as the granules of the address space that
  // hold it, the first `head` bytes of the first one before off: granule i
  // of the chunk is thread i % THREADS's load i / THREADS
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  const uintptr_t a0 = (base + off) & ~uintptr_t(15);
  const int head = static_cast<int>(base + off - a0);
  const int count = (head + static_cast<int>(agg) + 15) >> 4;
  uint4 q[LOADS];
  if (a0 >= base && a0 + 16 * count <= base + data_len) {
    const uint4* g0 = reinterpret_cast<const uint4*>(a0);
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k * THREADS < count)  // the same for the whole block
        q[k] = __ldg(g0 + min(k * THREADS + static_cast<int>(threadIdx.x),
                              count - 1));
  } else {
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k * THREADS < count)
        q[k] = load_edge(data, data_len,
                         off - head + 16 * (k * THREADS + threadIdx.x));
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k)
    if (k * THREADS + static_cast<int>(threadIdx.x) < count)
      staged[k * THREADS + threadIdx.x] = q[k];
  __syncthreads();

  // each control byte's four values, one 16-byte store (elements past n
  // are not stored)
  const uint32_t* words = reinterpret_cast<const uint32_t*>(staged);
  const int64_t e0 = chunk * CHUNK + 4 * threadIdx.x;
#pragma unroll
  for (int g = 0; g < BYTES; ++g) {
    uint32_t v[4];
    values_of(words, head + start[g], ctrl[g], v);
    const int64_t e = e0 + 4 * g * THREADS;
    if (e + 4 <= n) {
      *reinterpret_cast<uint4*>(out + e) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < n) out[e + j] = v[j];
    }
  }
}

}  // namespace

// control: (>= ceil(n/4),) u8 and data: (data_len,) u8, data_len > 0, both
// at any address; out: (n,) u32, 16-byte aligned; scratch: chunks + 3 i64,
// zero: a status word for each chunk, the ticket, then the data bytes the
// n elements take (written by the kernel; the last word is not used);
// chunks: ceil(n / CHUNK), as the caller sized the scratch.  Returns the
// launch's cudaError_t.
extern "C" int svb_decode(const void* control, const void* data,
                          int64_t data_len, int64_t n, void* out,
                          void* scratch, int64_t chunks, void* cuda_stream) {
  if (n <= 0 || data_len <= 0 || chunks != (n + CHUNK - 1) / CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        svb_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  uint64_t* status = static_cast<uint64_t*>(scratch);
  svb_decode_kernel<<<static_cast<unsigned>(chunks), THREADS, SMEM, cs>>>(
      static_cast<const uint8_t*>(control), static_cast<const uint8_t*>(data),
      data_len, n, static_cast<uint32_t*>(out), status,
      reinterpret_cast<unsigned int*>(status + chunks),
      reinterpret_cast<int64_t*>(status + chunks + 1));
  return static_cast<int>(cudaGetLastError());
}
