// K7: byte-split encode of u32 values, vbyte (7-bit groups, up to 5 bytes
// an element) or streamvbyte (1-4 little-endian data bytes an element plus
// one 2-bit key per element in the control bytes).
//
// Replaces the TPU kernel ans_tpu/ops/pallas_bytesplit.py `_enc_kernel`,
// reached through `split_encode` and `_enc_call`, and the control bytes
// of `svb_control`.
//
// What it computes: each element's byte length by unsigned compares, the
// exclusive prefix of the lengths (the element's start in the stream),
// and the element's bytes written at start + j.  vbyte sets bit 7 on
// every byte but an element's last; streamvbyte's key is length - 1,
// element 0 of a group of four in the low bits, unused keys of the last
// control byte 0.
//
// What bounds it on the card: bytes.  It reads 4n bytes and writes the
// stream once; the arithmetic is a dozen integer operations an element.
//
// What the design does about it: one launch, a chained scan with
// decoupled look-back (lookback.cuh), so that the input is read from
// device memory once.  A block takes a chunk of CHUNK consecutive elements
// by an atomic ticket and reads it with 16-byte loads, all issued before
// any is used: a thread owns four groups of four elements, group g of
// thread t at g * 4 THREADS + 4 t, so that each of a warp's loads is one
// coalesced run.  The values stay in registers; one block scan over the
// four groups gives each group's start in the chunk and the chunk's byte
// count, which the block publishes at once.  It then stages the chunk's
// stream bytes (and its control bytes) in shared memory, and only then
// looks back for its offset, so that its predecessors have mostly
// published by the time it reads their status words.  The chunk's bytes
// are one contiguous run of the stream, written with 16-byte stores on its
// aligned interior and byte stores at its two ends; the control bytes,
// CHUNK / 4 a chunk, with 16-byte stores.  The last chunk writes the
// stream's length.  Registers are capped so that five blocks share an SM.
// The TPU's K-phase expansion, its routing network and its section buffers
// are not carried over.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;  // a block
constexpr int GROUPS = 4;     // groups of four elements a thread
constexpr int MIN_BLOCKS = 5;  // blocks an SM holds (registers capped to fit)
constexpr int CHUNK = 4 * GROUPS * THREADS;  // elements a block
static_assert(GROUPS <= lane::MAX_ROUNDS, "one block scan takes six counters");
constexpr int MAX_BYTES = 5;  // stream bytes an element, at most (vbyte)
// shared memory: the chunk's stream bytes, 16 spare, its control bytes
constexpr int SMEM = MAX_BYTES * CHUNK + 16 + CHUNK / 4;

template <bool VBYTE>
__device__ __forceinline__ int elem_len(uint32_t x) {
  if (VBYTE)
    return 1 + (x >= (1u << 7)) + (x >= (1u << 14)) + (x >= (1u << 21)) +
           (x >= (1u << 28));
  return 1 + (x > 0xFFu) + (x > 0xFFFFu) + (x > 0xFFFFFFu);
}

// The values of a thread's groups (group g at element i0 + g 4 THREADS)
// and each group's byte count (0 past n).  A chunk that lies whole inside n
// of a 16-byte aligned input takes one 16-byte load a group, all issued
// before any is used (a branch between them would make each wait for the
// one before); the last chunk loads element by element (an element past n
// loads element 0 and is replaced, so that no load waits on a condition).
template <bool VBYTE>
__device__ __forceinline__ void load_groups(const uint32_t* __restrict__ x,
                                            int64_t i0, int64_t n, bool vec,
                                            uint32_t (&v)[GROUPS][4],
                                            int (&cnt)[lane::MAX_ROUNDS]) {
  if (vec && i0 - 4 * threadIdx.x + CHUNK <= n) {
    uint4 q[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      q[g] = __ldg(reinterpret_cast<const uint4*>(x + i0 + g * 4 * THREADS));
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      v[g][0] = q[g].x, v[g][1] = q[g].y, v[g][2] = q[g].z, v[g][3] = q[g].w;
  } else {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = i0 + g * 4 * THREADS + j;
        const uint32_t y = __ldg(x + (i < n ? i : 0));
        v[g][j] = i < n ? y : 0u;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    cnt[g] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = i0 + g * 4 * THREADS + j;
      cnt[g] += i < n ? elem_len<VBYTE>(v[g][j]) : 0;
    }
  }
}

// The bytes of the group at element i into the chunk's staging buffer from
// byte p on; returns its control byte.  The lengths are computed again (a
// few compares), so that only the values stay live across the block scan.
template <bool VBYTE>
__device__ __forceinline__ uint32_t stage_group(uint8_t* bytes, uint32_t p,
                                                const uint32_t (&v)[4],
                                                int64_t i, int64_t n) {
  uint32_t key = 0;
  int len[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) len[j] = i + j < n ? elem_len<VBYTE>(v[j]) : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < (VBYTE ? MAX_BYTES : 4); ++b) {
      if (b < len[j])
        bytes[p + b] = static_cast<uint8_t>(
            VBYTE ? ((v[j] >> (7 * b)) & 0x7Fu) | (b + 1 < len[j] ? 0x80u : 0u)
                  : v[j] >> (8 * b));
    }
    p += len[j];
    if (len[j]) key |= static_cast<uint32_t>(len[j] - 1) << (2 * j);
  }
  return key;
}

template <bool VBYTE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    encode_kernel(const uint32_t* __restrict__ x, int64_t n, bool vec,
                  uint8_t* __restrict__ out, uint8_t* __restrict__ control,
                  uint64_t* status, unsigned int* ticket,
                  int64_t* __restrict__ total) {
  extern __shared__ uint32_t staged[];
  __shared__ lane::ScanScratch scratch;
  __shared__ uint64_t excl_s;
  const int64_t chunk = lookback::take_ticket(ticket);
  const int64_t i0 = chunk * CHUNK + 4 * threadIdx.x;

  uint32_t v[GROUPS][4];
  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
  load_groups<VBYTE>(x, i0, n, vec, v, cnt);
  // the groups of the chunk in element order: all threads' group 0, then
  // group 1, ...
  int excl[lane::MAX_ROUNDS], tot[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(GROUPS, cnt, excl, tot, scratch);
  uint32_t agg = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) agg += tot[g];
  if (threadIdx.x == 0)
    lookback::publish(status + chunk, agg,
                      chunk == 0 ? lookback::PREFIX : lookback::AGGREGATE);

  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  uint8_t* keys = bytes + MAX_BYTES * CHUNK + 16;
  uint32_t at = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const uint32_t key =
        stage_group<VBYTE>(bytes, at + excl[g], v[g], i0 + g * 4 * THREADS, n);
    if (!VBYTE) keys[g * THREADS + threadIdx.x] = static_cast<uint8_t>(key);
    at += tot[g];
  }
  const uint64_t ex = lookback::exclusive_prefix(status, chunk, agg);
  if (threadIdx.x == 0) excl_s = ex;
  __syncthreads();
  const int64_t p0 = static_cast<int64_t>(excl_s);
  if (threadIdx.x == 0 && chunk == gridDim.x - 1) *total = p0 + agg;

  // the run [p0, p1): byte stores up to the first 16-byte boundary and
  // after the last one, 16-byte stores between
  const int64_t p1 = p0 + agg;
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const int64_t up = ((base + p0 + 15) & ~uintptr_t(15)) - base;
  const int64_t down = ((base + p1) & ~uintptr_t(15)) - base;
  const int64_t a0 = min(up, p1), a1 = max(a0, down);
  for (int64_t p = p0 + threadIdx.x; p < a0; p += THREADS)
    out[p] = bytes[p - p0];
  for (int64_t p = a1 + threadIdx.x; p < p1; p += THREADS)
    out[p] = bytes[p - p0];
  const int shift = 8 * ((a0 - p0) & 3);
  for (int64_t p = a0 + 16 * static_cast<int64_t>(threadIdx.x); p < a1;
       p += 16 * THREADS) {
    const uint32_t* src = staged + ((p - p0) >> 2);
    uint32_t w[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) w[k] = src[k];
    uint4 o;
    o.x = __funnelshift_r(w[0], w[1], shift);
    o.y = __funnelshift_r(w[1], w[2], shift);
    o.z = __funnelshift_r(w[2], w[3], shift);
    o.w = __funnelshift_r(w[3], w[4], shift);
    *reinterpret_cast<uint4*>(out + p) = o;
  }

  // the chunk's control bytes (control is 16-byte aligned, and so is each
  // chunk's first control byte)
  if (!VBYTE) {
    const int64_t c0 = chunk * (CHUNK / 4);
    const int m = static_cast<int>(min(int64_t(CHUNK / 4), (n + 3) / 4 - c0));
    for (int c = 16 * threadIdx.x; c < m; c += 16 * THREADS) {
      if (c + 16 <= m) {
        *reinterpret_cast<uint4*>(control + c0 + c) =
            *reinterpret_cast<const uint4*>(keys + c);
      } else {
        for (int k = c; k < m; ++k) control[c0 + k] = keys[k];
      }
    }
  }
}

template <bool VBYTE>
cudaError_t run(const uint32_t* x, int64_t n, uint8_t* out, uint8_t* control,
                int64_t* scratch, int64_t chunks, cudaStream_t cs) {
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_kernel<VBYTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch);
  encode_kernel<VBYTE><<<static_cast<unsigned>(chunks), THREADS, SMEM, cs>>>(
      x, n, vec, out, control, status,
      reinterpret_cast<unsigned int*>(status + chunks), scratch + chunks + 1);
  return cudaGetLastError();
}

}  // namespace

// x: (n,) u32, 0 < n <= 2^28; out: (5n,) u8 for vbyte, (4n,) for
// streamvbyte, of which the first `total` bytes are the stream; control:
// (ceil(n/4),) u8, 16-byte aligned (streamvbyte only, else unused);
// scratch: chunks + 3 i64, zero: a status word for each chunk, the ticket,
// then `total`, written by the kernel (the last word is not used);
// chunks: ceil(n / CHUNK), as the caller sized the scratch.  Returns the
// launch's cudaError_t.
extern "C" int bytesplit_encode(const void* x, int64_t n, int vbyte,
                                void* out, void* control, void* scratch,
                                int64_t chunks, void* cuda_stream) {
  if (n <= 0 || n > (int64_t(1) << 28) || chunks != (n + CHUNK - 1) / CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!vbyte && (reinterpret_cast<uintptr_t>(control) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* ob = static_cast<uint8_t*>(out);
  auto* cb = static_cast<uint8_t*>(control);
  auto* sc = static_cast<int64_t*>(scratch);
  return static_cast<int>(vbyte ? run<true>(xs, n, ob, cb, sc, chunks, cs)
                                : run<false>(xs, n, ob, cb, sc, chunks, cs));
}
