// The earlier form of K9 (three launches: tile totals, one block scanning
// them, a decode pass that reads the stream again and walks back over
// continuation bytes in global memory).  Kept only for `python3 -m
// ans_tpu_torch.bench_steps`, which builds it in a copy of csrc/ and times
// it beside the kernel as it is; no codec path builds or calls it.
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
// What the design does about it: three launches (bytescan.cuh) make the
// prefix one global scan, so no cursor is carried from tile to tile and
// no window is sized from the data.  A thread owns four consecutive
// bytes; the thread that owns a terminator walks back over the element's
// continuation bytes (at most four, mostly in L1) and rebuilds the value
// itself, so no byte is routed between threads.  The stream is read
// twice.  Errors go to a flag word: bit 0 when the stream holds fewer
// than n elements, bit 1 when one of the first n elements is longer than
// 5 bytes.
#include "bytescan.cuh"

namespace {

using bytescan::ITEMS;
using bytescan::THREADS;
using bytescan::TILE;

__global__ void __launch_bounds__(THREADS)
vbyte_totals_kernel(const uint8_t* __restrict__ data, int64_t len,
                    int32_t* __restrict__ tot) {
  __shared__ int sh[33];
  const int64_t i0 =
      static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (i0 + j < len) mine += !(data[i0 + j] & 0x80);
  int total;
  bytescan::block_exclusive_scan1(mine, total, sh);
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
vbyte_decode_kernel(const uint8_t* __restrict__ data, int64_t len, int64_t n,
                    const int64_t* __restrict__ off,
                    const int64_t* __restrict__ total,
                    uint32_t* __restrict__ out, int32_t* __restrict__ err) {
  __shared__ int sh[33];
  const int64_t i0 =
      static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  uint32_t byte[ITEMS];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    byte[j] = i0 + j < len ? data[i0 + j] : 0x80u;
    mine += !(byte[j] & 0x80);
  }
  int tile_total;
  const int excl = bytescan::block_exclusive_scan1(mine, tile_total, sh);
  int64_t e = off[blockIdx.x] + excl;  // index of my first terminator
  int flags = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && *total < n) flags |= 1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (byte[j] & 0x80) continue;
    if (e < n) {
      // walk back over the continuation bytes of this element
      const int64_t p = i0 + j;
      int k = 0;
      while (k < 5 && p - k > 0 && (data[p - k - 1] & 0x80)) ++k;
      uint32_t v = 0;
      if (k == 5) {
        flags |= 2;
      } else {
        for (int b = 0; b <= k; ++b)
          v |= (static_cast<uint32_t>(data[p - k + b]) & 0x7Fu) << (7 * b);
      }
      out[e] = v;
    }
    ++e;
  }
  if (flags) atomicOr(err, flags);
}

}  // namespace

// data: (len,) u8, len > 0; tot: (ceil(len/1024),) i32 and off: the same
// count of i64, scratch; out: (n,) u32; total: one i64, the terminators in
// the stream; err: one i32 of flag bits (1: fewer than n elements, 2: an
// element longer than 5 bytes).  Returns the launches' cudaError_t.
extern "C" int vbyte_decode(const void* data, int64_t len, int64_t n,
                            void* tot, void* off, void* out, void* total,
                            void* err, void* cuda_stream) {
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int64_t ntiles = bytescan::tiles(len);
  const unsigned grid = static_cast<unsigned>(ntiles);
  const auto* d = static_cast<const uint8_t*>(data);
  vbyte_totals_kernel<<<grid, THREADS, 0, cs>>>(d, len,
                                                static_cast<int32_t*>(tot));
  bytescan::scan_totals_kernel<<<1, 1024, 0, cs>>>(
      static_cast<const int32_t*>(tot), ntiles, static_cast<int64_t*>(off),
      static_cast<int64_t*>(total));
  vbyte_decode_kernel<<<grid, THREADS, 0, cs>>>(
      d, len, n, static_cast<const int64_t*>(off),
      static_cast<const int64_t*>(total), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
