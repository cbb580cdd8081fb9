// The earlier form of K8 (three launches: tile totals from the control
// bytes, one block scanning them, a decode pass that reads the control
// bytes again and gathers each element byte by byte from global memory).
// Kept only for `python3 -m ans_tpu_torch.bench_steps`, which builds it in
// a copy of csrc/ and times it beside the kernel as it is; no codec path
// builds or calls it.
// K8: streamvbyte decode: control bytes (2 bits an element, length - 1)
// and 1-4 little-endian data bytes an element -> u32 values.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_bytesplit.py
// `_svb_dec_kernel`, reached through `svb_stage` and `_svb_dec_call`,
// and the per-step data offsets `_svb_offsets` computes outside it.
//
// What it computes: keys from the control bytes give the lengths; their
// exclusive prefix gives each element's start in the data bytes; the
// element is its bytes gathered and merged by shift-or.
//
// What bounds it on the card: bytes.  It reads n/4 control bytes and the
// data bytes and writes 4n bytes; a few integer operations an element.
//
// What the design does about it: three launches (bytescan.cuh).  A thread
// owns one control byte, that is four elements; a block a tile of 1024
// elements.  The tile offsets come from the kernels' own scan of the tile
// totals, so no offsets pass runs outside them.  The control bytes are
// read twice, nothing else twice.  Every data read is checked against
// the data length: a short stream sets the error flag and reads 0.
#include "bytescan.cuh"

namespace {

using bytescan::ITEMS;
using bytescan::THREADS;
using bytescan::TILE;

// the control byte of this thread and how many of its elements exist
__device__ __forceinline__ uint32_t my_control(
    const uint8_t* __restrict__ control, int64_t n, int64_t& i0, int& live) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  i0 = c * ITEMS;
  live = i0 >= n ? 0 : (n - i0 < ITEMS ? static_cast<int>(n - i0) : ITEMS);
  return live ? control[c] : 0u;
}

__global__ void __launch_bounds__(THREADS)
svb_totals_kernel(const uint8_t* __restrict__ control, int64_t n,
                  int32_t* __restrict__ tot) {
  __shared__ int sh[33];
  int64_t i0;
  int live;
  const uint32_t ctrl = my_control(control, n, i0, live);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (j < live) mine += 1 + ((ctrl >> (2 * j)) & 3);
  int total;
  bytescan::block_exclusive_scan1(mine, total, sh);
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
svb_decode_kernel(const uint8_t* __restrict__ control,
                  const uint8_t* __restrict__ data, int64_t data_len,
                  int64_t n, const int64_t* __restrict__ off,
                  uint32_t* __restrict__ out, int32_t* __restrict__ err) {
  __shared__ int sh[33];
  int64_t i0;
  int live;
  const uint32_t ctrl = my_control(control, n, i0, live);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (j < live) mine += 1 + ((ctrl >> (2 * j)) & 3);
  int total;
  const int excl = bytescan::block_exclusive_scan1(mine, total, sh);
  int64_t p = off[blockIdx.x] + excl;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < live) {
      const int len = 1 + ((ctrl >> (2 * j)) & 3);
      uint32_t v = 0;
      if (p + len <= data_len) {
        for (int b = 0; b < len; ++b)
          v |= static_cast<uint32_t>(data[p + b]) << (8 * b);
      } else {
        bad = true;
      }
      out[i0 + j] = v;
      p += len;
    }
  }
  if (bad) *err = 1;
}

}  // namespace

// control: (ceil(n/4),) u8; data: (data_len,) u8; tot: (ceil(n/1024),) i32
// and off: the same count of i64, scratch; out: (n,) u32; total: one i64,
// the data bytes the n elements take; err: one i32, set to 1 when an
// element's bytes pass the end of the data.  Returns the launches'
// cudaError_t.
extern "C" int svb_decode(const void* control, const void* data,
                          int64_t data_len, int64_t n, void* tot, void* off,
                          void* out, void* total, void* err,
                          void* cuda_stream) {
  if (n <= 0) return 0;
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int64_t ntiles = bytescan::tiles(n);
  const unsigned grid = static_cast<unsigned>(ntiles);
  const auto* cb = static_cast<const uint8_t*>(control);
  svb_totals_kernel<<<grid, THREADS, 0, cs>>>(cb, n,
                                              static_cast<int32_t*>(tot));
  bytescan::scan_totals_kernel<<<1, 1024, 0, cs>>>(
      static_cast<const int32_t*>(tot), ntiles, static_cast<int64_t*>(off),
      static_cast<int64_t*>(total));
  svb_decode_kernel<<<grid, THREADS, 0, cs>>>(
      cb, static_cast<const uint8_t*>(data), data_len, n,
      static_cast<const int64_t*>(off), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
