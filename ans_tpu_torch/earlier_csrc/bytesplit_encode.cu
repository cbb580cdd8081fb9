// The earlier form of K7 (three launches: tile totals, one block scanning
// them, a write pass that reads the values again and stores its bytes one
// at a time).  Kept only for `python3 -m ans_tpu_torch.bench_steps`, which
// builds it in a copy of csrc/ and times it beside the kernel as it is; no
// codec path builds or calls it.
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
// What the design does about it: three launches (bytescan.cuh).  A tile
// of 1024 elements per block; a thread owns four consecutive elements,
// which is exactly one control byte.  The lengths are recomputed in the
// write pass instead of being stored, so the input is read twice (the
// second time mostly from L2) and nothing else goes through device
// memory but the tile totals.  Bytes are scattered straight to their
// place: the TPU's K-phase expansion, its routing network and its
// section buffers are not carried over.
#include "bytescan.cuh"

namespace {

using bytescan::ITEMS;
using bytescan::THREADS;
using bytescan::TILE;

template <bool VBYTE>
__device__ __forceinline__ int elem_len(uint32_t x) {
  if (VBYTE)
    return 1 + (x >= (1u << 7)) + (x >= (1u << 14)) + (x >= (1u << 21)) +
           (x >= (1u << 28));
  return 1 + (x > 0xFFu) + (x > 0xFFFFu) + (x > 0xFFFFFFu);
}

template <bool VBYTE>
__global__ void __launch_bounds__(THREADS)
encode_totals_kernel(const uint32_t* __restrict__ x, int64_t n,
                     int32_t* __restrict__ tot) {
  __shared__ int sh[33];
  const int64_t i0 =
      static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (i0 + j < n) mine += elem_len<VBYTE>(x[i0 + j]);
  int total;
  bytescan::block_exclusive_scan1(mine, total, sh);
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

template <bool VBYTE>
__global__ void __launch_bounds__(THREADS)
encode_write_kernel(const uint32_t* __restrict__ x, int64_t n,
                    const int64_t* __restrict__ off,
                    uint8_t* __restrict__ out,
                    uint8_t* __restrict__ control) {
  __shared__ int sh[33];
  const int64_t i0 =
      static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  uint32_t v[ITEMS];
  int len[ITEMS];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool in = i0 + j < n;
    v[j] = in ? x[i0 + j] : 0u;
    len[j] = in ? elem_len<VBYTE>(v[j]) : 0;
    mine += len[j];
  }
  int total;
  const int excl = bytescan::block_exclusive_scan1(mine, total, sh);
  int64_t p = off[blockIdx.x] + excl;
  uint32_t key = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    for (int b = 0; b < len[j]; ++b) {
      if (VBYTE)
        out[p++] = static_cast<uint8_t>(((v[j] >> (7 * b)) & 0x7Fu) |
                                        (b + 1 < len[j] ? 0x80u : 0u));
      else
        out[p++] = static_cast<uint8_t>(v[j] >> (8 * b));
    }
    if (len[j]) key |= static_cast<uint32_t>(len[j] - 1) << (2 * j);
  }
  if (!VBYTE && i0 < n) control[i0 / ITEMS] = static_cast<uint8_t>(key);
}

template <bool VBYTE>
cudaError_t run(const uint32_t* x, int64_t n, int32_t* tot, int64_t* off,
                uint8_t* out, uint8_t* control, int64_t* total,
                cudaStream_t cs) {
  const int64_t ntiles = bytescan::tiles(n);
  const unsigned grid = static_cast<unsigned>(ntiles);
  encode_totals_kernel<VBYTE><<<grid, THREADS, 0, cs>>>(x, n, tot);
  bytescan::scan_totals_kernel<<<1, 1024, 0, cs>>>(tot, ntiles, off, total);
  encode_write_kernel<VBYTE><<<grid, THREADS, 0, cs>>>(x, n, off, out,
                                                        control);
  return cudaGetLastError();
}

}  // namespace

// x: (n,) u32, 0 < n <= 2^28; tot: (ceil(n/1024),) i32 and off: the same
// count of i64, scratch; out: (5n,) u8 for vbyte, (4n,) for streamvbyte, of
// which the first *total bytes are the stream; control: (ceil(n/4),) u8
// (streamvbyte only, else unused); total: one i64.  Returns the launches'
// cudaError_t.
extern "C" int bytesplit_encode(const void* x, int64_t n, int vbyte,
                                void* tot, void* off, void* out,
                                void* control, void* total,
                                void* cuda_stream) {
  if (n <= 0 || n > (int64_t(1) << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* t = static_cast<int32_t*>(tot);
  auto* o = static_cast<int64_t*>(off);
  auto* ob = static_cast<uint8_t*>(out);
  auto* cb = static_cast<uint8_t*>(control);
  auto* tt = static_cast<int64_t*>(total);
  return static_cast<int>(vbyte ? run<true>(xs, n, t, o, ob, cb, tt, cs)
                                : run<false>(xs, n, t, o, ob, cb, tt, cs));
}
