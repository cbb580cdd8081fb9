// The earlier form of K2, before it computed its own step offsets (fed
// round_base by the plain round totals, ops/lane_codec.py encode_totals;
// one-byte stores).  Kept only for `python3 -m ans_tpu_torch.bench_steps`,
// which builds it in a copy of csrc/ and times it beside the kernel as it
// is; no codec path builds or calls it.
//
// K2: placement of the encode scan's bytes into the fmt-2 stream.
//
// Replaces the TPU kernel ans_tpu/ops/pallas_place.py `_kernel`, reached
// through `place` and `_call`.
//
// What it computes: for step t, the six byte rounds (renorm round j for
// lanes with rc > j, exception round j for lanes with nb > j).  A lane's
// byte in round r goes to stream[round_base[t, r] + rank], where rank is
// the exclusive prefix of the round's mask over the lanes.  Both kinds of
// round are read high-first by the decoder: renorm round j carries
// emission slot rc-1-j of the packed word, exception round j carries byte
// nb-1-j of the value's low bytes.
//
// What bounds it on the card: the per-step block scan and the scattered
// one-byte stores.  Steps are independent once round_base is known (an
// exclusive cumsum over all (step, round) counts, ops/lane_codec.py
// encode_totals), so the grid spans T blocks and fills the card; each
// block reads 12 bytes per lane and writes ~1 byte per lane.
//
// What the design does about it: one block per step, each thread owning
// a contiguous run of lanes so that ranks stay in lane order; a warp
// shuffle scan plus one pass over the warp totals in shared memory gives
// every thread its offset in each round.  The TPU kernel's routing
// network, its section cutting and its VMEM batch sizing are not carried
// over: Hopper stores a byte at any address, and the stream is written
// flat (sections are contiguous step-aligned slices of it).
#include "common.cuh"

namespace {

__global__ void place_kernel(const int32_t* __restrict__ packed,
                             const int32_t* __restrict__ nb,
                             const int32_t* __restrict__ excw, int64_t n,
                             int S, const int64_t* __restrict__ round_base,
                             uint8_t* __restrict__ stream, int64_t total,
                             int32_t* __restrict__ err) {
  __shared__ lane::ScanScratch scratch;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * S;
  const int lpt = (S + blockDim.x - 1) / blockDim.x;
  const int l0 = min(static_cast<int>(threadIdx.x) * lpt, S);
  const int l1 = min(l0 + lpt, S);

  int cnt[lane::MAX_ROUNDS] = {0, 0, 0, 0, 0, 0};
  for (int l = l0; l < l1; ++l) {
    const int64_t idx = row + l;
    if (idx >= n) break;
    const int rc = (packed[idx] >> 24) & 3;
    const int e = nb[idx];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cnt[j] += rc > j;
      cnt[3 + j] += e > j;
    }
  }
  int excl[lane::MAX_ROUNDS], total_r[lane::MAX_ROUNDS];
  lane::block_exclusive_scan(lane::MAX_ROUNDS, cnt, excl, total_r, scratch);

  int64_t pos[lane::MAX_ROUNDS];
#pragma unroll
  for (int r = 0; r < lane::MAX_ROUNDS; ++r)
    pos[r] = round_base[blockIdx.x * static_cast<int64_t>(lane::MAX_ROUNDS)
                        + r] + excl[r];
  for (int l = l0; l < l1; ++l) {
    const int64_t idx = row + l;
    if (idx >= n) break;
    const uint32_t w = static_cast<uint32_t>(packed[idx]);
    const uint32_t x = static_cast<uint32_t>(excw[idx]);
    const int rc = (w >> 24) & 3;
    const int e = nb[idx];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (rc > j) {
        const int64_t p = pos[j]++;
        if (p < total) stream[p] = (w >> (8 * (rc - 1 - j))) & 0xFF;
        else *err = 1;
      }
      if (e > j) {
        const int64_t p = pos[3 + j]++;
        if (p < total) stream[p] = (x >> (8 * (e - 1 - j))) & 0xFF;
        else *err = 1;
      }
    }
  }
}

}  // namespace

// packed/nb/excw: (T, S) i32; round_base: (T*6,) i64; stream: (total,) u8
// out; err: one i32, set to 1 when a position passes `total` (round_base
// disagrees with the packed words).  Returns the launch's cudaError_t.
extern "C" int place(const void* packed, const void* nb, const void* excw,
                     int64_t n, int T, int S, const void* round_base,
                     void* stream, int64_t total, void* err,
                     void* cuda_stream) {
  if (T == 0) return 0;
  place_kernel<<<T, lane::block_threads(S), 0,
                 static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(nb),
      static_cast<const int32_t*>(excw), n, S,
      static_cast<const int64_t*>(round_base),
      static_cast<uint8_t*>(stream), total, static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
