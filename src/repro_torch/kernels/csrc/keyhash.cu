// K1: batched keyhash2x32, and the slot route of shard_route.
//
// Replaces: src/repro/kernels/keyhash.py keyhash2x32_pallas (_keyhash_kernel),
//   reached through ops.keyhash2x32, and ops._shard_route_impl (the same
//   kernel plus an XLA gather slot_map[lo % n_slots]).
// Bound on the card: bytes.  A key reads two uint32 lanes and writes two
//   (16 B; 20 B with the route, whose slot map stays in L1/L2), against
//   about 20 integer operations: at 1M keys the bytes take ~5 us at
//   3.35 TB/s, the operations well under 1 us.
// Design: one thread per key, neighbouring threads on neighbouring words,
//   so every load and store is coalesced.  The TPU padded the batch to
//   1024-wide blocks; here the tail is masked.  The mix itself is the one in
//   keyhash.cuh that K2-K5 and K7 inline, so routing and placement cannot
//   drift apart.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

__global__ void keyhash_kernel(int N, const uint32_t* __restrict__ hi,
                               const uint32_t* __restrict__ lo,
                               uint32_t* __restrict__ out_hi,
                               uint32_t* __restrict__ out_lo,
                               const int32_t* __restrict__ slot_map,
                               int n_slots, int32_t* __restrict__ shard) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t h, l;
  keyhash2x32(hi[i], lo[i], h, l);
  out_hi[i] = h;
  out_lo[i] = l;
  if (shard != nullptr) shard[i] = slot_map[l % static_cast<uint32_t>(n_slots)];
}

}  // namespace

// shard (and slot_map) may be null: then only the mixed lanes are written.
extern "C" int keyhash_launch(int N, const void* hi, const void* lo,
                              void* out_hi, void* out_lo, const void* slot_map,
                              int n_slots, void* shard, void* stream) {
  if (N > 0) {
    keyhash_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        N, static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo),
        static_cast<const int32_t*>(slot_map), n_slots,
        static_cast<int32_t*>(shard));
  }
  return static_cast<int>(cudaGetLastError());
}
