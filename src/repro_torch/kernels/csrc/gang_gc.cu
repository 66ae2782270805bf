// K4: rpc-matched gang gc with in-kernel aging.
//
// Replaces: src/repro/kernels/witness_record.py gang_gc_pallas
//   (_make_gang_gc_kernel), reached through ops.gang_gc.
// Bound on the card: bytes.  A gc round reads each entry's row (W ways of
//   five planes) and rewrites occ and age of the aged lanes (every slot of
//   a shard's f witness lanes, f * S * W * 12 B, about 150 KB at f = 3,
//   S = 1024, W = 4); the entries themselves are a few kilobytes.
// Design: the TPU kernel built a [rows, W, G] match cube per table tile and
//   decided every clear against the PRE-gc table.  Here that becomes three
//   ordered launches: (1) one thread per entry matches its row's W ways
//   against the untouched table and records a way mask and its cleared bit,
//   (2) one thread per entry clears the ways in its mask (identical entries
//   write identical zeros), (3) one thread per slot of the aged lanes ages
//   occupied survivors and zeroes empty slots.  So two identical entries
//   both report 1, as the Pallas cube does.  Only the aged lanes are
//   touched by (3), not the whole gang.  W must be at most 32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void gc_match_kernel(int G, const uint32_t* __restrict__ g_hi,
                                const uint32_t* __restrict__ g_lo,
                                const uint32_t* __restrict__ g_rh,
                                const uint32_t* __restrict__ g_rl,
                                const int32_t* __restrict__ g_lane,
                                const int32_t* __restrict__ g_valid,
                                int n_sets, int W, const uint32_t* t_hi,
                                const uint32_t* t_lo, const int32_t* t_occ,
                                const uint32_t* t_rh, const uint32_t* t_rl,
                                int32_t* __restrict__ cleared,
                                uint32_t* __restrict__ way_mask) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  uint32_t m = 0;
  if (g_valid[g] == 1) {
    const uint32_t h = g_hi[g], l = g_lo[g], rc = g_rh[g], rs = g_rl[g];
    const int64_t base =
        (static_cast<int64_t>(g_lane[g]) * n_sets + (l & (n_sets - 1))) * W;
    for (int w = 0; w < W; ++w) {
      const int64_t s = base + w;
      if (t_occ[s] > 0 && t_hi[s] == h && t_lo[s] == l && t_rh[s] == rc &&
          t_rl[s] == rs)
        m |= 1u << w;
    }
  }
  way_mask[g] = m;
  cleared[g] = m != 0;
}

__global__ void gc_clear_kernel(int G, const uint32_t* __restrict__ g_lo,
                                const int32_t* __restrict__ g_lane,
                                const uint32_t* __restrict__ way_mask,
                                int n_sets, int W, int32_t* t_occ,
                                int32_t* t_age) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const uint32_t m = way_mask[g];
  if (m == 0) return;
  const int64_t base =
      (static_cast<int64_t>(g_lane[g]) * n_sets + (g_lo[g] & (n_sets - 1))) * W;
  for (int w = 0; w < W; ++w) {
    if ((m >> w) & 1u) {
      t_occ[base + w] = 0;
      t_age[base + w] = 0;
    }
  }
}

__global__ void gc_age_kernel(int64_t n, const int32_t* __restrict__ aged_idx,
                              int64_t lane_slots, const int32_t* t_occ,
                              int32_t* t_age) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = aged_idx[i / lane_slots] * lane_slots + i % lane_slots;
  t_age[s] = t_occ[s] > 0 ? t_age[s] + 1 : 0;
}

}  // namespace

extern "C" int gang_gc_launch(int G, const void* g_hi, const void* g_lo,
                              const void* g_rh, const void* g_rl,
                              const void* g_lane, const void* g_valid,
                              int n_aged, const void* aged_idx, int n_sets,
                              int W, void* t_hi, void* t_lo, void* t_occ,
                              void* t_rh, void* t_rl, void* t_age,
                              void* cleared, void* way_mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > 0) {
    const int blocks = (G + kThreads - 1) / kThreads;
    gc_match_kernel<<<blocks, kThreads, 0, st>>>(
        G, static_cast<const uint32_t*>(g_hi),
        static_cast<const uint32_t*>(g_lo), static_cast<const uint32_t*>(g_rh),
        static_cast<const uint32_t*>(g_rl),
        static_cast<const int32_t*>(g_lane),
        static_cast<const int32_t*>(g_valid), n_sets, W,
        static_cast<const uint32_t*>(t_hi), static_cast<const uint32_t*>(t_lo),
        static_cast<const int32_t*>(t_occ), static_cast<const uint32_t*>(t_rh),
        static_cast<const uint32_t*>(t_rl), static_cast<int32_t*>(cleared),
        static_cast<uint32_t*>(way_mask));
    gc_clear_kernel<<<blocks, kThreads, 0, st>>>(
        G, static_cast<const uint32_t*>(g_lo),
        static_cast<const int32_t*>(g_lane),
        static_cast<const uint32_t*>(way_mask), n_sets, W,
        static_cast<int32_t*>(t_occ), static_cast<int32_t*>(t_age));
  }
  if (n_aged > 0) {
    const int64_t lane_slots = static_cast<int64_t>(n_sets) * W;
    const int64_t n = lane_slots * n_aged;
    gc_age_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(n, static_cast<const int32_t*>(aged_idx),
                                       lane_slots,
                                       static_cast<const int32_t*>(t_occ),
                                       static_cast<int32_t*>(t_age));
  }
  return static_cast<int>(cudaGetLastError());
}
