// K4: rpc-matched gang gc with in-kernel aging.
//
// Replaces: src/repro/kernels/witness_record.py gang_gc_pallas
//   (_make_gang_gc_kernel), reached through ops.gang_gc.
// Bound on the card: bytes.  A gc round reads each entry's row (W ways of
//   five planes) and rewrites occ and age of the aged lanes (every slot of
//   a shard's f witness lanes, f * S * W * 12 B, about 150 KB at f = 3,
//   S = 1024, W = 4); the entries themselves are a few kilobytes.  At these
//   sizes a call costs its launch and a few dependent trips to memory.
// Design: one launch.  The TPU kernel built a [rows, W, G] match cube per
//   table tile and decided every clear against the PRE-gc table, so two
//   identical entries both report 1.  Here every gang row is owned by
//   exactly one block, and a block decides, clears and ages only its own
//   rows, with a barrier between the steps:
//   - a row of an aged lane belongs to the aged block of its tile of that
//     lane (tile_rows rows, about 1024 slots; n_aged x tiles blocks, lane
//     aged_idx[k] for block k / tiles);
//   - any other row belongs to entry block row % n_entry (ceil(G / 256)
//     entry blocks, which mark the aged lanes in a shared bitmap).
//   Each block walks all G entries and (1) matches the W ways of the rows
//   it owns against the untouched table, writing the entry's way mask and
//   cleared bit; after a barrier (2) clears those ways (occ and age to 0;
//   identical entries write identical zeros); after another barrier (3) an
//   aged block ages its tile: occupied survivors +1, empty slots 0.  Global
//   writes before a barrier are visible to the whole block, and no row is
//   touched by two blocks, so no decision can see another entry's clear.
//   A call is a chain of dependent trips to memory, so the kernel shortens
//   it: a thread loads its first entry, and an aged block its tile's
//   pre-gc occ and age, before anything else; a thread keeps its first
//   entry's way mask in registers for step 2 (looping over every entry
//   alike and reading the mask back measured 0.0033 ms of device time
//   against 0.0029 on an H100 at 700 W, G = 256, three aged 1024 x 4 lanes);
//   and step 3 ages from the loaded values, reading step 2's clears from
//   a shared bitmap of the tile.  do_age = false gives no aged blocks.
//   W must be at most 32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kAgePerThread = 4;
constexpr int kTileSlots = kAgePerThread * kThreads;  // slots an aged block
                                                      // ages

struct Args {
  int G;
  const uint32_t* __restrict__ g_hi;
  const uint32_t* __restrict__ g_lo;
  const uint32_t* __restrict__ g_rh;
  const uint32_t* __restrict__ g_rl;
  const int32_t* __restrict__ g_lane;
  const int32_t* __restrict__ g_valid;
  int n_aged;
  const int32_t* __restrict__ aged_idx;
  int n_lanes;
  int n_sets;
  int W;
  int tile_rows;  // rows of an aged block's tile
  int tiles;      // tiles per aged lane
  int n_entry;    // entry blocks, after the n_aged * tiles aged blocks
  const uint32_t* t_hi;
  const uint32_t* t_lo;
  int32_t* t_occ;
  const uint32_t* t_rh;
  const uint32_t* t_rl;
  int32_t* t_age;
  int32_t* __restrict__ cleared;
  uint32_t* __restrict__ way_mask;
};

struct Entry {
  int32_t lane, valid;
  uint32_t hi, lo, rh, rl;
};

__device__ __forceinline__ Entry load_entry(const Args& a, int g) {
  return Entry{a.g_lane[g], a.g_valid[g], a.g_hi[g],
               a.g_lo[g],   a.g_rh[g],    a.g_rl[g]};
}

__global__ void __launch_bounds__(kThreads) gang_gc_kernel(const Args a) {
  extern __shared__ uint32_t aged_bits[];             // entry blocks
  __shared__ uint32_t tile_cleared[kTileSlots / 32];  // aged blocks
  const int n_aged_blocks = a.n_aged * a.tiles;
  const bool aged_block = static_cast<int>(blockIdx.x) < n_aged_blocks;
  // First the loads that wait on nothing: this thread's first entry, and
  // an aged block's lane and its tile's pre-gc occ and age.
  const int g0 = threadIdx.x;
  Entry e0{};
  if (g0 < a.G) e0 = load_entry(a, g0);
  int my_lane = -1, my_tile = 0, tile_n = 0;
  int64_t s0 = 0;
  int32_t occ0[kAgePerThread], age0[kAgePerThread];
  if (aged_block) {
    my_lane = a.aged_idx[blockIdx.x / a.tiles];
    my_tile = blockIdx.x % a.tiles;
    tile_n = min(a.tile_rows, a.n_sets - my_tile * a.tile_rows) * a.W;
    s0 = (static_cast<int64_t>(my_lane) * a.n_sets +
          static_cast<int64_t>(my_tile) * a.tile_rows) * a.W;
#pragma unroll
    for (int k = 0; k < kAgePerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      occ0[k] = i < tile_n ? a.t_occ[s0 + i] : 0;
      age0[k] = i < tile_n ? a.t_age[s0 + i] : 0;
    }
    for (int i = threadIdx.x; i < kTileSlots / 32; i += kThreads)
      tile_cleared[i] = 0u;  // ordered before step 2 by the first barrier
  } else if (a.n_aged > 0) {
    for (int i = threadIdx.x; i < (a.n_lanes + 31) / 32; i += kThreads)
      aged_bits[i] = 0u;
    __syncthreads();
    for (int k = threadIdx.x; k < a.n_aged; k += kThreads)
      atomicOr(&aged_bits[a.aged_idx[k] >> 5], 1u << (a.aged_idx[k] & 31));
    __syncthreads();
  }
  const int entry = static_cast<int>(blockIdx.x) - n_aged_blocks;
  // The row of an entry if this block owns it, else -1.
  auto owned_row = [&](const Entry& e) -> int64_t {
    const int set =
        static_cast<int>(e.lo & static_cast<uint32_t>(a.n_sets - 1));
    const int64_t row = static_cast<int64_t>(e.lane) * a.n_sets + set;
    if (aged_block)
      return e.lane == my_lane && set / a.tile_rows == my_tile ? row : -1;
    if (a.n_aged > 0 && ((aged_bits[e.lane >> 5] >> (e.lane & 31)) & 1u))
      return -1;
    return row % a.n_entry == entry ? row : -1;
  };
  // (1) Decide against the untouched table.
  auto decide = [&](int g, const Entry& e, int64_t row) {
    uint32_t m = 0;
    for (int w = 0; w < a.W; ++w) {
      const int64_t s = row * a.W + w;
      if (a.t_occ[s] > 0 && a.t_hi[s] == e.hi && a.t_lo[s] == e.lo &&
          a.t_rh[s] == e.rh && a.t_rl[s] == e.rl)
        m |= 1u << w;
    }
    if (e.valid != 1) m = 0;
    a.way_mask[g] = m;
    a.cleared[g] = m != 0;
    return m;
  };
  const int64_t row0 = g0 < a.G ? owned_row(e0) : -1;
  const uint32_t m0 = row0 >= 0 ? decide(g0, e0, row0) : 0u;
  for (int g = g0 + kThreads; g < a.G; g += kThreads) {
    const Entry e = load_entry(a, g);
    const int64_t row = owned_row(e);
    if (row >= 0) decide(g, e, row);
  }
  __syncthreads();  // every decision of this block's rows is taken
  // (2) Clear (an aged block also marks the slot in its tile's bitmap).
  auto clear = [&](int64_t row, uint32_t m) {
    for (int w = 0; w < a.W; ++w) {
      if (!((m >> w) & 1u)) continue;
      const int64_t s = row * a.W + w;
      a.t_occ[s] = 0;
      a.t_age[s] = 0;
      if (aged_block) {
        const int i = static_cast<int>(s - s0);
        atomicOr(&tile_cleared[i >> 5], 1u << (i & 31));
      }
    }
  };
  if (row0 >= 0) clear(row0, m0);
  for (int g = g0 + kThreads; g < a.G; g += kThreads) {
    const int64_t row = owned_row(load_entry(a, g));
    if (row >= 0) clear(row, a.way_mask[g]);  // this thread's step-1 write
  }
  if (!aged_block) return;
  __syncthreads();  // the tile's clears are marked
  // (3) Age the tile from its pre-gc values: cleared and empty slots 0,
  // occupied survivors +1.
#pragma unroll
  for (int k = 0; k < kAgePerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= tile_n) continue;
    const bool gone = (tile_cleared[i >> 5] >> (i & 31)) & 1u;
    a.t_age[s0 + i] = !gone && occ0[k] > 0 ? age0[k] + 1 : 0;
  }
}

}  // namespace

extern "C" int gang_gc_launch(int G, const void* g_hi, const void* g_lo,
                              const void* g_rh, const void* g_rl,
                              const void* g_lane, const void* g_valid,
                              int n_aged, const void* aged_idx, int n_lanes,
                              int n_sets, int W, void* t_hi, void* t_lo,
                              void* t_occ, void* t_rh, void* t_rl, void* t_age,
                              void* cleared, void* way_mask, void* stream) {
  const int tile_rows = max(1, min(n_sets, kTileSlots / max(W, 1)));
  const int tiles = (n_sets + tile_rows - 1) / tile_rows;
  const int n_entry = (G + kThreads - 1) / kThreads;
  const int blocks = n_aged * tiles + n_entry;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const Args a{G,
               static_cast<const uint32_t*>(g_hi),
               static_cast<const uint32_t*>(g_lo),
               static_cast<const uint32_t*>(g_rh),
               static_cast<const uint32_t*>(g_rl),
               static_cast<const int32_t*>(g_lane),
               static_cast<const int32_t*>(g_valid),
               n_aged,
               static_cast<const int32_t*>(aged_idx),
               n_lanes,
               n_sets,
               W,
               tile_rows,
               tiles,
               n_entry,
               static_cast<const uint32_t*>(t_hi),
               static_cast<const uint32_t*>(t_lo),
               static_cast<int32_t*>(t_occ),
               static_cast<const uint32_t*>(t_rh),
               static_cast<const uint32_t*>(t_rl),
               static_cast<int32_t*>(t_age),
               static_cast<int32_t*>(cleared),
               static_cast<uint32_t*>(way_mask)};
  const size_t bitmap = n_aged > 0 ? ((n_lanes + 31) / 32) * sizeof(uint32_t)
                                   : 0;
  gang_gc_kernel<<<blocks, kThreads, bitmap,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
