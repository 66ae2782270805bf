// The window scan of K8 (conflict_scan.cu): does a query's key meet a
// valid entry of the unsynced window whose class conflicts with the
// query's?
//
// Replaces the compare-reduce of src/repro/kernels/conflict_scan.py
// _conflict_kernel.  The TPU streamed (256 x 512) tiles of the [B, U]
// compare cube through VMEM and ORed across the U axis of the grid.  Here
// one thread holds one query, and the block stages the window through
// shared memory a tile at a time (12 KB); every thread then reads each
// staged entry as a broadcast.  K7 (fastpath_batch.cu) answers the same
// question with one probe of a shared-memory KeyMaskTable
// (smem_join.cuh), the join this scan can take in its own redesign.
#pragma once

#include <cstdint>

#include "keyhash.cuh"

namespace repro_torch {

constexpr int kWindowTile = 1024;

struct WindowTile {
  uint32_t hi[kWindowTile];
  uint32_t lo[kWindowTile];
  int32_t valid[kWindowTile];
};

// OR over u of (w_hi[u], w_lo[u]) == (h, l) && w_valid[u] > 0 && the bit of
// class w_valid[u] - 1 in the query's matrix row.  w_valid packs 0 (invalid)
// or 1 + class; legacy 0/1 windows read class SET.  Every thread of the
// block must call it (the tiles are staged together); `active` says whether
// the thread has a query to answer.
__device__ __forceinline__ bool window_hit(
    WindowTile& tile, bool active, uint32_t h, uint32_t l, int32_t mrow,
    const uint32_t* __restrict__ w_hi, const uint32_t* __restrict__ w_lo,
    const int32_t* __restrict__ w_valid, int U) {
  bool hit = false;
  for (int base = 0; base < U; base += kWindowTile) {
    const int n = min(kWindowTile, U - base);
    __syncthreads();  // no thread still reads the previous tile
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      tile.hi[i] = w_hi[base + i];
      tile.lo[i] = w_lo[base + i];
      tile.valid[i] = w_valid[base + i];
    }
    __syncthreads();
    if (!active || hit) continue;
    for (int u = 0; u < n; ++u) {
      const int32_t v = tile.valid[u];
      if (v > 0 && tile.hi[u] == h && tile.lo[u] == l &&
          matrix_bit(mrow, v - 1)) {
        hit = true;
        break;
      }
    }
  }
  return hit;
}

}  // namespace repro_torch
