// K8: master-side commutativity check of B queries against a U-entry
// unsynced window.
//
// Replaces: src/repro/kernels/conflict_scan.py conflict_scan_pallas
//   (_conflict_kernel), reached through ops.conflict_scan.
// Bound on the card: operations.  The inputs are 12 B per query and per
//   window entry, but the scan makes B * U compares (4M at B = 4096,
//   U = 1024), each a few integer operations on staged words.
// Design: one thread per query; each block stages the window in shared
//   memory a tile at a time (window_scan.cuh) and each thread ORs over it,
//   stopping at its first hit.  No padding to tiles: the tail of the batch
//   is masked and the last window tile is short, so any B and U give the
//   answer the TPU gave on its (256, 512)-padded arrays.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "window_scan.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;

__global__ void conflict_scan_kernel(
    int B, const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    const int32_t* __restrict__ q_cls, const int32_t* __restrict__ matrix,
    int n_cls, const uint32_t* __restrict__ w_hi,
    const uint32_t* __restrict__ w_lo, const int32_t* __restrict__ w_valid,
    int U, int32_t* __restrict__ conflicts) {
  __shared__ WindowTile tile;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  uint32_t h = 0, l = 0;
  int32_t mrow = 0;
  if (active) {
    h = q_hi[b];
    l = q_lo[b];
    mrow = matrix_row(matrix, n_cls, q_cls[b]);
  }
  const bool hit = window_hit(tile, active, h, l, mrow, w_hi, w_lo, w_valid, U);
  if (active) conflicts[b] = hit ? 1 : 0;
}

}  // namespace

extern "C" int conflict_scan_launch(int B, const void* q_hi, const void* q_lo,
                                    const void* q_cls, const void* matrix,
                                    int n_cls, const void* w_hi,
                                    const void* w_lo, const void* w_valid,
                                    int U, void* conflicts, void* stream) {
  if (B > 0) {
    conflict_scan_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), static_cast<const int32_t*>(q_cls),
        static_cast<const int32_t*>(matrix), n_cls,
        static_cast<const uint32_t*>(w_hi), static_cast<const uint32_t*>(w_lo),
        static_cast<const int32_t*>(w_valid), U,
        static_cast<int32_t*>(conflicts));
  }
  return static_cast<int>(cudaGetLastError());
}
