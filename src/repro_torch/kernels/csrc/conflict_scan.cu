// K8: master-side commutativity check of B queries against a U-entry
// unsynced window, in one launch.
//
// Replaces: src/repro/kernels/conflict_scan.py conflict_scan_pallas
//   (_conflict_kernel), reached through ops.conflict_scan.  The TPU
//   streamed (256 x 512) tiles of the [B, U] compare cube through VMEM and
//   ORed across the U axis of its grid.
// Bound on the card: latency.  The inputs are 16 B per query and 12 B per
//   window entry (78 KB at B = 4096, U = 1024), and a join needs a few
//   operations per key; what costs is the chain of dependent steps of one
//   block: load, clear the table, insert, probe, store, with a barrier
//   between each.  The earlier kernel walked every (query, window entry)
//   pair, B * U compares, on 32 of 132 SMs.
// Design: a join, not a scan.  Each block of 1024 queries, one a thread,
//   stages the window into a shared-memory KeyMaskTable (smem_join.cuh):
//   64-bit mixed key -> OR of 1 << class over its valid entries (w_valid
//   packs 0 or 1 + class, so legacy 0/1 windows read class SET; an entry
//   of a class of 32 or more adds nothing, as matrix_bit never sets it).
//   Then each query makes one probe, and conflict = (matrix row & mask) !=
//   0, bit for bit the OR of matrix_bit over its same-key entries.  A
//   window larger than one table (kTile entries in 2 * kTile slots) is
//   taken in tiles whose hits are ORed in a register.  Each thread loads
//   its query and its entry of a tile before the table is cleared, so those
//   trips overlap.  The time follows the entries a thread stages, not the
//   SMs in use: at B = 4096, U = 1024 on one H100 80GB HBM3 at 700 W
//   (chip_smoke.py phase 4), 0.0176 ms at 128 threads a block (8 entries a
//   thread, 32 blocks), 0.0091 at 256, 0.0064 at 512 and 0.0050 at 1024 (4
//   blocks).  The tail of the batch is masked and the last tile is short:
//   any B and U give the answer the TPU gave on its padded arrays.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 1024;  // window entries per staged table
constexpr int kSlots = 2 * kTile;
constexpr int kPer = kTile / kThreads;  // entries a thread stages per tile
static_assert(kTile % kThreads == 0, "a tile is whole entries a thread");

__global__ void __launch_bounds__(kThreads) conflict_scan_kernel(
    int B, const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    const int32_t* __restrict__ q_cls, const int32_t* __restrict__ matrix,
    int n_cls, const uint32_t* __restrict__ w_hi,
    const uint32_t* __restrict__ w_lo, const int32_t* __restrict__ w_valid,
    int U, int32_t* __restrict__ conflicts) {
  __shared__ unsigned long long keys[kSlots];
  __shared__ uint32_t mask[kSlots + 1];
  KeyMaskTable table{keys, mask, kSlots};
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool active = b < B;
  uint64_t q = 0;
  uint32_t mrow = 0u;
  if (active) {
    q = key64(q_hi[b], q_lo[b]);
    mrow = static_cast<uint32_t>(matrix_row(matrix, n_cls, q_cls[b]));
  }
  uint32_t hit = 0u;
  for (int base = 0; base < U; base += kTile) {
    uint64_t wk[kPer];
    uint32_t wb[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = base + k * kThreads + threadIdx.x;
      wk[k] = 0;
      wb[k] = 0u;
      if (u < U) {
        const int32_t v = w_valid[u];
        wk[k] = key64(w_hi[u], w_lo[u]);
        wb[k] = v > 0 ? class_bit(v - 1) : 0u;
      }
    }
    if (base > 0) __syncthreads();  // no thread still probes the last tile
    table.clear();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) table.add(wk[k], wb[k]);
    __syncthreads();
    if (active) hit |= table.lookup(q) & mrow;
  }
  if (active) conflicts[b] = hit != 0u ? 1 : 0;
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
