// K10: gc of synced entries from one witness table, in one launch.
//
// Replaces: src/repro/kernels/witness_record.py witness_gc_pallas
//   (_gc_kernel), reached through ops.witness_gc.  The TPU compared the
//   whole [S, W, G] cube of slots against entries.
// Bound on the card: latency.  The bytes are the table's three planes read
//   once, the entries read once and the occ words that clear written once
//   (68,892 B for the gc chain's 1645 entries on 1024 x 4), and a join
//   needs a few operations a key.  What costs is the chain of dependent
//   steps of one block: load, clear the table, insert, probe, store, with
//   a barrier between each.  The earlier kernel walked every (slot, entry)
//   pair, one dependent shared-memory compare after another, on 16 of 132
//   SMs.
// Design: a join, not a scan, on K8's shape (conflict_scan.cu).  Each
//   block of 1024 threads owns 1024 slots, one a thread, and keeps the
//   slot's key pair and occ > 0 in registers.  The block stages the G
//   entries into a shared-memory KeyMaskTable (smem_join.cuh) with mask
//   bit 1, in tiles of kTile entries, one entry a thread; then each held
//   slot makes one lookup a tile.  A held slot that finds its key writes
//   occ = 0; the key planes are never written.  The contract reads no set
//   index, so every slot is joined, wherever its key lies.  Each thread
//   loads its slot and its entry of a tile before the table is cleared, so
//   those trips overlap.  Clears are idempotent and order-free, so blocks
//   need no ordering and repeated entries need no care.  The two special
//   keys: the mixed key (0xFFFFFFFF, 0xFFFFFFFF) is the table's empty
//   marker and lives in its spare slot mask[cap], so it clears like any
//   other; a zero entry meets slots left zero, which stay as they are
//   because occ > 0 gates the clear.
//   The table is static, 2 x kTile slots as in K8, all of them used at any
//   G.  Measured on one H100 80GB HBM3 at 700 W against variants of this
//   file: a table sized to the entries (128 slots at G = 50) was slower,
//   its 1024 lanes meeting more bank conflicts in fewer slots than the
//   clear saves; blocks of 512 or 256 slots (tiles as wide) were slower at
//   1645 entries and more, each block staging every entry; an early return
//   for a block that holds no slot cost its barrier on every other block.
//   G = 0 launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 1024;  // entries per staged table, one a thread
constexpr int kSlots = 2 * kTile;
static_assert(kTile == kThreads, "a tile is one entry a thread");

__global__ void __launch_bounds__(kThreads) witness_gc_kernel(
    int n_slots, int G, const uint32_t* __restrict__ g_hi,
    const uint32_t* __restrict__ g_lo, const uint32_t* __restrict__ t_hi,
    const uint32_t* __restrict__ t_lo, int32_t* __restrict__ t_occ) {
  __shared__ unsigned long long keys[kSlots];
  __shared__ uint32_t mask[kSlots + 1];
  KeyMaskTable table{keys, mask, kSlots};
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool held = false;
  uint64_t k = 0;
  if (i < n_slots) {
    held = t_occ[i] > 0;
    k = key64(t_hi[i], t_lo[i]);
  }
  bool hit = false;
  for (int base = 0; base < G; base += kTile) {
    const int e = base + threadIdx.x;
    const bool entry = e < G;
    const uint64_t ek = entry ? key64(g_hi[e], g_lo[e]) : 0;
    if (base > 0) __syncthreads();  // no thread still probes the last tile
    table.clear();
    __syncthreads();
    table.add(ek, entry ? 1u : 0u);
    __syncthreads();
    if (held && !hit) hit = table.lookup(k) != 0u;
  }
  if (hit) t_occ[i] = 0;
}

}  // namespace

extern "C" int witness_gc_launch(int n_slots, int G, const void* g_hi,
                                 const void* g_lo, const void* t_hi,
                                 const void* t_lo, void* t_occ, void* stream) {
  if (n_slots > 0 && G > 0) {
    witness_gc_kernel<<<(n_slots + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        n_slots, G, static_cast<const uint32_t*>(g_hi),
        static_cast<const uint32_t*>(g_lo), static_cast<const uint32_t*>(t_hi),
        static_cast<const uint32_t*>(t_lo), static_cast<int32_t*>(t_occ));
  }
  return static_cast<int>(cudaGetLastError());
}
