// K7: the fused fast-path batch on one witness table -- hash, slot route,
// window conflict scan and record -- in one launch.
//
// Replaces: src/repro/kernels/witness_record.py fastpath_record_scan_pallas
//   (:307, its body _make_fused_kernel at :188), with the hash, route and
//   set-parallel prep of ops._fastpath_impl (src/repro/kernels/ops.py:409),
//   reached through ops.fastpath_batch.
// Bound on the card: latency.  The bytes are tiny (a batch of 4096 reads
//   64 KB of keys, a 1024-entry window 12 KB, the probed rows under 50 KB)
//   and so is the work a join needs; what costs is the chain of dependent
//   steps: queries to one set resolve in batch order, each a trip to its
//   row and back.  The earlier kernel paid three launches, a sort by set
//   (several CUB launches and a gather), a brute-force scan of every
//   (query, window entry) pair on 32 of 132 SMs, and one thread per run of
//   equal sets walking its run through dependent global loads.
// Design: one launch, no sort.  Blocks own contiguous ranges of sets (128
//   blocks at S = 1024, so the card is covered).  Each block reads the
//   whole batch coalesced, mixes the raw lanes (keyhash.cuh) and keeps the
//   queries of its own sets in batch order (OwnedList, smem_join.cuh):
//   the order the stable sort gave, and per-set order is the only ordering
//   rule.  The window is staged once per block into a shared-memory
//   KeyMaskTable (64-bit mixed key -> OR of 1 << class over its valid
//   entries), so a query's conflict is one probe: (matrix row & mask) != 0,
//   bit for bit the OR of matrix_bit over its same-key entries.  A window
//   larger than one table is taken in tiles whose hits are ORed, in the
//   same kernel.  Then a warp per
//   set walks that set's queries in batch order (walk_sets, set_walk.cuh,
//   which K6 shares), lanes holding the ways (a
//   stride of 32 over wider sets): ballots find a same-key way whose class
//   bit is set in the query's matrix row (a conflict), else the first free
//   way, which takes occ = 1 + class (a same-key record of a class that
//   does not conflict stacks beside it); else the query is rejected.
//   __syncwarp orders each write before the next query's reads.  No rpc, no
//   DUP, no age.  A batch larger than the block's list is taken in chunks,
//   in batch order (the table carries the state between them).  Every
//   output row is written once: a valid row by the block owning its set,
//   an invalid (padding) row by block 0, with accepted and conflicts 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "set_walk.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 1024;     // queries held per chunk (a multiple of
                                // kThreads)
constexpr int kTile = 1024;     // window entries per staged table
constexpr int kSlots = 2 * kTile;

using Shared = OwnedList<kSlots, kList, kWarps>;

struct Args {
  int B;
  const uint32_t* __restrict__ k_hi;
  const uint32_t* __restrict__ k_lo;
  const int32_t* __restrict__ k_cls;
  const int32_t* __restrict__ k_valid;
  const int32_t* __restrict__ slot_map;
  int n_slots;
  const int32_t* __restrict__ matrix;
  int n_cls;
  const uint32_t* __restrict__ w_hi;
  const uint32_t* __restrict__ w_lo;
  const int32_t* __restrict__ w_valid;
  int U;
  int n_sets;
  int W;
  int sets_per_block;
  uint32_t* t_hi;
  uint32_t* t_lo;
  int32_t* t_occ;
  uint32_t* __restrict__ q_hi;
  uint32_t* __restrict__ q_lo;
  int32_t* __restrict__ shard;
  int32_t* __restrict__ accepted;
  int32_t* __restrict__ conflicts;
};

// Stage window entries [base, base + n) into the table (valid entries of a
// class a matrix row can name; the others never conflict).
__device__ void stage_window(const Args& a, KeyMaskTable& table, int base,
                             int n) {
  __syncthreads();  // no thread still probes the previous tile
  table.clear();
  __syncthreads();
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    const int32_t v = a.w_valid[base + u];
    if (v > 0) table.add(key64(a.w_hi[base + u], a.w_lo[base + u]),
                         class_bit(v - 1));
  }
  __syncthreads();
}

// The block's chunk of n queries: window hits, then the record walk.
__device__ void run_chunk(const Args& a, Shared& sm, KeyMaskTable& table,
                          bool resident, int set0, int n) {
  __syncthreads();  // the chunk's list is complete
  const int n_tiles = (a.U + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    if (!resident)
      stage_window(a, table, t * kTile, min(kTile, a.U - t * kTile));
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t m = table.lookup(key64(sm.q_hi[i], sm.q_lo[i]));
      if (m & static_cast<uint32_t>(matrix_row(a.matrix, a.n_cls,
                                               sm.q_cls[i])))
        sm.q_idx[i] |= kHit;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    a.conflicts[sm.q_idx[i] & kPos] = (sm.q_idx[i] & kHit) ? 1 : 0;
  walk_sets<kWarps>(a, sm, set0, n, a.accepted);
  __syncthreads();  // the list is free for the next chunk
}

__global__ void __launch_bounds__(kThreads)
    fastpath_batch_kernel(const Args a) {
  __shared__ Shared sm;
  KeyMaskTable table = sm.table();
  const int set0 = blockIdx.x * a.sets_per_block;
  const int set1 = min(set0 + a.sets_per_block, a.n_sets);
  const bool resident = a.U <= kTile;
  if (resident && a.U > 0) stage_window(a, table, 0, a.U);
  sm.gather(
      a.B,
      [&](int b, Owned& q) {
        keyhash2x32(a.k_hi[b], a.k_lo[b], q.hi, q.lo);
        const bool valid = a.k_valid[b] == 1;
        const int set =
            static_cast<int>(q.lo & static_cast<uint32_t>(a.n_sets - 1));
        if (valid ? (set < set0 || set >= set1) : blockIdx.x != 0)
          return false;
        a.q_hi[b] = q.hi;
        a.q_lo[b] = q.lo;
        a.shard[b] = a.slot_map[q.lo % static_cast<uint32_t>(a.n_slots)];
        if (!valid) {  // padding neither accepts nor hits
          a.accepted[b] = 0;
          a.conflicts[b] = 0;
        }
        q.cls = a.k_cls[b];
        q.idx = b;
        return valid;
      },
      [&](int n) { run_chunk(a, sm, table, resident, set0, n); });
}

}  // namespace

extern "C" int fastpath_batch_launch(
    int B, const void* k_hi, const void* k_lo, const void* k_cls,
    const void* k_valid, const void* slot_map, int n_slots,
    const void* matrix, int n_cls, const void* w_hi, const void* w_lo,
    const void* w_valid, int U, int n_sets, int W, void* t_hi, void* t_lo,
    void* t_occ, void* q_hi, void* q_lo, void* shard, void* accepted,
    void* conflicts, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int spb = sets_per_block(n_sets);
  const Args a{B,
               static_cast<const uint32_t*>(k_hi),
               static_cast<const uint32_t*>(k_lo),
               static_cast<const int32_t*>(k_cls),
               static_cast<const int32_t*>(k_valid),
               static_cast<const int32_t*>(slot_map),
               n_slots,
               static_cast<const int32_t*>(matrix),
               n_cls,
               static_cast<const uint32_t*>(w_hi),
               static_cast<const uint32_t*>(w_lo),
               static_cast<const int32_t*>(w_valid),
               U,
               n_sets,
               W,
               spb,
               static_cast<uint32_t*>(t_hi),
               static_cast<uint32_t*>(t_lo),
               static_cast<int32_t*>(t_occ),
               static_cast<uint32_t*>(q_hi),
               static_cast<uint32_t*>(q_lo),
               static_cast<int32_t*>(shard),
               static_cast<int32_t*>(accepted),
               static_cast<int32_t*>(conflicts)};
  fastpath_batch_kernel<<<(n_sets + spb - 1) / spb, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
