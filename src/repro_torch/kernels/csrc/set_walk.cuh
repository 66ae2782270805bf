// The record walk of the set-owning batch kernels: K7 (fastpath_batch.cu)
// and K6 (witness_table.cu); K2 (gang_record.cu) walks its gang rows with
// the same walk_owned and a record rule of its own.
//
// Blocks own contiguous ranges of a table's sets (sets_per_block: about
// kTargetBlocks blocks, so the card is covered) and keep their own queries
// in batch order (OwnedList::gather, smem_join.cuh).  walk_sets then records
// a chunk of that list: warp w takes the block's sets round robin, so a set
// is only ever touched by one warp and its queries resolve in batch order,
// and sets never race.  Per query (record_one), lanes hold the set's ways (a
// stride of 32 over wider sets): __any_sync finds a same-key way whose class
// bit is set in the query's matrix row (a conflict), else __ballot_sync the
// first free way, which takes occ = 1 + class (a same-key record of a class
// that does not conflict stacks beside it); else the query is rejected.
// __syncwarp orders each write before the next query's reads.  No rpc, no
// DUP, no age.
//
// The table argument is the kernel's own argument struct; it must have the
// fields t_hi, t_lo, t_occ (the [S, W] planes), n_sets, W, matrix and n_cls.
#pragma once

#include <cstdint>

#include "keyhash.cuh"
#include "smem_join.cuh"

namespace repro_torch {

constexpr int kTargetBlocks = 128;

// Sets (or gang rows) per block for n of them: enough blocks to cover the
// card (kTargetBlocks when n is a multiple of it, at most twice as many
// otherwise; the launch takes ceil(n / this) blocks).
inline int sets_per_block(int n) {
  return n > kTargetBlocks ? n / kTargetBlocks : 1;
}

// List item j against its set's row, all lanes of the warp together; lane 0
// writes its accept bit at accepted[batch position].
template <typename Table, typename List>
__device__ __forceinline__ void record_one(const Table& a, const List& sm,
                                           int j, int32_t* accepted) {
  const int lane = threadIdx.x & 31;
  const uint32_t h = sm.q_hi[j], l = sm.q_lo[j];
  const int32_t cls = sm.q_cls[j];
  const int32_t mrow = matrix_row(a.matrix, a.n_cls, cls);
  const int64_t row =
      static_cast<int64_t>(l & static_cast<uint32_t>(a.n_sets - 1)) * a.W;
  bool conflict = false;
  int way = -1;
  for (int c = 0; c < a.W; c += 32) {
    const int w = c + lane;
    bool conf = false, free = false;
    if (w < a.W) {
      const int32_t o = a.t_occ[row + w];
      free = o == 0;
      conf = o > 0 && a.t_hi[row + w] == h && a.t_lo[row + w] == l &&
             matrix_bit(mrow, o - 1);
    }
    conflict |= __any_sync(kAllLanes, conf) != 0;
    const unsigned fm = __ballot_sync(kAllLanes, free);
    if (way < 0 && fm != 0u) way = c + __ffs(fm) - 1;
  }
  const bool ok = !conflict && way >= 0;
  if (ok && lane == (way & 31)) {
    a.t_hi[row + way] = h;
    a.t_lo[row + way] = l;
    a.t_occ[row + way] = 1 + cls;
  }
  if (lane == 0) accepted[sm.q_idx[j] & kPos] = ok ? 1 : 0;
  __syncwarp();
}

// The ordered walk of a block's list: warp w (of kWarps) runs record(j), in
// list order, on each of the list's first n items whose slot (its set or
// row, less the block's first) is w modulo kWarps, so one slot is only ever
// touched by one warp and its items resolve in batch order.  Every thread
// of the block calls it, after a barrier that follows the list's last
// write; the caller places the barrier before the list is reused.
template <int kWarps, typename Slot, typename Record>
__device__ __forceinline__ void walk_owned(int n, Slot slot, Record record) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool mine = i < n && slot(i) % kWarps == warp;
    unsigned m = __ballot_sync(kAllLanes, mine);
    while (m != 0u) {
      const int j = base + __ffs(m) - 1;
      m &= m - 1u;
      record(j);
    }
  }
}

// Record the list's first n items, the block's sets starting at set0.
template <int kWarps, typename Table, typename List>
__device__ __forceinline__ void walk_sets(const Table& a, const List& sm,
                                          int set0, int n,
                                          int32_t* accepted) {
  walk_owned<kWarps>(
      n,
      [&](int i) {
        return static_cast<int>(sm.q_lo[i] &
                                static_cast<uint32_t>(a.n_sets - 1)) -
               set0;
      },
      [&](int j) { record_one(a, sm, j, accepted); });
}

}  // namespace repro_torch
