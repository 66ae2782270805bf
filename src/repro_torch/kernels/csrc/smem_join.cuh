// Shared-memory building blocks of the one-launch batch kernels: a stable
// block compaction (which threads of a block hold an item of the block's
// own, in thread order), an open-addressed key -> class-mask table, and the
// list of a block's own items that the two fill.
//
// K7 (fastpath_batch.cu), K6 (witness_table.cu), K3 (gang_fastpath.cu) and
// K2 (gang_record.cu) take a batch in one launch, each block owning a part
// of the state (a range of witness sets or gang rows, one shard's ring).
// Every block reads the whole batch coalesced and keeps the items it owns
// in batch order (gather_owned, on block_rank; OwnedList is the list of K3,
// K6 and K7, K2 keeps its own).  K3, K7 and K8 (conflict_scan.cu) answer
// "does this key meet a staged entry of a class that conflicts with mine?"
// by one probe of a KeyMaskTable instead of a walk over every staged entry:
// the table maps a 64-bit mixed key to the OR of 1 << class over its
// entries, so a conflict is (matrix row & mask) != 0 -- bit for bit the OR,
// over same-key entries, of the matrix_bit test of keyhash.cuh.
#pragma once

#include <cstdint>

#include "keyhash.cuh"

namespace repro_torch {

constexpr unsigned kAllLanes = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t key64(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// 1 << cls for a class a matrix row can name (0..31), else 0: the mask
// form of matrix_bit (a class of 32 or more, or below 0, never conflicts).
__device__ __forceinline__ uint32_t class_bit(int32_t cls) {
  return (cls >= 0 && cls < 32) ? (1u << cls) : 0u;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The position of this thread's item among the flagged threads of the
// block, in thread order (so a block that reads items b = base + tid keeps
// them in batch order); `total` gets the block's count.  Every thread of
// the block must call it.  `warp_counts` is shared scratch of one int per
// warp; the trailing barrier lets the next call reuse it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts,
                                          int& total) {
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kAllLanes, flag);
  if ((threadIdx.x & 31) == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + __popc(ballot & lanes_below());
}

// Open addressing over `cap` slots (a power of two, at least twice the
// distinct keys it is given), linear probing.  A slot's key is claimed with
// atomicCAS, so threads insert concurrently; ~0 marks an empty slot, and
// the one key equal to it lives in the spare value slot `cap`.  Lookups
// run after a barrier that follows the inserts.
struct KeyMaskTable {
  unsigned long long* keys;  // [cap]
  uint32_t* mask;            // [cap + 1]
  int cap;

  static constexpr unsigned long long kEmpty = ~0ull;

  __device__ __forceinline__ int home(uint64_t k) const {
    const uint32_t h = fmix32(static_cast<uint32_t>(k >> 32) ^
                              fmix32(static_cast<uint32_t>(k)));
    return static_cast<int>(h & static_cast<uint32_t>(cap - 1));
  }

  // Every thread of the block; the caller places the barrier after.
  __device__ __forceinline__ void clear() {
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      keys[i] = kEmpty;
      mask[i] = 0u;
    }
    if (threadIdx.x == 0) mask[cap] = 0u;
  }

  // The slot of `k`, claimed if absent.
  __device__ __forceinline__ int insert(uint64_t k) {
    if (k == kEmpty) return cap;
    int s = home(k);
    for (;;) {
      const unsigned long long prev = atomicCAS(&keys[s], kEmpty, k);
      if (prev == kEmpty || prev == k) return s;
      s = (s + 1) & (cap - 1);
    }
  }

  __device__ __forceinline__ void add(uint64_t k, uint32_t bits) {
    if (bits != 0u) atomicOr(&mask[insert(k)], bits);
  }

  // The OR of the classes staged under `k` (0 if none).
  __device__ __forceinline__ uint32_t lookup(uint64_t k) const {
    if (k == kEmpty) return mask[cap];
    for (int s = home(k);; s = (s + 1) & (cap - 1)) {
      const unsigned long long at = keys[s];
      if (at == k) return mask[s];
      if (at == kEmpty) return 0u;
    }
  }
};

// An item a block keeps: its mixed key, its class, and its batch position
// below bit 29 with flag bits above (kHit here, others of a kernel's own).
struct Owned {
  uint32_t hi, lo;
  int32_t cls, idx;
};

constexpr int32_t kHit = 1 << 29;  // the item meets a conflicting entry
constexpr int32_t kPos = kHit - 1;

// The stable gather of a block's own items, in batch order, into a list of
// up to kList: own(b, item) says whether the block keeps item b (and fills
// it), and store(pos, item) writes a kept item at its list position.  Every
// thread reads the batch b < B, one item per thread and step.  take(n)
// runs on the list's n items whenever another step could overflow it, and
// once at the end, so a block with more items than kList takes them in
// chunks, in batch order.  Every thread of the block calls it (own and
// store hold no barrier; take may).
template <int kList, typename Item, typename Own, typename Store,
          typename Take>
__device__ __forceinline__ void gather_owned(int B, int* warp_counts, Own own,
                                             Store store, Take take) {
  int n = 0;  // items in the list (the same in every thread)
  for (int base = 0; base < B; base += blockDim.x) {
    if (n + static_cast<int>(blockDim.x) > kList) {
      take(n);
      n = 0;
    }
    const int b = base + threadIdx.x;
    Item it{};
    const bool mine = b < B && own(b, it);
    int added;
    const int pos = n + block_rank(mine, warp_counts, added);
    if (mine) store(pos, it);
    n += added;
  }
  take(n);
}

// A block's shared memory: the staged table's kSlots slots and a list of
// up to kList of its own items (Owned), filled by gather_owned.
template <int kSlots, int kList, int kWarps>
struct OwnedList {
  unsigned long long keys[kSlots];
  uint32_t mask[kSlots + 1];
  uint32_t q_hi[kList];
  uint32_t q_lo[kList];
  int32_t q_cls[kList];
  int32_t q_idx[kList];
  int warp_counts[kWarps];

  __device__ __forceinline__ KeyMaskTable table() {
    return KeyMaskTable{keys, mask, kSlots};
  }

  template <typename Own, typename Take>
  __device__ __forceinline__ void gather(int B, Own own, Take take) {
    gather_owned<kList, Owned>(
        B, warp_counts, own,
        [&](int pos, const Owned& it) {
          q_hi[pos] = it.hi;
          q_lo[pos] = it.lo;
          q_cls[pos] = it.cls;
          q_idx[pos] = it.idx;
        },
        take);
  }
};

}  // namespace repro_torch
