// K9: the transactional probe, the all-or-nothing record of ONE op's keys.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_txn_pallas
//   (_record_txn_kernel), reached through ops.txn_probe (_txn_probe_impl,
//   which runs K1's mix before it).
// Bound on the card: latency.  One op has K <= 1024 keys (16 at the
//   smallest bucket); it reads K key pairs and K rows of W ways and writes
//   at most K slots, a few hundred bytes: the launch's fixed cost and two
//   dependent trips to memory (the operands, then the rows) are the whole
//   time.
// Design: one launch, one trip to the table, ranks from warp votes.
//   - Each key owns `lpk` consecutive lanes of a warp (a power of two, at
//     most 32), and lane j of a key holds ways [j * c, (j + 1) * c) of its
//     set, c = ceil(W / lpk): it mixes the raw key (keyhash.cuh, the mix
//     K1 runs) and loads each of its ways' occ, hi and lo together, keeping
//     a hit bit and the ways' free bits in registers.  A key that is not
//     valid probes nothing.
//   - A key's hit is a ballot over its lanes; its free ways below each lane
//     a shuffle scan of the lanes' free counts.
//   - A key's rank is the number of earlier claiming keys (valid, no hit)
//     in its set: inside a warp a popc of __match_any_sync on the set over
//     the claiming keys below it; across warps the counts of the earlier
//     warps that hold its set.  The first claiming key of each set in a
//     warp claims the set's slot in a shared-memory KeyMaskTable
//     (smem_join.cuh) and pushes (warp, count) onto the slot's list; the
//     warp's other keys of that set take the slot by a shuffle, and after
//     a barrier each claiming key walks its set's list, one node per warp
//     that holds the set (one, for keys in distinct sets).  A lookup per
//     earlier warp, keyed by (set, warp), measured 0.0341 ms at K = 1024
//     in distinct sets, slower than the parent's walk over every earlier
//     key (0.0267; scripts/torch_kernel_times.py, one H100 80GB HBM3 at
//     700 W).
//   - It seats if its set has more free ways than its rank, and its way is
//     the free way with exactly rank free ways below it, found by the lane
//     that holds it from the free bits in its registers (occ is not read
//     again).  ok = own ? hit | seat : !hit & seat, true for a key that is
//     not valid; the op's verdict is __all_sync on one warp and
//     __syncthreads_and on a block, which is also the point that orders
//     every probe before any write, so a rejected op writes nothing and the
//     table stays bit-identical.
//   - On accept the lane holding each reserved way writes it (keys, occ =
//     1).  The reserved ways of one set are distinct, a key repeated in the
//     op included (both copies claim, at ranks r and r + 1), so the writes
//     need no order and leave what the Pallas kernel's ordered write loop
//     leaves.
//   - One warp while each lane holds at most kFew ways (K x W = 16 x 4,
//     the padded path shape, is 2 lanes a key, 2 ways a lane): no block
//     barrier.  Otherwise a block of up to 1024 threads, lpk = min(32,
//     W rounded up to a power of two, 1024 / K rounded up), with three
//     barriers: the cleared table, the staged lists, the verdict.
//   K is at most 1024 and a lane holds at most kWords x 64 ways, so W is
//   at most 256.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxKeys = 1024;
constexpr int kSlots = 2 * kMaxKeys;  // the claiming keys' sets, at most K
constexpr int kWords = 4;             // a lane's free bits: up to 256 ways
constexpr int kFew = 4;               // ways a lane holds on the one-warp path

struct Args {
  int K;
  const uint32_t* __restrict__ k_hi;
  const uint32_t* __restrict__ k_lo;
  const int32_t* __restrict__ own;
  const int32_t* __restrict__ valid;
  int S, W, lpk, c, cap;
  uint32_t* t_hi;
  uint32_t* t_lo;
  int32_t* t_occ;
  int32_t* __restrict__ acc;
  int32_t* __restrict__ hit_out;
  uint32_t* __restrict__ q_hi;
  uint32_t* __restrict__ q_lo;
};

template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxThreads) txn_probe_kernel(Args a) {
  // The block path's sets: set -> the head of a list of (warp, count)
  // nodes, node t + 1 for the leader thread t of a set in its warp.
  __shared__ unsigned long long keys[kOneWarp ? 1 : kSlots];
  __shared__ uint32_t head[kOneWarp ? 1 : kSlots + 1];
  __shared__ int32_t node_count[kOneWarp ? 1 : kMaxThreads];
  __shared__ uint32_t node_next[kOneWarp ? 1 : kMaxThreads];
  KeyMaskTable sets{keys, head, a.cap};
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int lpk = a.lpk;
  const int k = t / lpk, j = t & (lpk - 1);
  const int lane0 = lane & ~(lpk - 1);
  const bool mine = k < a.K;

  // The operands, then the key's ways: one trip each.
  bool v = false, own = false;
  uint32_t h = 0, l = 0;
  int32_t set = 0;
  if (mine) {
    v = a.valid[k] == 1;
    own = a.own[k] == 1;
    keyhash2x32(a.k_hi[k], a.k_lo[k], h, l);
    set = static_cast<int32_t>(l & static_cast<uint32_t>(a.S - 1));
  }
  const int w0 = j * a.c;
  const int n = v ? max(0, min(a.c, a.W - w0)) : 0;
  const int64_t row = static_cast<int64_t>(set) * a.W + w0;
  uint64_t fm[kWords];
  bool hit_l = false;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    fm[q] = 0;
    const int m = min(64, n - 64 * q);
#pragma unroll 4
    for (int b = 0; b < m; ++b) {
      const int64_t s = row + 64 * q + b;
      const int32_t o = a.t_occ[s];
      const uint32_t kh = a.t_hi[s], kl = a.t_lo[s];
      hit_l |= o > 0 && kh == h && kl == l;
      fm[q] |= static_cast<uint64_t>(o == 0) << b;
    }
  }
  if (!kOneWarp) {
    sets.clear();
    __syncthreads();
  }

  // The key's hit, free ways and rank.
  const unsigned group = lpk == 32 ? kAllLanes : ((1u << lpk) - 1u) << lane0;
  const bool hit = (__ballot_sync(kAllLanes, hit_l) & group) != 0u;
  int nf = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) nf += __popcll(fm[q]);
  int below = nf;  // inclusive scan of the key's lanes' free counts
  for (int d = 1; d < lpk; d *= 2) {
    const int x = __shfl_up_sync(kAllLanes, below, d, lpk);
    if (j >= d) below += x;
  }
  const int n_free = __shfl_sync(kAllLanes, below, lpk - 1, lpk);
  below -= nf;
  const bool claim = v && !hit;
  const unsigned leads = __ballot_sync(kAllLanes, j == 0);
  const unsigned same =
      __match_any_sync(kAllLanes, claim ? set : -1 - lane) & leads;
  int rank = __popc(same & ((1u << lane0) - 1u));
  if (!kOneWarp) {
    // The first claiming key of each set in a warp pushes the warp's count
    // for the set onto the set's list; after the barrier a claiming key
    // adds the counts of the earlier warps on its set's list.
    const int leader = claim ? __ffs(same) - 1 : lane;
    int slot = 0;
    if (claim && lane == leader) {
      slot = sets.insert(static_cast<uint64_t>(set));
      node_count[t] = __popc(same);
      node_next[t] = atomicExch(&head[slot], static_cast<uint32_t>(t + 1));
    }
    slot = __shfl_sync(kAllLanes, slot, leader);
    __syncthreads();
    if (claim) {
      for (uint32_t n = head[slot]; n != 0u; n = node_next[n - 1]) {
        if (static_cast<int>((n - 1) >> 5) < warp) rank += node_count[n - 1];
      }
    }
  }
  const bool seat = n_free > rank;
  const bool ok = !v || (own ? hit || seat : !hit && seat);
  const bool accepted =
      kOneWarp ? __all_sync(kAllLanes, ok) != 0 : __syncthreads_and(ok) != 0;

  // Every probe happened before the verdict; every write after it.
  if (accepted && claim) {
    int left = rank - below;
    if (left >= 0 && left < nf) {
      int way = w0;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int m = __popcll(fm[q]);
        if (left >= 0 && left < m) {
          uint64_t x = fm[q];
          for (; left > 0; --left) x &= x - 1;
          way += 64 * q + __ffsll(static_cast<long long>(x)) - 1;
          left = -1;
        } else if (left >= 0) {
          left -= m;
        }
      }
      const int64_t s = static_cast<int64_t>(set) * a.W + way;
      a.t_hi[s] = h;
      a.t_lo[s] = l;
      a.t_occ[s] = 1;
    }
  }
  if (mine && j == 0) {
    a.q_hi[k] = h;
    a.q_lo[k] = l;
    a.hit_out[k] = hit && v;
  }
  if (t == 0) a.acc[0] = accepted;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

}  // namespace

// K is the padded key count (at most 1024); W at most kWords x 64.
extern "C" int txn_probe_launch(int K, const void* k_hi, const void* k_lo,
                                const void* own, const void* valid, int S,
                                int W, void* t_hi, void* t_lo, void* t_occ,
                                void* acc, void* hit, void* q_hi, void* q_lo,
                                void* stream) {
  if (K < 0 || K > kMaxKeys || W < 1 || W > kWords * 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kp = pow2_at_least(K > 0 ? K : 1);
  const int wp = pow2_at_least(W);
  Args a{K,
         static_cast<const uint32_t*>(k_hi),
         static_cast<const uint32_t*>(k_lo),
         static_cast<const int32_t*>(own),
         static_cast<const int32_t*>(valid),
         S, W, 1, W, 2,
         static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
         static_cast<int32_t*>(t_occ), static_cast<int32_t*>(acc),
         static_cast<int32_t*>(hit), static_cast<uint32_t*>(q_hi),
         static_cast<uint32_t*>(q_lo)};
  auto s = static_cast<cudaStream_t>(stream);
  if (kp <= 32) {
    a.lpk = wp < 32 / kp ? wp : 32 / kp;
    a.c = (W + a.lpk - 1) / a.lpk;
  }
  if (kp <= 32 && a.c <= kFew) {
    txn_probe_kernel<true><<<1, 32, 0, s>>>(a);
  } else {
    a.lpk = wp < kMaxThreads / kp ? wp : kMaxThreads / kp;
    if (a.lpk > 32) a.lpk = 32;
    a.c = (W + a.lpk - 1) / a.lpk;
    a.cap = 2 * kp;
    const int threads = K > 0 ? (K * a.lpk + 31) / 32 * 32 : 32;
    txn_probe_kernel<false><<<1, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
