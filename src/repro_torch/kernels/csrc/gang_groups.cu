// K5: grouped all-or-nothing gang record.
//
// Replaces: src/repro/kernels/witness_record.py gang_record_groups_pallas
//   (_make_gang_groups_kernel), reached through ops.gang_record_groups.
// Bound on the card: latency.  Groups must resolve in index order (each
//   probes the table as earlier groups left it), so the work is a chain of
//   G dependent steps of K row probes each; at G = 1, the single-op record
//   path, the bytes are a few hundred and a launch costs its fixed latency.
// Design: one block runs the groups in order, and a group costs one trip
//   to the table.
//   - The small operands are staged once, in tiles of up to 1024 keys and
//     256 groups: a thread loads a key's lanes, validity and class and its
//     group's lane, hashes the key, writes q_hi/q_lo out (never read back)
//     and keeps the mixed lanes, the row (-1 for a key that is not valid)
//     and the class in shared memory; a group's rpc, lane and validity go
//     there too, and the class matrix once per launch.
//   - One thread per (key, way) loads that way's five words (occ, hi, lo,
//     rpc hi, rpc lo) together.  A key is a DUP on a same-key way under the
//     group's rpc, a CONFLICT on a same-key way under another rpc whose
//     class its matrix row has; its rank is the number of the group's
//     earlier keys that claim a way (valid, not a DUP) in its row, and it
//     takes the free way with exactly rank free ways below it.  The
//     verdict (all or nothing; 2 if every valid key is a DUP, 1 on accept,
//     else 3 or 4 from the first failing key) is a reduction, not a loop.
//   - On accept the thread that holds each chosen way writes its six words
//     (occ = 1 + class, age 0) and the counter of the group's lane and
//     reason takes an atomicAdd.  The Pallas write pass writes in key
//     order, so where two keys of a group choose one way (a key repeated
//     as a DUP, under two classes), the later key wins: a key writes only
//     if no later valid key of its group has the same (row, way).
//   - One warp, when Kp x W <= 32 (every lone op: Kp = 2, W = 4): a key's
//     DUP, CONFLICT and free masks are segments of warp ballots, its rank a
//     popc of __match_any_sync over the rows, the write check a match over
//     the chosen slots, and __syncwarp orders a group's writes before the
//     next group's probe; no block barrier.
//   - Otherwise a block of up to 1024 threads (one a key at least): the
//     per-key flags and free bitmaps are shared words set by atomics, a
//     thread a key then decides (its rank and write check by a walk of the
//     group's rows in shared memory), and __syncthreads separates probe,
//     decision and writes.
//   K is at most 1024.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kTileKeys = 1024;
constexpr int kTileGroups = 256;
constexpr int kMaxClasses = 64;
constexpr int kMaxThreads = 1024;
constexpr int kStaticShared = 48 * 1024;

struct Args {
  int G, K;
  const uint32_t* __restrict__ k_hi;
  const uint32_t* __restrict__ k_lo;
  const int32_t* __restrict__ k_valid;
  const int32_t* __restrict__ k_cls;
  const int32_t* __restrict__ lanes;
  const uint32_t* __restrict__ r_hi;
  const uint32_t* __restrict__ r_lo;
  const int32_t* __restrict__ g_valid;
  const int32_t* __restrict__ matrix;
  int n_cls, n_sets, W;
  uint32_t* t_hi;
  uint32_t* t_lo;
  int32_t* t_occ;
  uint32_t* t_rh;
  uint32_t* t_rl;
  int32_t* t_age;
  int32_t* __restrict__ reasons;
  uint32_t* __restrict__ q_hi;
  uint32_t* __restrict__ q_lo;
  int32_t* counters;
};

// The staged operands of one tile of groups.
struct Tile {
  uint32_t qh[kTileKeys];
  uint32_t ql[kTileKeys];
  int32_t row[kTileKeys];  // -1: the key is not valid
  int32_t cls[kTileKeys];
  uint32_t rh[kTileGroups];
  uint32_t rl[kTileGroups];
  int32_t lane[kTileGroups];
  int32_t gv[kTileGroups];
  int32_t matrix[kMaxClasses];
};

template <bool kOneWarp>
__device__ __forceinline__ void block_sync() {
  if (kOneWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ void stage(const Args& a, Tile& s, int g0, int tg) {
  for (int i = threadIdx.x; i < tg * a.K; i += blockDim.x) {
    const int64_t e = static_cast<int64_t>(g0) * a.K + i;
    const int g = g0 + i / a.K;
    const uint32_t kh = a.k_hi[e], kl = a.k_lo[e];
    const int32_t valid = a.k_valid[e], cls = a.k_cls[e], lane = a.lanes[g];
    uint32_t h, l;
    keyhash2x32(kh, kl, h, l);
    a.q_hi[e] = h;
    a.q_lo[e] = l;
    s.qh[i] = h;
    s.ql[i] = l;
    s.row[i] = valid == 1
        ? lane * a.n_sets + static_cast<int32_t>(l & (a.n_sets - 1)) : -1;
    s.cls[i] = cls;
  }
  for (int j = threadIdx.x; j < tg; j += blockDim.x) {
    s.rh[j] = a.r_hi[g0 + j];
    s.rl[j] = a.r_lo[g0 + j];
    s.lane[j] = a.lanes[g0 + j];
    s.gv[j] = a.g_valid[g0 + j];
  }
}

__device__ __forceinline__ void write_way(const Args& a, int64_t slot,
                                          uint32_t h, uint32_t l, int32_t cls,
                                          uint32_t rc, uint32_t rs) {
  a.t_hi[slot] = h;
  a.t_lo[slot] = l;
  a.t_occ[slot] = 1 + cls;
  a.t_rh[slot] = rc;
  a.t_rl[slot] = rs;
  a.t_age[slot] = 0;
}

// One group on one warp (K x W <= 32): lane t holds way t % W of key t / W.
__device__ void group_one_warp(const Args& a, const Tile& s, int j, int g) {
  const int t = threadIdx.x;
  const int W = a.W;
  const int k = t / W, w = t - k * W;
  const int e = j * a.K + k;
  const uint32_t rc = s.rh[j], rs = s.rl[j];
  const int32_t row = k < a.K ? s.row[e] : -1;
  const bool valid = row >= 0;
  const int64_t slot = static_cast<int64_t>(row) * W + w;
  bool dup = false, conf = false, free = false;
  uint32_t h = 0, l = 0;
  int32_t cls = 0;
  if (valid) {
    h = s.qh[e];
    l = s.ql[e];
    cls = s.cls[e];
    const int32_t o = a.t_occ[slot];
    const uint32_t kh = a.t_hi[slot], kl = a.t_lo[slot];
    const uint32_t wh = a.t_rh[slot], wl = a.t_rl[slot];
    const bool keym = o > 0 && kh == h && kl == l;
    const bool rpcm = wh == rc && wl == rs;
    dup = keym && rpcm;
    conf = keym && !rpcm
           && matrix_bit(matrix_row(s.matrix, a.n_cls, cls), o - 1);
    free = o == 0;
  }
  const unsigned seg = !valid ? 0u
      : (W == 32 ? kAll : ((1u << W) - 1u) << (k * W));
  const unsigned below = (1u << t) - 1u;  // t < 32
  const unsigned dup_m = __ballot_sync(kAll, dup) & seg;
  const unsigned conf_m = __ballot_sync(kAll, conf) & seg;
  const unsigned free_m = __ballot_sync(kAll, free) & seg;
  const bool dup_k = dup_m != 0u, conf_k = conf_m != 0u;
  const bool claim = valid && !dup_k;
  const unsigned lead = __ballot_sync(kAll, valid && w == 0);
  const unsigned claims = __ballot_sync(kAll, claim && w == 0);
  const unsigned same_row = __match_any_sync(kAll, row);
  const int rank = __popc(same_row & claims & ((1u << (k * W)) - 1u));
  const bool ok = !conf_k && (dup_k || __popc(free_m) > rank);
  const unsigned fails = __ballot_sync(kAll, valid && !ok && w == 0);
  const unsigned confs = __ballot_sync(kAll, conf_k && w == 0);
  int reason;
  if (fails == 0u) {
    reason = (claims == 0u && lead != 0u) ? 2 : 1;
    const bool chosen = dup_k ? dup && (dup_m & below) == 0u
                              : free && __popc(free_m & below) == rank;
    // The later of two keys that chose one slot writes it: match on the
    // slot (a lane that writes nothing keys on its own lane).
    const long long key = chosen ? static_cast<long long>(slot) : -1 - t;
    const unsigned same_slot = __match_any_sync(kAll, key);
    if (chosen && (same_slot >> t) == 1u) {
      write_way(a, slot, h, l, cls, rc, rs);
    }
  } else {
    reason = (confs >> (__ffs(fails) - 1)) & 1u ? 3 : 4;
  }
  if (t == 0) {
    a.reasons[g] = reason;
    if (a.counters != nullptr) {
      atomicAdd(a.counters + s.lane[j] * 5 + reason, 1);
    }
  }
}

// Per-key words of the block path, in dynamic shared memory.
struct KeyFlags {
  int32_t* dup_way;   // [K] first DUP way, W if none
  int32_t* conf;      // [K] 1 on a CONFLICT way
  uint32_t* free;     // [K * FW] free-way bitmap
  int FW;
};

// One group on the block: probe, decide, write, a barrier after each.
// ``red`` holds the group's reductions (the first failing key as 2k + its
// CONFLICT bit, any claim, any valid key), two sets used by alternate
// groups so that one is reset while the other is read.
__device__ void group_block(const Args& a, const Tile& s, KeyFlags f,
                            int32_t (*red)[3], int j, int g, int parity) {
  const int W = a.W, K = a.K;
  const int e0 = j * K;
  const uint32_t rc = s.rh[j], rs = s.rl[j];
  for (int p = threadIdx.x; p < K * W; p += blockDim.x) {
    const int k = p / W, w = p - k * W;
    const int32_t row = s.row[e0 + k];
    if (row < 0) continue;
    const int64_t slot = static_cast<int64_t>(row) * W + w;
    const int32_t o = a.t_occ[slot];
    const uint32_t kh = a.t_hi[slot], kl = a.t_lo[slot];
    const uint32_t wh = a.t_rh[slot], wl = a.t_rl[slot];
    const bool keym = o > 0 && kh == s.qh[e0 + k] && kl == s.ql[e0 + k];
    const bool rpcm = wh == rc && wl == rs;
    if (keym && rpcm) atomicMin(f.dup_way + k, w);
    if (keym && !rpcm
        && matrix_bit(matrix_row(s.matrix, a.n_cls, s.cls[e0 + k]), o - 1)) {
      f.conf[k] = 1;
    }
    if (o == 0) atomicOr(f.free + k * f.FW + (w >> 5), 1u << (w & 31));
  }
  __syncthreads();
  const int k = threadIdx.x;  // blockDim.x >= K
  int32_t row = -1, way = -1;
  bool dup = false, superseded = false;
  if (k < K) {
    row = s.row[e0 + k];
    if (row >= 0) {
      const int32_t dup_way = f.dup_way[k];
      dup = dup_way < W;
      int rank = 0;
      for (int i = 0; i < K; ++i) {
        if (i == k || s.row[e0 + i] != row) continue;
        if (i < k) {
          rank += f.dup_way[i] == W;
        } else if (dup && f.dup_way[i] == dup_way) {
          superseded = true;  // a later DUP of the same way writes it
        }
      }
      int n_free = 0;
      for (int i = 0; i < f.FW; ++i) n_free += __popc(f.free[k * f.FW + i]);
      const bool ok = !f.conf[k] && (dup || n_free > rank);
      if (!ok) atomicMin(&red[parity][0], 2 * k + f.conf[k]);
      if (!dup) atomicOr(&red[parity][1], 1);
      atomicOr(&red[parity][2], 1);
      if (dup) {
        way = dup_way;
      } else if (ok) {  // the free way with rank free ways below it
        for (int i = 0, left = rank; i < f.FW; ++i) {
          uint32_t x = f.free[k * f.FW + i];
          const int n = __popc(x);
          if (left < n) {
            for (; left > 0; --left) x &= x - 1u;
            way = 32 * i + __ffs(x) - 1;
            break;
          }
          left -= n;
        }
      }
    }
  }
  __syncthreads();
  const int32_t first = red[parity][0];
  int reason;
  if (first == INT_MAX) {
    reason = (red[parity][1] == 0 && red[parity][2] != 0) ? 2 : 1;
    if (row >= 0 && !superseded) {
      write_way(a, static_cast<int64_t>(row) * W + way, s.qh[e0 + k],
                s.ql[e0 + k], s.cls[e0 + k], rc, rs);
    }
  } else {
    reason = (first & 1) ? 3 : 4;
  }
  if (k < K) {
    f.dup_way[k] = W;
    f.conf[k] = 0;
    for (int i = 0; i < f.FW; ++i) f.free[k * f.FW + i] = 0u;
  }
  if (k == 0) {
    red[parity ^ 1][0] = INT_MAX;
    red[parity ^ 1][1] = 0;
    red[parity ^ 1][2] = 0;
    a.reasons[g] = reason;
    if (a.counters != nullptr) {
      atomicAdd(a.counters + s.lane[j] * 5 + reason, 1);
    }
  }
  __syncthreads();
}

template <bool kOneWarp>
__global__ void gang_groups_kernel(Args a) {
  __shared__ Tile s;
  __shared__ int32_t red[2][3];
  extern __shared__ int32_t dyn[];
  KeyFlags f{dyn, dyn + a.K, reinterpret_cast<uint32_t*>(dyn + 2 * a.K),
             (a.W + 31) / 32};
  for (int i = threadIdx.x; i < a.n_cls; i += blockDim.x) {
    s.matrix[i] = a.matrix[i];
  }
  if (!kOneWarp) {
    for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
      f.dup_way[k] = a.W;
      f.conf[k] = 0;
      for (int i = 0; i < f.FW; ++i) f.free[k * f.FW + i] = 0u;
    }
    if (threadIdx.x < 2) {
      red[threadIdx.x][0] = INT_MAX;
      red[threadIdx.x][1] = 0;
      red[threadIdx.x][2] = 0;
    }
  }
  const int per_tile =
      a.K > 0 ? max(1, min(kTileGroups, kTileKeys / a.K)) : kTileGroups;
  int parity = 0;
  for (int g0 = 0; g0 < a.G; g0 += per_tile) {
    const int tg = min(per_tile, a.G - g0);
    stage(a, s, g0, tg);
    block_sync<kOneWarp>();
    for (int j = 0; j < tg; ++j) {
      const int g = g0 + j;
      if (s.gv[j] != 1) {  // uniform across the block
        if (threadIdx.x == 0) a.reasons[g] = 0;
        continue;
      }
      if (kOneWarp) {
        group_one_warp(a, s, j, g);
        __syncwarp();
      } else {
        group_block(a, s, f, red, j, g, parity);
        parity ^= 1;
      }
    }
    block_sync<kOneWarp>();  // the tile is read before the next is staged
  }
}

}  // namespace

extern "C" int gang_groups_launch(int G, int K, const void* k_hi,
                                  const void* k_lo, const void* k_valid,
                                  const void* k_cls, const void* lanes,
                                  const void* r_hi, const void* r_lo,
                                  const void* g_valid, const void* matrix,
                                  int n_cls, int n_sets, int W, void* t_hi,
                                  void* t_lo, void* t_occ, void* t_rh,
                                  void* t_rl, void* t_age, void* reasons,
                                  void* q_hi, void* q_lo, void* counters,
                                  void* stream) {
  if (G <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 0 || K > kTileKeys || n_cls > kMaxClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{G, K,
               static_cast<const uint32_t*>(k_hi),
               static_cast<const uint32_t*>(k_lo),
               static_cast<const int32_t*>(k_valid),
               static_cast<const int32_t*>(k_cls),
               static_cast<const int32_t*>(lanes),
               static_cast<const uint32_t*>(r_hi),
               static_cast<const uint32_t*>(r_lo),
               static_cast<const int32_t*>(g_valid),
               static_cast<const int32_t*>(matrix), n_cls, n_sets, W,
               static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
               static_cast<int32_t*>(t_occ), static_cast<uint32_t*>(t_rh),
               static_cast<uint32_t*>(t_rl), static_cast<int32_t*>(t_age),
               static_cast<int32_t*>(reasons), static_cast<uint32_t*>(q_hi),
               static_cast<uint32_t*>(q_lo), static_cast<int32_t*>(counters)};
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t pairs = static_cast<int64_t>(K) * W;
  if (pairs <= 32) {
    gang_groups_kernel<true><<<1, 32, 0, s>>>(a);
  } else {
    const int threads =
        pairs >= kMaxThreads ? kMaxThreads
                             : static_cast<int>((pairs + 31) / 32 * 32);
    const size_t dyn = static_cast<size_t>(K) * (2 + (W + 31) / 32) * 4;
    if (dyn + sizeof(Tile) > kStaticShared) {
      const cudaError_t err = cudaFuncSetAttribute(
          gang_groups_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dyn));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gang_groups_kernel<false><<<1, threads, dyn, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
