// K3: the fused cluster batch, the stages before the witness record, in
// one launch.
//
// Replaces: src/repro/kernels/ops.py _gang_fastpath_impl (:787-861, plain
//   XLA around the K2 pallas_call, reached through ops.gang_fastpath_batch
//   at :864): hash -> slot route -> ring conflict scan -> in-batch
//   conflict check -> ring append.  The record at every shard's f witness
//   lanes then runs on the K2 kernel (gang_record.cu) with rep = f.
// Bound on the card: latency.  A batch of 1024 ops reads 24 KB of operands
//   and its shards' live ring spans (at most 12 KB each), and a join needs a
//   few compares per op; what costs is dependent loads.  The earlier design
//   (two launches, one thread per op on 4 of 132 SMs) walked each op's ring
//   span through uncoalesced loads and every earlier op of the batch (the
//   triangular B^2 / 2 test, six global loads a pair) to find the few of its
//   own shard.
// Design: a block per shard.  Every block reads the whole batch coalesced,
//   mixes and routes it (slot_map[lo % n_slots]) and keeps the valid ops of
//   its own shard in batch order (OwnedList, smem_join.cuh); it writes
//   q_hi, q_lo, shard and the f record rows of every op it owns (row
//   lane_map[s, j] * n_sets + (lo & (n_sets - 1)), or n_rows for padding,
//   which neither conflicts nor appends).  The shard's live span, slots
//   (tail + k) % CAP for k < count, is staged once, coalesced, into a
//   shared-memory KeyMaskTable (key -> OR of 1 << class), so a ring hit is
//   one probe.  The in-batch check and the append rank read only the
//   shard's own list: one warp walks it 32 ops at a time, each op OR-ing
//   the classes of earlier executing ops of its key (a second table keeps
//   them per key across steps, shuffles within a step) and counting earlier
//   executing ops with a ballot.  An executing op appends at
//   (tail + count + rank) % CAP, no atomics, and the block writes
//   new_count[s] = count[s] + appends.  A shard whose list outgrows the
//   block's buffer is taken in chunks: the appends of earlier chunks are
//   then part of the live span the next chunk stages, which is exactly the
//   in-batch test against them (same key, executing, class bit).  The
//   span's slots beyond count are free while count + appends <= CAP (the
//   wrapper's caller checks it), so the reads and the appends never meet.
//   The ring's over-approximation (mixed-lane collisions, predicted
//   executions) is reproduced, not tightened.  Ops whose slot names no
//   shard of the rings are written by block 0 as padding.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 1024;     // ops held per chunk (a multiple of kThreads)
constexpr int kTile = 1024;     // ring entries per staged table
constexpr int kSlots = 2 * kTile;  // also at least 2 * kList
constexpr int32_t kExec = 1 << 30;  // flag bit in q_idx: the op executes

using Shared = OwnedList<kSlots, kList, kWarps>;  // q_idx: | kExec | kHit

struct Args {
  int B;
  const uint32_t* __restrict__ k_hi;
  const uint32_t* __restrict__ k_lo;
  const int32_t* __restrict__ k_cls;
  const int32_t* __restrict__ k_valid;
  const int32_t* __restrict__ exec_pred;
  const int32_t* __restrict__ slot_map;
  int n_slots;
  const int32_t* __restrict__ lane_map;
  int f;
  int n_sets;
  int n_rows;
  const int32_t* __restrict__ matrix;
  int n_cls;
  uint32_t* ring_hi;
  uint32_t* ring_lo;
  int32_t* ring_cls;
  int NS;
  int cap;
  const int32_t* __restrict__ tail;
  const int32_t* __restrict__ count;
  uint32_t* __restrict__ q_hi;
  uint32_t* __restrict__ q_lo;
  int32_t* __restrict__ shard;
  int32_t* __restrict__ rows_e;
  int32_t* __restrict__ conflicts;
  int32_t* __restrict__ new_count;
};

__device__ __forceinline__ int64_t ring_slot(int s, int cap, int64_t k) {
  int64_t r = k % cap;
  if (r < 0) r += cap;
  return static_cast<int64_t>(s) * cap + r;
}

// The shard's chunk of n ops: ring hits over the live span (count plus
// the appends of earlier chunks), then one warp's ordered walk for the
// in-batch check, the ranks, the appends and the conflict bits.
__device__ void run_chunk(const Args& a, Shared& sm, KeyMaskTable& table,
                          int& appended_sm, int s, int64_t t, int64_t n0,
                          int n) {
  __syncthreads();  // the chunk's list is complete
  const int64_t appended = appended_sm;
  int64_t live = n0 + appended;  // (c - tail) % CAP < count, as slots
  live = live < 0 ? 0 : (live > a.cap ? a.cap : live);
  for (int64_t base = 0; base < live; base += kTile) {
    const int m = static_cast<int>(live - base < kTile ? live - base : kTile);
    table.clear();
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const int64_t c = ring_slot(s, a.cap, t + base + k);
      table.add(key64(a.ring_hi[c], a.ring_lo[c]), class_bit(a.ring_cls[c]));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t msk = table.lookup(key64(sm.q_hi[i], sm.q_lo[i]));
      if (msk & static_cast<uint32_t>(matrix_row(a.matrix, a.n_cls,
                                                 sm.q_cls[i])))
        sm.q_idx[i] |= kHit;
    }
    __syncthreads();  // no thread still probes this tile
  }
  table.clear();  // now: key -> classes of the chunk's earlier executing ops
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int64_t run = appended;  // executing ops of the shard before this step
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool active = i < n;
      uint32_t h = 0u, l = 0u, bits = 0u;
      int32_t cls = 0, idx = 0;
      int g = -1;
      bool exec = false;
      if (active) {
        h = sm.q_hi[i];
        l = sm.q_lo[i];
        cls = sm.q_cls[i];
        idx = sm.q_idx[i];
        exec = (idx & kExec) != 0;
        bits = exec ? class_bit(cls) : 0u;
        g = table.insert(key64(h, l));
      }
      __syncwarp();
      uint32_t earlier = active ? table.mask[g] : 0u;  // earlier steps
      for (int src = 0; src < 32; ++src) {             // earlier lanes
        const int gs = __shfl_sync(kAllLanes, g, src);
        const uint32_t bs = __shfl_sync(kAllLanes, bits, src);
        if (src < lane && gs == g) earlier |= bs;
      }
      const unsigned ex = __ballot_sync(kAllLanes, exec);
      const int64_t rank = run + __popc(ex & lanes_below());
      run += __popc(ex);
      __syncwarp();  // every lane has read the table before it grows
      if (bits != 0u) atomicOr(&table.mask[g], bits);
      if (active) {
        const int32_t mrow = matrix_row(a.matrix, a.n_cls, cls);
        const bool hit = (idx & kHit) != 0 ||
                         (earlier & static_cast<uint32_t>(mrow)) != 0u;
        const int b = idx & kPos;
        a.conflicts[b] = hit ? 1 : 0;
        if (exec) {
          const int64_t c = ring_slot(s, a.cap, t + n0 + rank);
          a.ring_hi[c] = h;
          a.ring_lo[c] = l;
          a.ring_cls[c] = cls;
        }
      }
      __syncwarp();
    }
    if (lane == 0) appended_sm = static_cast<int>(run);
  }
  __syncthreads();  // the list and the table are free for the next chunk
}

__global__ void __launch_bounds__(kThreads)
    gang_fastpath_kernel(const Args a) {
  __shared__ Shared sm;
  __shared__ int appended;  // executing ops of the shard in earlier chunks
  KeyMaskTable table = sm.table();
  const int s = blockIdx.x;
  const int64_t t = a.tail[s], n0 = a.count[s];
  if (threadIdx.x == 0) appended = 0;
  sm.gather(
      a.B,
      [&](int b, Owned& q) {
        keyhash2x32(a.k_hi[b], a.k_lo[b], q.hi, q.lo);
        const int32_t sh = a.slot_map[q.lo % static_cast<uint32_t>(a.n_slots)];
        const bool routed = sh >= 0 && sh < a.NS;
        if (sh != s && (routed || s != 0)) return false;
        const bool valid = routed && a.k_valid[b] == 1;
        a.q_hi[b] = q.hi;
        a.q_lo[b] = q.lo;
        a.shard[b] = sh;
        const int32_t set =
            static_cast<int32_t>(q.lo & static_cast<uint32_t>(a.n_sets - 1));
        for (int j = 0; j < a.f; ++j)
          a.rows_e[static_cast<int64_t>(b) * a.f + j] =
              valid ? a.lane_map[sh * a.f + j] * a.n_sets + set : a.n_rows;
        if (!valid) a.conflicts[b] = 0;
        q.cls = a.k_cls[b];
        q.idx = b | (valid && a.exec_pred[b] == 1 ? kExec : 0);
        return valid;
      },
      [&](int n) { run_chunk(a, sm, table, appended, s, t, n0, n); });
  if (threadIdx.x == 0)
    a.new_count[s] = static_cast<int32_t>(n0 + appended);
}

}  // namespace

extern "C" int gang_fastpath_launch(
    int B, const void* k_hi, const void* k_lo, const void* k_cls,
    const void* k_valid, const void* exec_pred, const void* slot_map,
    int n_slots, const void* lane_map, int f, int n_sets, int n_rows,
    const void* matrix, int n_cls, void* ring_hi, void* ring_lo,
    void* ring_cls, int NS, int cap, const void* tail, const void* count,
    void* q_hi, void* q_lo, void* shard, void* rows_e, void* conflicts,
    void* new_count, void* stream) {
  if (NS <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{B,
               static_cast<const uint32_t*>(k_hi),
               static_cast<const uint32_t*>(k_lo),
               static_cast<const int32_t*>(k_cls),
               static_cast<const int32_t*>(k_valid),
               static_cast<const int32_t*>(exec_pred),
               static_cast<const int32_t*>(slot_map),
               n_slots,
               static_cast<const int32_t*>(lane_map),
               f,
               n_sets,
               n_rows,
               static_cast<const int32_t*>(matrix),
               n_cls,
               static_cast<uint32_t*>(ring_hi),
               static_cast<uint32_t*>(ring_lo),
               static_cast<int32_t*>(ring_cls),
               NS,
               cap,
               static_cast<const int32_t*>(tail),
               static_cast<const int32_t*>(count),
               static_cast<uint32_t*>(q_hi),
               static_cast<uint32_t*>(q_lo),
               static_cast<int32_t*>(shard),
               static_cast<int32_t*>(rows_e),
               static_cast<int32_t*>(conflicts),
               static_cast<int32_t*>(new_count)};
  gang_fastpath_kernel<<<NS, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
