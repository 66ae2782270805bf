// K3: the fused cluster batch, the stages before the witness record.
//
// Replaces: src/repro/kernels/ops.py _gang_fastpath_impl (plain XLA around
//   the K2 pallas_call, reached through ops.gang_fastpath_batch): hash ->
//   slot route -> ring conflict scan -> in-batch conflict check -> ring
//   append.  The record at every shard's f witness lanes then runs on the
//   K2 kernel (gang_record.cu) with rep = f.
// Bound on the card: latency and L2 traffic, not operations.  Each op scans
//   its shard's live ring span (at most CAP = 1024 entries of three int32
//   rings) and the earlier ops of its batch (the triangular test, B^2 / 2
//   pairs); at B = 1024 that is about a million cached loads, a few
//   microseconds, against a launch latency of the same order.
// Design: one thread per op, in two launches so that every op's hash and
//   shard are in memory before any op compares itself with earlier ones.
//   Ring writes go only to slots beyond each shard's live span (the driver
//   guarantees count + appends <= CAP), which no thread reads, so the scan
//   and the append share one launch.  A thread's append position is
//   tail + count + rank, rank counting the earlier executing ops of its
//   shard, exactly as the JAX version; the new per-shard counts are
//   accumulated with atomics into a copy of the old ones.  The ring's
//   over-approximation (mixed-lane collisions, predicted executions) is
//   reproduced, not tightened.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int ring_pos(int64_t x, int cap) {
  const int64_t r = x % cap;
  return static_cast<int>(r < 0 ? r + cap : r);
}

__global__ void fastpath_route_kernel(
    int B, const uint32_t* __restrict__ k_hi, const uint32_t* __restrict__ k_lo,
    const int32_t* __restrict__ k_valid, const int32_t* __restrict__ slot_map,
    int n_slots, const int32_t* __restrict__ lane_map, int f, int n_sets,
    int n_rows, uint32_t* __restrict__ q_hi, uint32_t* __restrict__ q_lo,
    int32_t* __restrict__ shard, int32_t* __restrict__ rows_e) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t h, l;
  keyhash2x32(k_hi[b], k_lo[b], h, l);
  q_hi[b] = h;
  q_lo[b] = l;
  const int32_t s = slot_map[l % static_cast<uint32_t>(n_slots)];
  shard[b] = s;
  const int32_t set = static_cast<int32_t>(l & (n_sets - 1));
  const bool valid = k_valid[b] == 1;
  for (int j = 0; j < f; ++j)
    rows_e[b * f + j] = valid ? lane_map[s * f + j] * n_sets + set : n_rows;
}

__global__ void fastpath_window_kernel(
    int B, const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    const int32_t* __restrict__ shard, const int32_t* __restrict__ k_cls,
    const int32_t* __restrict__ k_valid, const int32_t* __restrict__ exec_pred,
    const int32_t* __restrict__ matrix, int n_cls, uint32_t* ring_hi,
    uint32_t* ring_lo, int32_t* ring_cls, int cap,
    const int32_t* __restrict__ tail, const int32_t* __restrict__ count,
    int32_t* __restrict__ conflicts, int32_t* new_count) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t s = shard[b];
  const uint32_t h = q_hi[b], l = q_lo[b];
  const int32_t cls = k_cls[b];
  const bool valid = k_valid[b] == 1;
  const int32_t mrow = matrix_row(matrix, n_cls, cls);
  const int32_t t = tail[s], n = count[s];
  const int64_t row = static_cast<int64_t>(s) * cap;
  // Live span: slot c is live iff (c - tail) % CAP < count, i.e. the slots
  // (tail + k) % CAP for k < count.
  bool hit = false;
  for (int k = 0; k < n && k < cap && !hit; ++k) {
    const int64_t c = row + ring_pos(static_cast<int64_t>(t) + k, cap);
    hit = ring_hi[c] == h && ring_lo[c] == l && matrix_bit(mrow, ring_cls[c]);
  }
  // Earlier ops of the same shard that will execute: conflict on the same
  // key (matrix permitting) and count toward this op's append rank.
  bool intra = false;
  int rank = 0;
  for (int j = 0; j < b; ++j) {
    if (exec_pred[j] != 1 || k_valid[j] != 1 || shard[j] != s) continue;
    ++rank;
    if (q_hi[j] == h && q_lo[j] == l && matrix_bit(mrow, k_cls[j]))
      intra = true;
  }
  conflicts[b] = (valid && (hit || intra)) ? 1 : 0;
  if (valid && exec_pred[b] == 1) {
    const int64_t c =
        row + ring_pos(static_cast<int64_t>(t) + n + rank, cap);
    ring_hi[c] = h;
    ring_lo[c] = l;
    ring_cls[c] = cls;
    atomicAdd(&new_count[s], 1);
  }
}

}  // namespace

extern "C" int gang_fastpath_route(int B, const void* k_hi, const void* k_lo,
                                   const void* k_valid, const void* slot_map,
                                   int n_slots, const void* lane_map, int f,
                                   int n_sets, int n_rows, void* q_hi,
                                   void* q_lo, void* shard, void* rows_e,
                                   void* stream) {
  if (B > 0) {
    fastpath_route_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(k_hi),
        static_cast<const uint32_t*>(k_lo),
        static_cast<const int32_t*>(k_valid),
        static_cast<const int32_t*>(slot_map), n_slots,
        static_cast<const int32_t*>(lane_map), f, n_sets, n_rows,
        static_cast<uint32_t*>(q_hi), static_cast<uint32_t*>(q_lo),
        static_cast<int32_t*>(shard), static_cast<int32_t*>(rows_e));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gang_fastpath_window(int B, const void* q_hi, const void* q_lo,
                                    const void* shard, const void* k_cls,
                                    const void* k_valid, const void* exec_pred,
                                    const void* matrix, int n_cls,
                                    void* ring_hi, void* ring_lo,
                                    void* ring_cls, int cap, const void* tail,
                                    const void* count, void* conflicts,
                                    void* new_count, void* stream) {
  if (B > 0) {
    fastpath_window_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), static_cast<const int32_t*>(shard),
        static_cast<const int32_t*>(k_cls),
        static_cast<const int32_t*>(k_valid),
        static_cast<const int32_t*>(exec_pred),
        static_cast<const int32_t*>(matrix), n_cls,
        static_cast<uint32_t*>(ring_hi), static_cast<uint32_t*>(ring_lo),
        static_cast<int32_t*>(ring_cls), cap,
        static_cast<const int32_t*>(tail), static_cast<const int32_t*>(count),
        static_cast<int32_t*>(conflicts), static_cast<int32_t*>(new_count));
  }
  return static_cast<int>(cudaGetLastError());
}
