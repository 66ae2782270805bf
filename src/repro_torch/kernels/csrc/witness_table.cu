// K6 and K7: the single-table witness record, and the fused fast-path batch
// that hashes, routes, scans the window and records in one call.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_setpar_pallas
//   (K6: _make_record_kernel / _setpar_kernel_body, with ops._setpar_prep,
//   reached through ops.witness_record) and fastpath_record_scan_pallas
//   (K7: _make_fused_kernel, with the hash, route and prep of
//   ops._fastpath_impl, reached through ops.fastpath_batch).
// Bound on the card: latency, not bytes or operations.  A query reads its
//   set's W ways of three int32 planes (48 B at W = 4) and writes at most
//   one way; a batch of 8192 moves under a megabyte.  A launch costs its
//   fixed latency plus the longest same-set chain, which must run in order;
//   K7's window scan adds B * U compares (4M at B = 4096, U = 1024).
// Design: as K2 (gang_record.cu).  The TPU resolved "rounds" (the r-th
//   query of every set) as vector steps over a sorted batch.  Here a prep
//   launch writes each query's set (padding gets n_sets and sorts last), the
//   wrapper sorts by set with a stable torch.sort (plain tensor prep, as
//   _setpar_prep was plain XLA), and one thread per run of equal sets walks
//   its run in batch order.  Sets are independent, so threads never share a
//   table row.  Per query: a same-key way whose class bit is set in the
//   query's matrix row is a conflict; otherwise the query takes the first
//   free way with occ = 1 + class (a same-key record of a class that does
//   not conflict stays beside it); otherwise it is rejected.  There is no
//   rpc, no DUP and no age.  K7's prep also hashes the raw key lanes
//   (keyhash.cuh), routes through the slot map and scans the window
//   (window_scan.cuh): the window only, with no in-batch check and no
//   append (that is K3).

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "window_scan.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 128;

__global__ void witness_sets_kernel(int B, const uint32_t* __restrict__ q_lo,
                                    const int32_t* __restrict__ valid,
                                    int n_sets, int32_t* __restrict__ sets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  sets[i] = valid[i] == 1 ? static_cast<int32_t>(q_lo[i] & (n_sets - 1))
                          : n_sets;
}

__global__ void fastpath_prep_kernel(
    int B, const uint32_t* __restrict__ k_hi, const uint32_t* __restrict__ k_lo,
    const int32_t* __restrict__ k_cls, const int32_t* __restrict__ k_valid,
    const int32_t* __restrict__ slot_map, int n_slots,
    const int32_t* __restrict__ matrix, int n_cls,
    const uint32_t* __restrict__ w_hi, const uint32_t* __restrict__ w_lo,
    const int32_t* __restrict__ w_valid, int U, int n_sets,
    uint32_t* __restrict__ q_hi, uint32_t* __restrict__ q_lo,
    int32_t* __restrict__ shard, int32_t* __restrict__ sets,
    int32_t* __restrict__ conflicts) {
  __shared__ WindowTile tile;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  bool valid = false;
  uint32_t h = 0, l = 0;
  int32_t mrow = 0;
  if (active) {
    keyhash2x32(k_hi[b], k_lo[b], h, l);
    q_hi[b] = h;
    q_lo[b] = l;
    shard[b] = slot_map[l % static_cast<uint32_t>(n_slots)];
    valid = k_valid[b] == 1;
    sets[b] = valid ? static_cast<int32_t>(l & (n_sets - 1)) : n_sets;
    mrow = matrix_row(matrix, n_cls, k_cls[b]);
  }
  // Padding neither accepts nor hits.
  const bool hit =
      window_hit(tile, active && valid, h, l, mrow, w_hi, w_lo, w_valid, U);
  if (active) conflicts[b] = hit ? 1 : 0;
}

__global__ void witness_record_runs_kernel(
    int N, const int32_t* __restrict__ sets_sorted,
    const int64_t* __restrict__ perm, const uint32_t* __restrict__ q_hi,
    const uint32_t* __restrict__ q_lo, const int32_t* __restrict__ q_cls,
    const int32_t* __restrict__ matrix, int n_cls, int n_sets, int W,
    uint32_t* t_hi, uint32_t* t_lo, int32_t* t_occ,
    int32_t* __restrict__ accepted) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int32_t set = sets_sorted[j];
  if (set < 0 || set >= n_sets) return;
  if (j > 0 && sets_sorted[j - 1] == set) return;  // not a run leader
  const int64_t base = static_cast<int64_t>(set) * W;
  for (int k = j; k < N && sets_sorted[k] == set; ++k) {
    const int64_t e = perm[k];
    const uint32_t h = q_hi[e], l = q_lo[e];
    const int32_t cls = q_cls[e];
    const int32_t mrow = matrix_row(matrix, n_cls, cls);
    int free_way = -1;
    bool conflict = false;
    for (int w = 0; w < W; ++w) {
      const int32_t o = t_occ[base + w];
      if (o == 0 && free_way < 0) free_way = w;
      if (o <= 0 || t_hi[base + w] != h || t_lo[base + w] != l) continue;
      if (matrix_bit(mrow, o - 1)) conflict = true;
    }
    const bool ok = !conflict && free_way >= 0;
    if (ok) {
      t_hi[base + free_way] = h;
      t_lo[base + free_way] = l;
      t_occ[base + free_way] = 1 + cls;
    }
    accepted[e] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int witness_sets(int B, const void* q_lo, const void* valid,
                            int n_sets, void* sets, void* stream) {
  if (B > 0) {
    witness_sets_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(q_lo),
        static_cast<const int32_t*>(valid), n_sets,
        static_cast<int32_t*>(sets));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fastpath_prep(int B, const void* k_hi, const void* k_lo,
                             const void* k_cls, const void* k_valid,
                             const void* slot_map, int n_slots,
                             const void* matrix, int n_cls, const void* w_hi,
                             const void* w_lo, const void* w_valid, int U,
                             int n_sets, void* q_hi, void* q_lo, void* shard,
                             void* sets, void* conflicts, void* stream) {
  if (B > 0) {
    fastpath_prep_kernel<<<(B + kScanThreads - 1) / kScanThreads,
                           kScanThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(k_hi),
        static_cast<const uint32_t*>(k_lo), static_cast<const int32_t*>(k_cls),
        static_cast<const int32_t*>(k_valid),
        static_cast<const int32_t*>(slot_map), n_slots,
        static_cast<const int32_t*>(matrix), n_cls,
        static_cast<const uint32_t*>(w_hi), static_cast<const uint32_t*>(w_lo),
        static_cast<const int32_t*>(w_valid), U, n_sets,
        static_cast<uint32_t*>(q_hi), static_cast<uint32_t*>(q_lo),
        static_cast<int32_t*>(shard), static_cast<int32_t*>(sets),
        static_cast<int32_t*>(conflicts));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int witness_record_runs(int N, const void* sets_sorted,
                                   const void* perm, const void* q_hi,
                                   const void* q_lo, const void* q_cls,
                                   const void* matrix, int n_cls, int n_sets,
                                   int W, void* t_hi, void* t_lo, void* t_occ,
                                   void* accepted, void* stream) {
  if (N > 0) {
    witness_record_runs_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        N, static_cast<const int32_t*>(sets_sorted),
        static_cast<const int64_t*>(perm), static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), static_cast<const int32_t*>(q_cls),
        static_cast<const int32_t*>(matrix), n_cls, n_sets, W,
        static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
        static_cast<int32_t*>(t_occ), static_cast<int32_t*>(accepted));
  }
  return static_cast<int>(cudaGetLastError());
}
