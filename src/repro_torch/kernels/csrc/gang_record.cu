// K2: set-parallel single-key record over the stacked witness gang.
//
// Replaces: src/repro/kernels/witness_record.py gang_record_setpar_pallas
//   (_gang_setpar_body) and its prep, ops._setpar_prep / ops.gang_record.
// Bound on the card: bytes and latency, not operations.  Each query reads
//   its row's W ways of six int32 planes (96 B at W=4) and writes at most
//   one way back; a whole batch of a few thousand queries moves well under
//   a megabyte, so a launch costs its fixed latency plus the longest
//   same-row chain, which must run in order.
// Design: the TPU resolved "rounds" (the r-th query of every set) as vector
//   steps over a sorted batch.  Here the wrapper sorts the queries by gang
//   row (a stable torch.sort, plain tensor prep like _setpar_prep), and one
//   thread per run of equal rows walks that run in batch order.  A run is
//   found in the kernel itself: position j leads a run when row[j-1] !=
//   row[j].  Rows are independent, so threads never share a table row and
//   need no synchronisation; only the [L, 5] reason counters take atomics.
//   The kernel also serves the fused cluster batch (K3) with rep = f: query
//   e of the sorted copies reads op e / rep.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

__global__ void gang_record_prep_kernel(int B, const uint32_t* __restrict__ k_hi,
                                        const uint32_t* __restrict__ k_lo,
                                        const int32_t* __restrict__ lanes,
                                        const int32_t* __restrict__ valid,
                                        int n_sets, int n_rows,
                                        uint32_t* __restrict__ q_hi,
                                        uint32_t* __restrict__ q_lo,
                                        int32_t* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t h, l;
  keyhash2x32(k_hi[i], k_lo[i], h, l);
  q_hi[i] = h;
  q_lo[i] = l;
  // Padding sorts behind every real row and is never processed.
  rows[i] = valid[i] == 1
                ? lanes[i] * n_sets + static_cast<int32_t>(l & (n_sets - 1))
                : n_rows;
}

__global__ void gang_record_runs_kernel(
    int N, int rep, const int32_t* __restrict__ rows_sorted,
    const int64_t* __restrict__ perm, const uint32_t* __restrict__ q_hi,
    const uint32_t* __restrict__ q_lo, const uint32_t* __restrict__ r_hi,
    const uint32_t* __restrict__ r_lo, const int32_t* __restrict__ q_cls,
    const int32_t* __restrict__ matrix, int n_cls, int n_rows, int n_sets,
    int W, uint32_t* t_hi, uint32_t* t_lo, int32_t* t_occ, uint32_t* t_rh,
    uint32_t* t_rl, int32_t* t_age, int32_t* __restrict__ reasons,
    int32_t* counters) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int32_t row = rows_sorted[j];
  if (row < 0 || row >= n_rows) return;
  if (j > 0 && rows_sorted[j - 1] == row) return;  // not a run leader
  const int64_t base = static_cast<int64_t>(row) * W;
  for (int k = j; k < N && rows_sorted[k] == row; ++k) {
    const int64_t e = perm[k];
    const int64_t b = e / rep;
    const uint32_t h = q_hi[b], l = q_lo[b], rc = r_hi[b], rs = r_lo[b];
    const int32_t cls = q_cls[b];
    const int32_t mrow = matrix_row(matrix, n_cls, cls);
    int dup_way = -1, free_way = -1;
    bool conflict = false;
    for (int w = 0; w < W; ++w) {
      const int32_t o = t_occ[base + w];
      if (o == 0 && free_way < 0) free_way = w;
      if (o <= 0 || t_hi[base + w] != h || t_lo[base + w] != l) continue;
      if (t_rh[base + w] == rc && t_rl[base + w] == rs) {
        if (dup_way < 0) dup_way = w;   // idempotent retry hit
      } else if (matrix_bit(mrow, o - 1)) {
        conflict = true;                // foreign rpc, classes conflict
      }
    }
    int reason;
    if (conflict) reason = 3;
    else if (dup_way >= 0) reason = 2;
    else if (free_way >= 0) reason = 1;
    else reason = 4;
    if (reason <= 2) {
      const int64_t s = base + (dup_way >= 0 ? dup_way : free_way);
      t_hi[s] = h;
      t_lo[s] = l;
      t_occ[s] = 1 + cls;
      t_rh[s] = rc;
      t_rl[s] = rs;
      t_age[s] = 0;
    }
    reasons[e] = reason;
    if (counters != nullptr) atomicAdd(&counters[(row / n_sets) * 5 + reason], 1);
  }
}

}  // namespace

extern "C" int gang_record_prep(int B, const void* k_hi, const void* k_lo,
                                const void* lanes, const void* valid,
                                int n_sets, int n_rows, void* q_hi, void* q_lo,
                                void* rows, void* stream) {
  if (B > 0) {
    gang_record_prep_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(k_hi),
        static_cast<const uint32_t*>(k_lo), static_cast<const int32_t*>(lanes),
        static_cast<const int32_t*>(valid), n_sets, n_rows,
        static_cast<uint32_t*>(q_hi), static_cast<uint32_t*>(q_lo),
        static_cast<int32_t*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gang_record_runs(int N, int rep, const void* rows_sorted,
                                const void* perm, const void* q_hi,
                                const void* q_lo, const void* r_hi,
                                const void* r_lo, const void* q_cls,
                                const void* matrix, int n_cls, int n_rows,
                                int n_sets, int W, void* t_hi, void* t_lo,
                                void* t_occ, void* t_rh, void* t_rl,
                                void* t_age, void* reasons, void* counters,
                                void* stream) {
  if (N > 0) {
    gang_record_runs_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        N, rep, static_cast<const int32_t*>(rows_sorted),
        static_cast<const int64_t*>(perm), static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), static_cast<const uint32_t*>(r_hi),
        static_cast<const uint32_t*>(r_lo), static_cast<const int32_t*>(q_cls),
        static_cast<const int32_t*>(matrix), n_cls, n_rows, n_sets, W,
        static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
        static_cast<int32_t*>(t_occ), static_cast<uint32_t*>(t_rh),
        static_cast<uint32_t*>(t_rl), static_cast<int32_t*>(t_age),
        static_cast<int32_t*>(reasons), static_cast<int32_t*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
