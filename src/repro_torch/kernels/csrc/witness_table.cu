// K6: the single-table witness record.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_setpar_pallas
//   (_make_record_kernel / _setpar_kernel_body, with ops._setpar_prep,
//   reached through ops.witness_record).  K7, the fused fast-path batch
//   that once shared this record stage, is fastpath_batch.cu.
// Bound on the card: latency, not bytes or operations.  A query reads its
//   set's W ways of three int32 planes (48 B at W = 4) and writes at most
//   one way; a batch of 8192 moves under a megabyte.  A launch costs its
//   fixed latency plus the longest same-set chain, which must run in order.
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
//   rpc, no DUP and no age.  fastpath_batch.cu's set-owning blocks and warp
//   walk (no sort, one launch) are the redesign this record stage can take.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;

__global__ void witness_sets_kernel(int B, const uint32_t* __restrict__ q_lo,
                                    const int32_t* __restrict__ valid,
                                    int n_sets, int32_t* __restrict__ sets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  sets[i] = valid[i] == 1 ? static_cast<int32_t>(q_lo[i] & (n_sets - 1))
                          : n_sets;
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
