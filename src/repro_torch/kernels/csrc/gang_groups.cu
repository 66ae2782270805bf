// K5: grouped all-or-nothing gang record.
//
// Replaces: src/repro/kernels/witness_record.py gang_record_groups_pallas
//   (_make_gang_groups_kernel), reached through ops.gang_record_groups.
// Bound on the card: latency.  Groups must resolve in index order (each
//   probes the table as earlier groups left it), so the work is a chain of
//   G dependent steps of K row probes each; at G = 1, the single-op record
//   path, the bytes are a few hundred and a launch costs its fixed latency.
// Design: one block runs the groups in order.  Within a group, thread k
//   hashes and probes key k against the current table (dup, conflict, free
//   ways) in parallel; after a barrier, each key ranks itself among the
//   group's earlier inserters into its row and reserves the (rank+1)-th free
//   way, so same-row keys of one group never alias; thread 0 then folds the
//   verdicts (all-or-nothing, reason from the first failing key) and, on
//   accept, writes the keys in key order, as the Pallas write pass does.
//   K is at most 1024 (one thread per key).

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

__global__ void gang_groups_kernel(
    int G, int K, const uint32_t* __restrict__ k_hi,
    const uint32_t* __restrict__ k_lo, const int32_t* __restrict__ k_valid,
    const int32_t* __restrict__ k_cls, const int32_t* __restrict__ lanes,
    const uint32_t* __restrict__ r_hi, const uint32_t* __restrict__ r_lo,
    const int32_t* __restrict__ g_valid, const int32_t* __restrict__ matrix,
    int n_cls, int n_sets, int W, uint32_t* t_hi, uint32_t* t_lo,
    int32_t* t_occ, uint32_t* t_rh, uint32_t* t_rl, int32_t* t_age,
    int32_t* __restrict__ reasons, uint32_t* q_hi, uint32_t* q_lo,
    int32_t* counters) {
  extern __shared__ int32_t sm[];
  int32_t* s_row = sm;
  int32_t* s_valid = sm + K;
  int32_t* s_dup = sm + 2 * K;
  int32_t* s_conf = sm + 3 * K;
  int32_t* s_claim = sm + 4 * K;
  int32_t* s_ok = sm + 5 * K;
  int32_t* s_way = sm + 6 * K;
  const int tid = threadIdx.x;

  for (int i = tid; i < G * K; i += blockDim.x) {
    uint32_t h, l;
    keyhash2x32(k_hi[i], k_lo[i], h, l);
    q_hi[i] = h;
    q_lo[i] = l;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    if (g_valid[g] != 1) {  // uniform across the block
      if (tid == 0) reasons[g] = 0;
      continue;
    }
    const uint32_t rc = r_hi[g], rs = r_lo[g];
    int32_t row = 0, n_free = 0, dup_way = -1;
    bool valid = false, dup = false, conf = false;
    if (tid < K) {
      const int i = g * K + tid;
      valid = k_valid[i] == 1;
      const uint32_t h = q_hi[i], l = q_lo[i];
      row = lanes[g] * n_sets + static_cast<int32_t>(l & (n_sets - 1));
      if (valid) {
        const int32_t mrow = matrix_row(matrix, n_cls, k_cls[i]);
        const int64_t base = static_cast<int64_t>(row) * W;
        for (int w = 0; w < W; ++w) {
          const int32_t o = t_occ[base + w];
          if (o == 0) ++n_free;
          if (o <= 0 || t_hi[base + w] != h || t_lo[base + w] != l) continue;
          if (t_rh[base + w] == rc && t_rl[base + w] == rs) {
            if (dup_way < 0) dup_way = w;
            dup = true;
          } else if (matrix_bit(mrow, o - 1)) {
            conf = true;
          }
        }
      }
      s_row[tid] = row;
      s_valid[tid] = valid;
      s_dup[tid] = dup;
      s_conf[tid] = conf;
      s_claim[tid] = valid && !dup;
    }
    __syncthreads();
    if (tid < K) {
      int rank = 0;
      for (int j = 0; j < tid; ++j) rank += s_claim[j] && s_row[j] == row;
      int way = dup_way;
      if (!dup) {  // the (rank+1)-th free way, if the row has one
        way = -1;
        const int64_t base = static_cast<int64_t>(row) * W;
        int seen = 0;
        for (int w = 0; w < W && way < 0; ++w)
          if (t_occ[base + w] == 0 && seen++ == rank) way = w;
      }
      s_ok[tid] = !conf && (dup || n_free > rank);
      s_way[tid] = way;
    }
    __syncthreads();
    if (tid == 0) {
      bool acc = true, all_dup = true, any_valid = false;
      int first_fail = -1;
      for (int k = 0; k < K; ++k) {
        if (!s_valid[k]) continue;
        any_valid = true;
        if (!s_dup[k]) all_dup = false;
        if (!s_ok[k]) {
          acc = false;
          if (first_fail < 0) first_fail = k;
        }
      }
      int reason;
      if (acc) {
        reason = (all_dup && any_valid) ? 2 : 1;
        for (int k = 0; k < K; ++k) {
          if (!s_valid[k]) continue;
          const int i = g * K + k;
          const int64_t s = static_cast<int64_t>(s_row[k]) * W + s_way[k];
          t_hi[s] = q_hi[i];
          t_lo[s] = q_lo[i];
          t_occ[s] = 1 + k_cls[i];
          t_rh[s] = rc;
          t_rl[s] = rs;
          t_age[s] = 0;
        }
      } else {
        reason = s_conf[first_fail] ? 3 : 4;
      }
      reasons[g] = reason;
      if (counters != nullptr) counters[lanes[g] * 5 + reason] += 1;
    }
    __syncthreads();
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
  if (G > 0 && K > 0) {
    const int threads = ((K + 31) / 32) * 32;
    const size_t shmem = static_cast<size_t>(7) * K * sizeof(int32_t);
    gang_groups_kernel<<<1, threads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
        G, K, static_cast<const uint32_t*>(k_hi),
        static_cast<const uint32_t*>(k_lo),
        static_cast<const int32_t*>(k_valid),
        static_cast<const int32_t*>(k_cls), static_cast<const int32_t*>(lanes),
        static_cast<const uint32_t*>(r_hi), static_cast<const uint32_t*>(r_lo),
        static_cast<const int32_t*>(g_valid),
        static_cast<const int32_t*>(matrix), n_cls, n_sets, W,
        static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
        static_cast<int32_t*>(t_occ), static_cast<uint32_t*>(t_rh),
        static_cast<uint32_t*>(t_rl), static_cast<int32_t*>(t_age),
        static_cast<int32_t*>(reasons), static_cast<uint32_t*>(q_hi),
        static_cast<uint32_t*>(q_lo), static_cast<int32_t*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
