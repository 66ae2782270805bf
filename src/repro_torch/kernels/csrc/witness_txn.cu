// K9: the transactional probe, the all-or-nothing record of ONE op's keys.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_txn_pallas
//   (_record_txn_kernel), reached through ops.txn_probe (_txn_probe_impl,
//   which runs K1's mix before it).
// Bound on the card: latency.  One op has K <= 1024 keys (16 at the
//   smallest bucket); it reads K key pairs and K rows of W ways and writes
//   at most K slots, a few hundred bytes: the launch's fixed cost and two
//   dependent trips to memory (probe, then write) are the whole time.
// Design: one block for the op, one thread per key.  Each thread mixes its
//   raw key (keyhash.cuh, the mix K1 runs), probes its set in the PRE-op
//   table (hit, free ways) and, after a barrier, ranks itself among the
//   op's earlier inserters into the same set and reserves the (rank+1)-th
//   free way.  __syncthreads_and folds the per-key verdicts into the op's;
//   it is also the barrier that orders every probe before any write, so a
//   rejected op writes nothing and the table stays bit-identical.  The
//   reserved ways of one set are distinct, so the inserters write in
//   parallel what the Pallas kernel's ordered write loop writes.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"

using namespace repro_torch;

namespace {

__global__ void txn_probe_kernel(int K, const uint32_t* __restrict__ k_hi,
                                 const uint32_t* __restrict__ k_lo,
                                 const int32_t* __restrict__ own,
                                 const int32_t* __restrict__ valid, int S,
                                 int W, uint32_t* t_hi, uint32_t* t_lo,
                                 int32_t* t_occ, int32_t* __restrict__ acc,
                                 int32_t* __restrict__ hit_out,
                                 uint32_t* __restrict__ q_hi,
                                 uint32_t* __restrict__ q_lo) {
  extern __shared__ int32_t sm[];
  int32_t* s_set = sm;
  int32_t* s_claim = sm + K;
  const int k = threadIdx.x;
  const bool mine = k < K;
  int32_t set = 0;
  bool v = false, hit = false;
  int n_free = 0;
  uint32_t h = 0, l = 0;
  if (mine) {
    keyhash2x32(k_hi[k], k_lo[k], h, l);
    set = static_cast<int32_t>(l & static_cast<uint32_t>(S - 1));
    v = valid[k] == 1;
    const int64_t base = static_cast<int64_t>(set) * W;
    for (int w = 0; w < W; ++w) {
      const int32_t o = t_occ[base + w];
      if (o == 0) ++n_free;
      if (o > 0 && t_hi[base + w] == h && t_lo[base + w] == l) hit = true;
    }
    s_set[k] = set;
    s_claim[k] = v && !hit;
  }
  __syncthreads();
  bool ok = true;
  int way = -1;
  if (mine) {
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += s_claim[j] && s_set[j] == set;
    const bool seat = n_free > rank;
    ok = own[k] == 1 ? (hit || seat) : (!hit && seat);
    if (!v) ok = true;
    if (s_claim[k] && seat) {  // the (rank+1)-th free way
      const int64_t base = static_cast<int64_t>(set) * W;
      int seen = 0;
      for (int w = 0; w < W && way < 0; ++w)
        if (t_occ[base + w] == 0 && seen++ == rank) way = w;
    }
  }
  // Every probe (including the free-way walk above) happens before this
  // barrier; every write after it.
  const bool accepted = __syncthreads_and(ok) != 0;
  if (mine) {
    q_hi[k] = h;
    q_lo[k] = l;
    hit_out[k] = hit && v;
    if (accepted && way >= 0) {
      const int64_t s = static_cast<int64_t>(set) * W + way;
      t_hi[s] = h;
      t_lo[s] = l;
      t_occ[s] = 1;
    }
  }
  if (k == 0) acc[0] = accepted;
}

}  // namespace

// K is the padded key count (at most 1024, one thread per key).
extern "C" int txn_probe_launch(int K, const void* k_hi, const void* k_lo,
                                const void* own, const void* valid, int S,
                                int W, void* t_hi, void* t_lo, void* t_occ,
                                void* acc, void* hit, void* q_hi, void* q_lo,
                                void* stream) {
  if (K > 0) {
    const int threads = ((K + 31) / 32) * 32;
    const size_t shmem = static_cast<size_t>(2) * K * sizeof(int32_t);
    txn_probe_kernel<<<1, threads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
        K, static_cast<const uint32_t*>(k_hi),
        static_cast<const uint32_t*>(k_lo), static_cast<const int32_t*>(own),
        static_cast<const int32_t*>(valid), S, W,
        static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
        static_cast<int32_t*>(t_occ), static_cast<int32_t*>(acc),
        static_cast<int32_t*>(hit), static_cast<uint32_t*>(q_hi),
        static_cast<uint32_t*>(q_lo));
  }
  return static_cast<int>(cudaGetLastError());
}
