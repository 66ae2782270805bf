// K6: the single-table witness record.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_setpar_pallas
//   (_make_record_kernel / _setpar_kernel_body, with ops._setpar_prep,
//   reached through ops.witness_record).  K7, the fused fast-path batch
//   that adds the hash, the route and the window scan to this record, is
//   fastpath_batch.cu.
// Bound on the card: latency, not bytes or operations.  A query reads its
//   set's W ways of three int32 planes (48 B at W = 4) and writes at most
//   one way; a batch of 8192 moves under a megabyte.  A launch costs its
//   fixed latency plus the longest same-set chain, which must run in order.
// Design: one launch, no sort, K7's record stage without the hash and the
//   window.  The TPU resolved "rounds" (the r-th query of every set) as
//   vector steps over a sorted batch.  Here blocks own contiguous ranges of
//   sets (sets_per_block, set_walk.cuh: 128 blocks at S = 1024).  Each
//   block reads the whole batch coalesced (the lanes are already mixed, so
//   there is no hash) and keeps the valid queries of its own sets in batch
//   order (OwnedList::gather, smem_join.cuh), the order a stable sort by set
//   gave.  Then a warp per set walks that set's queries in batch order
//   (walk_sets, set_walk.cuh): a same-key way whose class bit is set in the
//   query's matrix row is a conflict; otherwise the query takes the first
//   free way with occ = 1 + class (a same-key record of a class that does
//   not conflict stays beside it); otherwise it is rejected.  There is no
//   rpc, no DUP and no age.  A batch with more of a block's queries than its
//   list holds is taken in chunks, in batch order (the table carries the
//   state between them).  Every accept bit is written once: a valid row by
//   the block owning its set, an invalid (padding) row by block 0, as 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "set_walk.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 1024;  // queries held per chunk (a multiple of
                             // kThreads)

// The list alone: K6 stages no window, so its key table is one unused slot.
using Shared = OwnedList<1, kList, kWarps>;

struct Args {
  int B;
  const uint32_t* __restrict__ q_hi;
  const uint32_t* __restrict__ q_lo;
  const int32_t* __restrict__ q_cls;
  const int32_t* __restrict__ q_valid;
  const int32_t* __restrict__ matrix;
  int n_cls;
  int n_sets;
  int W;
  int sets_per_block;
  uint32_t* t_hi;
  uint32_t* t_lo;
  int32_t* t_occ;
  int32_t* __restrict__ accepted;
};

__global__ void __launch_bounds__(kThreads)
    witness_record_kernel(const Args a) {
  __shared__ Shared sm;
  const int set0 = blockIdx.x * a.sets_per_block;
  const int set1 = min(set0 + a.sets_per_block, a.n_sets);
  sm.gather(
      a.B,
      [&](int b, Owned& q) {
        q.lo = a.q_lo[b];
        const bool valid = a.q_valid[b] == 1;
        const int set =
            static_cast<int>(q.lo & static_cast<uint32_t>(a.n_sets - 1));
        if (valid ? (set < set0 || set >= set1) : blockIdx.x != 0)
          return false;
        if (!valid) {  // padding never accepts
          a.accepted[b] = 0;
          return false;
        }
        q.hi = a.q_hi[b];
        q.cls = a.q_cls[b];
        q.idx = b;
        return true;
      },
      [&](int n) {
        __syncthreads();  // the chunk's list is complete
        walk_sets<kWarps>(a, sm, set0, n, a.accepted);
        __syncthreads();  // the list is free for the next chunk
      });
}

}  // namespace

extern "C" int witness_record_launch(int B, const void* q_hi,
                                     const void* q_lo, const void* q_cls,
                                     const void* q_valid, const void* matrix,
                                     int n_cls, int n_sets, int W, void* t_hi,
                                     void* t_lo, void* t_occ, void* accepted,
                                     void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int spb = sets_per_block(n_sets);
  const Args a{B,
               static_cast<const uint32_t*>(q_hi),
               static_cast<const uint32_t*>(q_lo),
               static_cast<const int32_t*>(q_cls),
               static_cast<const int32_t*>(q_valid),
               static_cast<const int32_t*>(matrix),
               n_cls,
               n_sets,
               W,
               spb,
               static_cast<uint32_t*>(t_hi),
               static_cast<uint32_t*>(t_lo),
               static_cast<int32_t*>(t_occ),
               static_cast<int32_t*>(accepted)};
  witness_record_kernel<<<(n_sets + spb - 1) / spb, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
