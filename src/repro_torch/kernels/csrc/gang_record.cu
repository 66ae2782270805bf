// K2: the single-key record over the stacked witness gang, in one launch.
//
// Replaces: src/repro/kernels/witness_record.py gang_record_setpar_pallas
//   (_gang_setpar_body) and its prep, ops._setpar_prep / ops.gang_record;
//   also the record stage of the fused cluster batch (K3, ops.py
//   _gang_fastpath_impl), which records each op at its shard's f lanes.
// Bound on the card: latency.  A copy reads its row's W ways of five int32
//   planes (80 B at W = 4) and writes at most one way of six; a fused
//   batch's 3072 copies move about 200 KB.  What costs is the chain of
//   dependent steps: copies to one row resolve in batch order, each a trip
//   to the row and back, and every block must first find its copies in the
//   batch.  The earlier design paid a prep launch, a stable sort of the
//   rows (several CUB launches and a gather) and one thread per run of
//   equal rows walking its run through dependent global loads.
// Design: one launch, no sort, K6's (witness_table.cu) shape with K2's
//   rule.  Blocks of 1024 threads own contiguous ranges of the gang's
//   R = L * S rows (sets_per_block, set_walk.cuh: 128 blocks of 2048 rows
//   at 256 lanes x 1024 sets).  Each block reads the whole batch coalesced,
//   1024 copies a step, and keeps the copies of its own rows in batch order
//   (gather_owned, smem_join.cuh, on a list of its own: row, position and
//   class), the order the stable sort gave.  The standalone op hashes each
//   key inline (keyhash.cuh), records it at row lanes[b] * S + (lo & (S -
//   1)) and writes its mixed lanes; the fused batch's stage takes K3's rows
//   as given, copy e reading op e / rep.  Every load of a step, and of a
//   copy in the walk, has its address from the step or the list alone, so
//   each is one trip.  Then the block's 32 warps take its rows by a hash
//   of the row and each walks its rows' copies in batch order (walk_owned,
//   set_walk.cuh), lanes holding the ways (a stride of 32 over wider
//   rows): a same-key way of a foreign rpc whose class bit is set in the
//   copy's matrix row is a CONFLICT (3), which wins over a DUP; else the
//   first same-key same-rpc way is a DUP (2); else the first free way an
//   INSERT (1); else FULL (4).  1 and 2 write key, occ = 1 + class, rpc and
//   age 0 into their way, and lane 0 adds the [L, 5] reason count with an
//   atomic.  __syncwarp orders each write before the next copy's reads.  A
//   block with more copies than its list holds takes them in chunks, in
//   batch order (the table carries the state between them).  Every output
//   word is written once: a copy's reason (and, when hashing, its op's
//   mixed lanes) by the block owning its row, a padding copy's (not valid,
//   or a row outside the gang) by block 0, as reason 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "keyhash.cuh"
#include "set_walk.cuh"
#include "smem_join.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 2048;  // copies held per chunk (a multiple of kThreads)

// A copy a block keeps: its gang row, its position in the batch of copies
// and its op's class.  The walk reads the op's lanes and rpc by position.
struct Copy {
  int32_t row, idx, cls;
};

struct Shared {
  int32_t row[kList];
  int32_t idx[kList];
  int32_t cls[kList];
  int warp_counts[kWarps];
};

struct Args {
  int N;    // copies
  int rep;  // copies per op (rows given); 1 when hashing
  const uint32_t* __restrict__ k_hi;   // raw lanes [N] (hashing), or null
  const uint32_t* __restrict__ k_lo;
  const int32_t* __restrict__ lanes;   // [N] (hashing)
  const int32_t* __restrict__ valid;   // [N] (hashing)
  const int32_t* __restrict__ rows_e;  // [N] gang rows (given), or null
  uint32_t* q_hi;  // [N / rep] mixed lanes: written when hashing, else read
  uint32_t* q_lo;
  const uint32_t* __restrict__ r_hi;   // [N / rep]
  const uint32_t* __restrict__ r_lo;
  const int32_t* __restrict__ q_cls;
  const int32_t* __restrict__ matrix;
  int n_cls;
  int n_rows;
  int n_sets;
  int W;
  int rows_per_block;
  uint32_t* t_hi;
  uint32_t* t_lo;
  int32_t* t_occ;
  uint32_t* t_rh;
  uint32_t* t_rl;
  int32_t* t_age;
  int32_t* __restrict__ reasons;  // [N]
  int32_t* counters;              // [L, 5], or null
};

// Copy j of the list against its row, all lanes of the warp together.  The
// op's lanes and rpc, its matrix row and the row's ways are loaded in one
// trip: each address comes from the list alone.  When hashing, the block
// itself wrote q_hi/q_lo of its copies before the barrier that precedes the
// walk.
__device__ __forceinline__ void record_copy(const Args& a, const Shared& sm,
                                            int j) {
  const int lane = threadIdx.x & 31;
  const int32_t row = sm.row[j], e = sm.idx[j], cls = sm.cls[j];
  const int b = e / a.rep;
  const uint32_t h = a.q_hi[b], l = a.q_lo[b], rc = a.r_hi[b], rs = a.r_lo[b];
  const int32_t mrow = matrix_row(a.matrix, a.n_cls, cls);
  const int64_t base = static_cast<int64_t>(row) * a.W;
  bool conflict = false;
  int dup = -1, free_way = -1;
  for (int c = 0; c < a.W; c += 32) {
    const int w = c + lane;
    bool conf = false, same = false, empty = false;
    if (w < a.W) {
      const int64_t s = base + w;
      const int32_t o = a.t_occ[s];
      const bool key = a.t_hi[s] == h && a.t_lo[s] == l;
      const bool rpc = a.t_rh[s] == rc && a.t_rl[s] == rs;
      empty = o == 0;
      same = o > 0 && key && rpc;
      conf = o > 0 && key && !rpc && matrix_bit(mrow, o - 1);
    }
    conflict |= __any_sync(kAllLanes, conf) != 0;
    const unsigned dm = __ballot_sync(kAllLanes, same);
    const unsigned fm = __ballot_sync(kAllLanes, empty);
    if (dup < 0 && dm != 0u) dup = c + __ffs(dm) - 1;
    if (free_way < 0 && fm != 0u) free_way = c + __ffs(fm) - 1;
  }
  const int reason = conflict ? 3 : dup >= 0 ? 2 : free_way >= 0 ? 1 : 4;
  const int way = dup >= 0 ? dup : free_way;
  if (reason <= 2 && lane == (way & 31)) {
    const int64_t s = base + way;
    a.t_hi[s] = h;
    a.t_lo[s] = l;
    a.t_occ[s] = 1 + cls;
    a.t_rh[s] = rc;
    a.t_rl[s] = rs;
    a.t_age[s] = 0;
  }
  if (lane == 0) {
    a.reasons[e] = reason;
    if (a.counters != nullptr)
      atomicAdd(&a.counters[(row / a.n_sets) * 5 + reason], 1);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) gang_record_kernel(const Args a) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * a.rows_per_block;
  const int row1 = min(row0 + a.rows_per_block, a.n_rows);
  gather_owned<kList, Copy>(
      a.N, sm.warp_counts,
      [&](int e, Copy& c) {
        int64_t row;
        bool valid;
        if (a.rows_e != nullptr) {  // every load of the step in one trip
          row = a.rows_e[e];
          c.cls = a.q_cls[e / a.rep];
          valid = row >= 0 && row < a.n_rows;
        } else {
          uint32_t h, l;
          keyhash2x32(a.k_hi[e], a.k_lo[e], h, l);
          c.cls = a.q_cls[e];
          row = static_cast<int64_t>(a.lanes[e]) * a.n_sets +
                (l & static_cast<uint32_t>(a.n_sets - 1));
          valid = a.valid[e] == 1 && row >= 0 && row < a.n_rows;
          if (valid ? (row >= row0 && row < row1) : blockIdx.x == 0) {
            a.q_hi[e] = h;
            a.q_lo[e] = l;
          }
        }
        if (valid ? (row < row0 || row >= row1) : blockIdx.x != 0)
          return false;
        if (!valid) {  // padding is recorded nowhere
          a.reasons[e] = 0;
          return false;
        }
        c.row = static_cast<int32_t>(row);
        c.idx = e;
        return true;
      },
      [&](int pos, const Copy& c) {
        sm.row[pos] = c.row;
        sm.idx[pos] = c.idx;
        sm.cls[pos] = c.cls;
      },
      [&](int n) {
        __syncthreads();  // the chunk's list (and q_hi/q_lo) is complete
        // Warps take rows by a hash: the rows of one lane's copies share
        // the low bits the slot route read (16 of 1024 sets at 64 shards),
        // so row % kWarps would crowd them onto a few warps.
        walk_owned<kWarps>(
            n,
            [&](int i) {
              return static_cast<int>(
                  fmix32(static_cast<uint32_t>(sm.row[i])) >> 1);
            },
            [&](int j) { record_copy(a, sm, j); });
        __syncthreads();  // the list is free for the next chunk
      });
}

}  // namespace

// rows_e null: hash k_hi/k_lo and record op e at lanes[e] * n_sets +
// (lo & (n_sets - 1)) where valid[e] == 1, writing q_hi/q_lo for every e
// (rep must be 1).  Otherwise: record copy e at rows_e[e] (padding outside
// [0, n_rows)) with op e / rep's q_hi, q_lo, rpc and class.
extern "C" int gang_record_launch(
    int N, int rep, const void* k_hi, const void* k_lo, const void* lanes,
    const void* valid, const void* rows_e, void* q_hi, void* q_lo,
    const void* r_hi, const void* r_lo, const void* q_cls, const void* matrix,
    int n_cls, int n_rows, int n_sets, int W, void* t_hi, void* t_lo,
    void* t_occ, void* t_rh, void* t_rl, void* t_age, void* reasons,
    void* counters, void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const int rpb = sets_per_block(n_rows);
  const int blocks = n_rows > 0 ? (n_rows + rpb - 1) / rpb : 1;
  const Args a{N,
               rep,
               static_cast<const uint32_t*>(k_hi),
               static_cast<const uint32_t*>(k_lo),
               static_cast<const int32_t*>(lanes),
               static_cast<const int32_t*>(valid),
               static_cast<const int32_t*>(rows_e),
               static_cast<uint32_t*>(q_hi),
               static_cast<uint32_t*>(q_lo),
               static_cast<const uint32_t*>(r_hi),
               static_cast<const uint32_t*>(r_lo),
               static_cast<const int32_t*>(q_cls),
               static_cast<const int32_t*>(matrix),
               n_cls,
               n_rows,
               n_sets,
               W,
               rpb,
               static_cast<uint32_t*>(t_hi),
               static_cast<uint32_t*>(t_lo),
               static_cast<int32_t*>(t_occ),
               static_cast<uint32_t*>(t_rh),
               static_cast<uint32_t*>(t_rl),
               static_cast<int32_t*>(t_age),
               static_cast<int32_t*>(reasons),
               static_cast<int32_t*>(counters)};
  gang_record_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
