// K11: the sequential record, the baseline that the set-parallel record
// (K6) replaced.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_seq_pallas
//   (_record_seq_kernel), reached through ops.witness_record_seq.
// Bound on the card: latency, by design.  The batch is one ordered chain
//   of B dependent steps (each reads its set's row as the earlier steps
//   left it, then may write one way), so the time is B steps of the memory
//   that holds the table, whatever the bytes (B * 8 in, B * 4 out, the
//   probed rows) or the operations (B * W compares) would allow.  It is
//   kept to measure K6 against, as fig_fastpath does, so it stays one
//   chain: a set-parallel K11 would be K6.
// Design: one warp walks the batch in order; lane w holds way w + 32 c of
//   the probed row (NC chunks of 32 ways, NC = 1, 2, 4 or 8: at most 256
//   ways).  A vote finds a same-key way with occ == 1 exactly (the
//   classless conflict test: a same-key record of another class is
//   occupied but no conflict), a ballot the first free way, and the lane
//   that holds that way inserts.  A step is a chain of dependent
//   instructions on one warp, so the design keeps that chain short:
//   - A way is only ever loaded and stored by the lane that holds it, so
//     a lane's own program order makes its stores visible to its later
//     loads, with no barrier; that lets step b + 1's row be loaded before
//     step b decides.  If both steps probe one set, step b + 1 keeps the
//     row in the lanes' registers with step b's insert applied
//     (forwarding) and drops the load.
//   - No step branches (a branch that may diverge makes the warp wait to
//     reconverge): runs of 32 steps are unrolled, each lane rewrites its
//     way of the row every step (the insert's lane with the new record,
//     the others with what they hold), and the accept bits gather in a
//     word that the lanes write out once per run, coalesced.
//   - The queries come off the chain: lane j loads step c + j's lanes a
//     run of 32 steps ahead, and a step takes them two steps ahead by
//     __shfl_sync.  The key compare is integer logic, one predicate.
//   - Staged path, while the three planes (S x W x 12 B) fit the shared
//     memory a block may opt into (227 KB on an H100, so up to 4096 x 4):
//     one block (of 1024 threads up to 64 ways) copies the planes into
//     shared memory with 16-byte loads, warp 0 walks the chain there
//     after a barrier, and after another barrier the block writes the
//     planes back.
//   - Global path, for larger tables (4096 x 8 is 393,216 B): the same
//     walk by one warp on the planes in global memory.
//   Variants that prepared the next step's masks and predicates ahead of
//   the vote were slower on an H100: a step's time follows its count of
//   dependent instructions more than the loads it overlaps.
//   No padding, no valid mask.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
// The staged block's threads: 1024 (64 registers a thread) while a lane
// holds at most 64 ways; fewer for wider rows, whose walk holds more.
constexpr int stage_threads(int nc) { return nc <= 2 ? 1024 : 2048 / nc; }
constexpr int kMaxDevices = 64;
constexpr int kMaxWays = 256;

struct Planes {
  uint32_t* hi;
  uint32_t* lo;
  int32_t* occ;
};

// The ways of one row that a lane holds: way lane + 32 c in slot c (occ
// -1 past the row's end: never free, never a conflict).  Only occ's load
// is masked, so that little waits on a masked load.
template <int NC>
struct Row {
  int32_t occ[NC];
  uint32_t hi[NC];
  uint32_t lo[NC];

  __device__ __forceinline__ void load(const Planes& t, int64_t base, int W,
                                       int lane) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool own = 32 * c + lane < W;
      const int w = own ? 32 * c + lane : 0;
      occ[c] = own ? t.occ[base + w] : -1;
      hi[c] = t.hi[base + w];
      lo[c] = t.lo[base + w];
    }
  }
};

// The chain, walked by one warp over ``t`` (shared or global memory), in
// runs of 32 steps unrolled.
template <int NC>
__device__ void walk(int B, const uint32_t* __restrict__ q_hi,
                     const uint32_t* __restrict__ q_lo, int S, int W,
                     Planes t, int32_t* __restrict__ accepted) {
  const int lane = threadIdx.x & 31;
  const unsigned my_bit = 1u << lane;
  const uint32_t set_mask = static_cast<uint32_t>(S - 1);
  bool own[NC];  // the lane holds a way of the row in chunk c
#pragma unroll
  for (int c = 0; c < NC; ++c) own[c] = 32 * c + lane < W;
  // The lanes of this run of 32 queries and of the next, a run ahead.
  uint32_t run_h = 0, run_l = 0, next_h = 0, next_l = 0;
  if (lane < B) {
    run_h = q_hi[lane];
    run_l = q_lo[lane];
  }
  uint32_t h = __shfl_sync(kAll, run_h, 0);
  uint32_t l = __shfl_sync(kAll, run_l, 0);
  uint32_t h1 = __shfl_sync(kAll, run_h, 1);
  uint32_t l1 = __shfl_sync(kAll, run_l, 1);
  int64_t base = static_cast<int64_t>(l & set_mask) * W;
  Row<NC> row;
  row.load(t, base, W, lane);
  for (int c0 = 0; c0 < B; c0 += 32) {
    if (c0 + 32 + lane < B) {
      next_h = q_hi[c0 + 32 + lane];
      next_l = q_lo[c0 + 32 + lane];
    }
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (c0 + j >= B) break;
      // Step b + 2's query and step b + 1's row, before step b decides
      // (past the batch's end they read a real set and go unused).
      const uint32_t h2 = __shfl_sync(kAll, j < 30 ? run_h : next_h,
                                      (j + 2) & 31);
      const uint32_t l2 = __shfl_sync(kAll, j < 30 ? run_l : next_l,
                                      (j + 2) & 31);
      const int64_t base1 = static_cast<int64_t>(l1 & set_mask) * W;
      const bool same = base1 == base;
      Row<NC> row1;
      row1.load(t, base1, W, lane);
      // Step b: no same-key way with occ == 1, and the first free way
      // (chunk fc, lane bit fbit) takes the insert.
      unsigned fm[NC];
      bool pc = false;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        fm[c] = __ballot_sync(kAll, row.occ[c] == 0);
        pc |= ((row.hi[c] ^ h) | (row.lo[c] ^ l)
               | static_cast<uint32_t>(row.occ[c] ^ 1)) == 0u;
      }
      const bool conflict = __any_sync(kAll, pc) != 0;
      int fc = NC;
      unsigned fbit = 0u;
#pragma unroll
      for (int c = NC - 1; c >= 0; --c) {
        fc = fm[c] != 0u ? c : fc;
        fbit = fm[c] != 0u ? fm[c] & (0u - fm[c]) : fbit;
      }
      const bool acc = !conflict && fc < NC;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const bool ins = acc && c == fc && fbit == my_bit;
        row.occ[c] = ins ? 1 : row.occ[c];
        row.hi[c] = ins ? h : row.hi[c];
        row.lo[c] = ins ? l : row.lo[c];
        if (own[c]) {  // each way rewritten by its lane: no branch
          const int64_t slot = base + 32 * c + lane;
          t.occ[slot] = row.occ[c];
          t.hi[slot] = row.hi[c];
          t.lo[slot] = row.lo[c];
        }
      }
      bits |= static_cast<unsigned>(acc) << j;
      // Step b + 1 keeps this row (with the insert) on the same set, else
      // takes the row loaded above.
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        row.occ[c] = same ? row.occ[c] : row1.occ[c];
        row.hi[c] = same ? row.hi[c] : row1.hi[c];
        row.lo[c] = same ? row.lo[c] : row1.lo[c];
      }
      h = h1;
      l = l1;
      h1 = h2;
      l1 = l2;
      base = base1;
    }
    if (c0 + lane < B) accepted[c0 + lane] = (bits >> lane) & 1u;
    run_h = next_h;
    run_l = next_l;
  }
}

// Copies n words between global and shared memory with the whole block,
// 16 bytes a thread a step where both ends allow it.
template <typename T>
__device__ void copy_words(T* dst, const T* src, int n) {
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    auto* d = reinterpret_cast<uint4*>(dst);
    const auto* s = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// kStaged: the planes in shared memory for the walk (a block of
// stage_threads(NC) copies them in and out); else the walk on global
// memory (a block of one warp).
template <bool kStaged, int NC>
__global__ void __launch_bounds__(kStaged ? stage_threads(NC) : 32)
    witness_seq_kernel(int B, const uint32_t* __restrict__ q_hi,
                       const uint32_t* __restrict__ q_lo, int S, int W,
                       Planes t, int32_t* __restrict__ accepted) {
  if (!kStaged) {
    walk<NC>(B, q_hi, q_lo, S, W, t, accepted);
    return;
  }
  extern __shared__ uint4 staged[];
  const int n = S * W;
  Planes s{reinterpret_cast<uint32_t*>(staged),
           reinterpret_cast<uint32_t*>(staged) + n,
           reinterpret_cast<int32_t*>(staged) + 2 * n};
  copy_words(s.hi, t.hi, n);
  copy_words(s.lo, t.lo, n);
  copy_words(s.occ, t.occ, n);
  __syncthreads();
  if (threadIdx.x < 32) walk<NC>(B, q_hi, q_lo, S, W, s, accepted);
  __syncthreads();  // the write-back follows the chain's last step
  copy_words(t.hi, s.hi, n);
  copy_words(t.lo, s.lo, n);
  copy_words(t.occ, s.occ, n);
}

// The shared memory a block may opt into on the current device, and the
// staged kernels' limit raised to it there (once per device).
cudaError_t staged_limit(size_t* limit) {
  static int optin[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(witness_seq_kernel<true, 1>, attr, bytes);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(witness_seq_kernel<true, 2>, attr, bytes);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(witness_seq_kernel<true, 4>, attr, bytes);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(witness_seq_kernel<true, 8>, attr, bytes);
    }
    if (err != cudaSuccess) return err;
    optin[dev] = bytes;
  }
  *limit = static_cast<size_t>(optin[dev]);
  return cudaSuccess;
}

template <int NC>
void launch(bool staged, int B, const uint32_t* q_hi, const uint32_t* q_lo,
            int S, int W, Planes t, int32_t* accepted, cudaStream_t s) {
  if (staged) {
    const size_t bytes = static_cast<size_t>(S) * W * 12;
    witness_seq_kernel<true, NC><<<1, stage_threads(NC), bytes, s>>>(
        B, q_hi, q_lo, S, W, t, accepted);
  } else {
    witness_seq_kernel<false, NC><<<1, 32, 0, s>>>(B, q_hi, q_lo, S, W, t,
                                                   accepted);
  }
}

}  // namespace

// *staged = 1 if a table of S x W takes the staged path on the current
// device, else 0.
extern "C" int witness_seq_path(int S, int W, int* staged) {
  size_t limit = 0;
  const cudaError_t err = staged_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  *staged = static_cast<size_t>(S) * W * 12 <= limit;
  return 0;
}

// W is at most kMaxWays.
extern "C" int witness_seq_launch(int B, const void* q_hi, const void* q_lo,
                                  int S, int W, void* t_hi, void* t_lo,
                                  void* t_occ, void* accepted, void* stream) {
  if (W < 1 || W > kMaxWays) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  size_t limit = 0;
  const cudaError_t err = staged_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool staged = static_cast<size_t>(S) * W * 12 <= limit;
  const Planes t{static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
                 static_cast<int32_t*>(t_occ)};
  const auto* qh = static_cast<const uint32_t*>(q_hi);
  const auto* ql = static_cast<const uint32_t*>(q_lo);
  auto* acc = static_cast<int32_t*>(accepted);
  auto s = static_cast<cudaStream_t>(stream);
  if (W <= 32) {
    launch<1>(staged, B, qh, ql, S, W, t, acc, s);
  } else if (W <= 64) {
    launch<2>(staged, B, qh, ql, S, W, t, acc, s);
  } else if (W <= 128) {
    launch<4>(staged, B, qh, ql, S, W, t, acc, s);
  } else {
    launch<8>(staged, B, qh, ql, S, W, t, acc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
