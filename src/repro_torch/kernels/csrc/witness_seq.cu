// K11: the sequential record, the baseline that the set-parallel record
// (K6) replaced.
//
// Replaces: src/repro/kernels/witness_record.py witness_record_seq_pallas
//   (_record_seq_kernel), reached through ops.witness_record_seq.
// Bound on the card: latency, by design.  The batch is one ordered chain
//   of B dependent steps (each reads its set's row as the earlier steps
//   left it, then may write one way), so the time is B trips to memory and
//   back whatever the bytes (B * 8 in, B * 4 out, the probed rows) or the
//   operations (B * W compares) would allow.  It is kept to measure K6
//   against, as fig_fastpath does, not to be fast.
// Design: one warp walks the batch in order; lane w holds way w of the
//   probed row (in chunks of 32 for wider sets).  A ballot finds a same-key
//   way with occ == 1 exactly (the classless conflict test: a same-key
//   record of another class is occupied but no conflict) and the first free
//   way; lane 0 writes the insert and the accept bit, and __syncwarp orders
//   that write before the next step's reads.  No padding, no valid mask.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void witness_seq_kernel(int B, const uint32_t* __restrict__ q_hi,
                                   const uint32_t* __restrict__ q_lo, int S,
                                   int W, uint32_t* t_hi, uint32_t* t_lo,
                                   int32_t* t_occ,
                                   int32_t* __restrict__ accepted) {
  const int lane = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    const uint32_t h = q_hi[b], l = q_lo[b];
    const int64_t base =
        static_cast<int64_t>(l & static_cast<uint32_t>(S - 1)) * W;
    bool conflict = false;
    int way = -1;
    for (int c = 0; c < W; c += 32) {
      const int w = c + lane;
      bool conf = false, free = false;
      if (w < W) {
        const int32_t o = t_occ[base + w];
        free = o == 0;
        conf = o == 1 && t_hi[base + w] == h && t_lo[base + w] == l;
      }
      conflict |= __any_sync(kAll, conf) != 0;
      const unsigned fm = __ballot_sync(kAll, free);
      if (way < 0 && fm != 0u) way = c + __ffs(fm) - 1;
    }
    const bool acc = !conflict && way >= 0;
    if (lane == 0) {
      if (acc) {
        t_hi[base + way] = h;
        t_lo[base + way] = l;
        t_occ[base + way] = 1;
      }
      accepted[b] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int witness_seq_launch(int B, const void* q_hi, const void* q_lo,
                                  int S, int W, void* t_hi, void* t_lo,
                                  void* t_occ, void* accepted, void* stream) {
  if (B > 0) {
    witness_seq_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        B, static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), S, W,
        static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
        static_cast<int32_t*>(t_occ), static_cast<int32_t*>(accepted));
  }
  return static_cast<int>(cudaGetLastError());
}
