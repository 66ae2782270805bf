// K10: gc of synced entries from one witness table.
//
// Replaces: src/repro/kernels/witness_record.py witness_gc_pallas
//   (_gc_kernel), reached through ops.witness_gc.
// Bound on the card: operations at the sizes the protocol uses.  Every slot
//   is compared with every entry (the Pallas kernel's [S, W, G] cube; the
//   table is not searched by set), S * W * G pairs of two compares, while
//   the bytes are the table's three planes read once and the occ words
//   that clear written once.
// Design: one thread per slot, its key pair and occ in registers; the G
//   entries are staged in shared memory in tiles of the block's width, so
//   each entry is read from device memory once per block.  A slot that
//   matches an entry and is occupied writes occ = 0; the key planes are
//   never written.  The outcome does not depend on the order of the
//   entries, so blocks and threads need no ordering.  G = 0 launches
//   nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void witness_gc_kernel(int n_slots, int G,
                                  const uint32_t* __restrict__ g_hi,
                                  const uint32_t* __restrict__ g_lo,
                                  const uint32_t* __restrict__ t_hi,
                                  const uint32_t* __restrict__ t_lo,
                                  int32_t* __restrict__ t_occ) {
  __shared__ uint32_t s_hi[kThreads];
  __shared__ uint32_t s_lo[kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = i < n_slots;
  const uint32_t h = mine ? t_hi[i] : 0u;
  const uint32_t l = mine ? t_lo[i] : 0u;
  const bool held = mine && t_occ[i] > 0;
  bool match = false;
  for (int base = 0; base < G; base += kThreads) {
    const int n = min(kThreads, G - base);
    __syncthreads();
    if (threadIdx.x < n) {
      s_hi[threadIdx.x] = g_hi[base + threadIdx.x];
      s_lo[threadIdx.x] = g_lo[base + threadIdx.x];
    }
    __syncthreads();
    if (held && !match)
      for (int e = 0; e < n; ++e)
        if (s_hi[e] == h && s_lo[e] == l) {
          match = true;
          break;
        }
  }
  if (match) t_occ[i] = 0;
}

}  // namespace

extern "C" int witness_gc_launch(int n_slots, int G, const void* g_hi,
                                 const void* g_lo, const void* t_hi,
                                 const void* t_lo, void* t_occ, void* stream) {
  if (n_slots > 0 && G > 0) {
    witness_gc_kernel<<<(n_slots + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        n_slots, G, static_cast<const uint32_t*>(g_hi),
        static_cast<const uint32_t*>(g_lo), static_cast<const uint32_t*>(t_hi),
        static_cast<const uint32_t*>(t_lo), static_cast<int32_t*>(t_occ));
  }
  return static_cast<int>(cudaGetLastError());
}
