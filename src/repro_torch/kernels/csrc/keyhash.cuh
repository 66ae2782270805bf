// Shared device helpers of the kernels: the keyhash2x32 mix and the
// merge-lattice matrix consult.
//
// keyhash2x32 is the 64-bit-equivalent key hash carried as two uint32 lanes
// (murmur3 fmix32 finalizers with cross-lane mixing).  It must agree bit for
// bit with np_keyhash2x32 / keyhash2x32 in ../ref.py and with the host
// SlotRouter (core/shard.py mix2x32), which is how device routing and host
// placement stay identical.  The JAX package runs the same mix as the
// keyhash2x32_pallas kernel (src/repro/kernels/keyhash.py); here K1
// (keyhash.cu) runs it standalone and the other kernels inline it.
#pragma once

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void keyhash2x32(uint32_t hi, uint32_t lo,
                                            uint32_t& out_hi,
                                            uint32_t& out_lo) {
  const uint32_t h1 = fmix32(lo + 0x9E3779B9u);
  const uint32_t h2 = fmix32(hi ^ h1);
  out_hi = h2;
  out_lo = fmix32(h1 + h2 * 5u + 0xE6546B64u);
}

// CONFLICT_MATRIX[cls]; a class outside the matrix reads an all-zero row.
__device__ __forceinline__ int32_t matrix_row(const int32_t* matrix,
                                              int n_cls, int32_t cls) {
  return (cls >= 0 && cls < n_cls) ? matrix[cls] : 0;
}

// ((mrow >> cls) & 1) == 1, with shifts of 32 or more reading 0.
__device__ __forceinline__ bool matrix_bit(int32_t mrow, int32_t cls) {
  return cls >= 0 && cls < 32 && ((mrow >> cls) & 1);
}

}  // namespace repro_torch
