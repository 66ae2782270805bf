// The Mamba2 single-token state update of one layer, in place, with its
// read-out y, in one launch.
//
// Replaces no TPU kernel: the JAX package's Mamba2 step
//   (src/repro/models/ssm.py ssm_decode) is plain jnp, which XLA fuses on
//   the TPU.  In the port the same step ran as PyTorch's separate
//   elementwise kernels over the whole [B, H, P, N] state: st * dA, the
//   outer product xdt (x) B, their sum, the read-out einsum against C,
//   torch.where over the active rows and the copy back into the cache,
//   each a full pass over the state.  This kernel is those passes as one.
// Contract (models/ssm.py ssm_state_update_plain is the plain version):
//   new[b, h, p, n] = T(T(state * dA[b, h]) + T(xdt[b, h, p] * B[b, g, n]))
//   with g = h / (H / G) and T the state's type, rounding after each
//   product and after the sum as the plain path does, so the state stays
//   bit-equal to it; new is stored only where active[b] > 0, and for every
//   row y[b, h, p] = T(sum_n new * C[b, g, n]), summed in f32 (within
//   summation order of the plain path's einsum) and computed from new
//   also where the row is inactive, as the plain path computes it.
// Bound on the card: bytes.  The state is read once and written once (the
//   operands besides it are ~1/P of it): at granite-4.0-h-small's
//   16 x 128 x 64 x 128 in bf16, 2 x 33.55 MB a layer, 20.0 us at
//   3.35 TB/s, 0.72 ms for its 36 Mamba2 layers.
// Design: one block a (b, h) tile of P x N, rows of N split over
//   kLanes = N / (16 B / sizeof(T)) threads, so a thread moves its part of
//   a row in one 16-byte load and one 16-byte store and neighbouring
//   threads touch neighbouring bytes.  A thread issues the loads of its
//   first kUnroll rows before anything else; the block then stages its
//   group's rows of B and C in shared memory once (strided views of the
//   step's projection, whose layout PyTorch chooses: any strides are
//   taken, only the state must be contiguous), and a thread holds its
//   slice of both in registers for all its rows.  Loading kUnroll rows
//   before any arithmetic keeps many trips to memory in flight (the state
//   is written in place, so the compiler could not hoist the loads
//   itself).  The state is touched once a step, so its loads and stores
//   are marked evict-first (__ldcs, __stcs).  y is summed by the row's
//   lanes with shuffles inside their warp.  Templated on N and on the type
//   (bf16, and f32 for the reduced test configs that run on the card),
//   instantiated for the state sizes of the registered archs: 16
//   (hymba-1.5b) and 128 (granite-4.0-h-small, mamba2-130m).
//   Measured on one H100 80GB HBM3 at 700 W, 36 granite layers back to
//   back, each state cold: 1.006 ms with the evict-first hints, 1.118
//   without; 1.132 with __launch_bounds__ asking 6 blocks an SM (spills);
//   1.239 with 512 threads of 2 rows, 1.122 with 128 threads of 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rounds a product or a sum held in f32 to T; an f32 result passes as is.
template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element strides of the operands besides the state (contiguous).
struct Strides {
  long long a0, a1;      // dA [B, H]
  long long x0, x1, x2;  // xdt [B, H, P]
  long long b0, b1, b2;  // B [B, G, N]
  long long c0, c1, c2;  // C [B, G, N]
  long long act;         // active [B]
};

template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads) ssm_update_kernel(
    int H, int P, int rep, T* __restrict__ state, const T* __restrict__ dA,
    const T* __restrict__ xdt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const int32_t* __restrict__ active,
    Strides s, T* __restrict__ y) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = N / kVec;
  static_assert(N % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "a row is whole 16-byte vectors, its lanes inside a warp");
  __shared__ float sB[N], sC[N];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x % kLanes;
  const int row0 = threadIdx.x / kLanes;
  const int rows = blockDim.x / kLanes;
  const int trip = rows * kUnroll;
  T* tile = state + static_cast<long long>(bh) * P * N + lane * kVec;
  uint4 v[kUnroll];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * rows + row0;
      if (p < P)
        v[u] = __ldcs(reinterpret_cast<const uint4*>(tile + p * N));
    }
  };
  load(0);     // the state's first trip in flight before anything else

  const int g = h / rep;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    sB[n] = to_f(Bm[b * s.b0 + g * s.b1 + n * s.b2]);
    sC[n] = to_f(Cm[b * s.c0 + g * s.c1 + n * s.c2]);
  }
  const bool write = active[b * s.act] > 0;
  const float da = to_f(dA[b * s.a0 + h * s.a1]);
  const T* xrow = xdt + b * s.x0 + h * s.x1;
  T* yrow = y + static_cast<long long>(bh) * P;
  __syncthreads();
  float bv[kVec], cv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    bv[j] = sB[lane * kVec + j];
    cv[j] = sC[lane * kVec + j];
  }

  // Every thread runs the same trips, so the shuffles below always find
  // their whole warp.
  for (int base = 0; base < P; base += trip) {
    if (base > 0) load(base);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * rows + row0;
      float acc = 0.0f;
      if (p < P) {
        const float xp = to_f(xrow[p * s.x2]);
        T* e = reinterpret_cast<T*>(&v[u]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          // __fmul_rn / __fadd_rn: never contracted into an fma, which
          // would skip the plain path's rounding of each product.
          const T decayed = round_to<T>(__fmul_rn(to_f(e[j]), da));
          const T inject = round_to<T>(__fmul_rn(xp, bv[j]));
          e[j] = round_to<T>(__fadd_rn(to_f(decayed), to_f(inject)));
          acc = fmaf(to_f(e[j]), cv[j], acc);
        }
        if (write) __stcs(reinterpret_cast<uint4*>(tile + p * N), v[u]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (p < P && lane == 0) yrow[p] = round_to<T>(acc);
    }
  }
}

template <typename T, int N>
int launch(int B, int H, int P, int G, void* state, const void* dA,
           const void* xdt, const void* Bm, const void* Cm,
           const void* active, const Strides& s, void* y, void* stream) {
  constexpr int kLanes = N / (16 / static_cast<int>(sizeof(T)));
  int threads = P * kLanes;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  ssm_update_kernel<T, N><<<B * H, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      H, P, H / G, static_cast<T*>(state), static_cast<const T*>(dA),
      static_cast<const T*>(xdt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const int32_t*>(active), s,
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16, else float.  N must be 16 or 128 and
// B, H and P above 0 (the wrapper checks; another N returns
// cudaErrorInvalidValue).  Each operand after the state comes with its
// element strides.
extern "C" int ssm_update_launch(
    int bf16, int N, int B, int H, int P, int G, void* state, const void* dA,
    long long a0, long long a1, const void* xdt, long long x0, long long x1,
    long long x2, const void* Bm, long long b0, long long b1, long long b2,
    const void* Cm, long long c0, long long c1, long long c2,
    const void* active, long long act, void* y, void* stream) {
  const Strides s{a0, a1, x0, x1, x2, b0, b1, b2, c0, c1, c2, act};
#define SSM_LAUNCH(T, n) \
  return launch<T, n>(B, H, P, G, state, dA, xdt, Bm, Cm, active, s, y, stream)
  if (bf16) {
    if (N == 16) SSM_LAUNCH(__nv_bfloat16, 16);
    if (N == 128) SSM_LAUNCH(__nv_bfloat16, 128);
  } else {
    if (N == 16) SSM_LAUNCH(float, 16);
    if (N == 128) SSM_LAUNCH(float, 128);
  }
#undef SSM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
