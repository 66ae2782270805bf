// One layer's single-token GQA attention over each row's ring of K/V, read
// in place: one launch, no copy of the cache.
//
// Replaces no TPU kernel: the JAX package's decode attention
//   (src/repro/models/layers.py attention_decode) is plain jnp, which XLA
//   fuses on the TPU.  In the port the same step ran as PyTorch's einsums
//   over the whole [B, C, Hkv, dh] ring (C = max_seq, or the window): each
//   einsum copied K and V into [B, Hkv, C, dh] order first, and the f32
//   scores, the mask's where and the softmax ran over all C slots, while a
//   row holds only cur_pos + 1 of them.
// Contract (models/layers.py sdpa_decode_plain is the plain version): for
//   row b, KV head g and its query heads h = g * rep + r, over the live
//   slots t < n_b, n_b = C if cur_pos[b] >= C (the ring has wrapped) else
//   cur_pos[b] + 1 (exactly the plain path's mask; a masked slot's
//   probability there is exp(-1e30 - m) = 0, so leaving it out is exact):
//     s_t = f32(T(q_h . k_t)) * scale        (f32 sum, rounded to T as the
//                                              einsum rounds its output)
//     p_t = T(exp(s_t - m) / sum_t exp(s_t - m)),  m = max_t s_t  (f32)
//     o_h = T(sum_t p_t v_t)                 (f32 sum, rounded once)
//   with T the cache's type; every row is computed, inactive ones too, as
//   the plain path computes them.  The result differs from the plain
//   path's only by the order of its f32 sums (an online softmax that
//   normalised after PV would round p elsewhere, so none is used).
// Bound on the card: bytes.  The live K and V rows are read once (the
//   scores stay in shared memory): at granite-4.0-h-small's 16 rows of
//   ~600 tokens, 8 KV heads of 128 in bf16, 2 x 19.7 MB a layer, 11.7 us at
//   3.35 TB/s; the copies it replaces moved the whole ring twice a layer.
// Design: one block a (row, KV head) serves all rep query heads of its
//   group, over all of the row's live slots (granite-4.0-h-small's 16 x 8
//   groups take 128 blocks, hymba-1.5b's 8 x 5 take 40).  A slot's row of
//   dh values is read by kLanes = dh / (16 B / sizeof(T)) neighbouring
//   lanes, one 16-byte load each, so a warp reads 32 / kLanes slots at
//   once and the block's warps take neighbouring slots; a thread loads its
//   next kUnroll slots' rows before the arithmetic on its current ones.
//   cur_pos is read on the device, so the grid is fixed and the launch can
//   be captured in a CUDA graph.  Three passes over the row's slots: (1)
//   the scores, each lane's partial dot products summed by an xor
//   butterfly (every lane of the slot ends with the same bits), the raw T
//   scores kept in shared memory, and the max; (2) the sum of exp(s - m),
//   then p written over the raw scores; (3) PV, each thread holding its
//   slice of dh for every query head in f32 registers, summed over the
//   warp's slots by shuffles and over the warps in a fixed order, and
//   rounded once.  A block whose rep x slots scores do not fit kScoreBytes
//   (only f32 rings past ~10,000 live slots at rep 5) recomputes them from
//   K in passes 2 and 3 with the same instructions, so the scores' bits
//   are the same (pass 2 sums them in another order).  Templated on the
//   type (bf16, and f32 for the reduced configs the card's tests run) and
//   on dh: 64 and 128 (the served archs) and 16 (the reduced configs).
//   nemotron-4-340b (dh 192, 12 query heads a KV head) fits neither the
//   lane layout nor kMaxRep: its decode raises on the card.
//   Measured on one H100 80GB HBM3 at 700 W, device time a launch (hymba's
//   global ring at ~1,700 tokens, its window ring full, granite's ring at
//   ~600): 0.0539, 0.0326, 0.0353 ms (0.0613, 0.0375, 0.0414 without the
//   prefetch), against byte bounds of 0.0051, 0.0031, 0.0108.  A block is
//   bound by its serial trips to memory, not by bytes: hymba's 40 blocks
//   leave most of the card's 132 SMs idle.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxRep = 8;
// Shared memory for one block's scores; the block's other arrays take
// under 10 KB more, inside the card's 227 KB opt-in limit.
constexpr int kScoreBytes = 200 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  int C, Hkv, rep, cap;   // cap: the slots whose scores shared memory holds
  float scale;
  const void* q;          // [B, 1, Hkv * rep, dh]
  const void* k;          // [B, C, Hkv, dh]
  const void* v;
  const int32_t* cur_pos; // [B]
  void* o;                // [B, 1, Hkv * rep, dh]
};

// A block's fixed shared arrays (the scores are dynamic).
template <int DH>
struct Shared {
  float q[kMaxRep * DH];        // the group's query heads
  float part[kWarps][kMaxRep];  // a fold's per-warp values
  float max[kMaxRep], sum[kMaxRep];
};

// Folds v[r] (r < rep) over the block by op into out[r], in a fixed order;
// every thread reads out after it.
template <typename Op>
__device__ __forceinline__ void block_fold(float (&v)[kMaxRep], int rep,
                                           float (*part)[kMaxRep],
                                           float* out, Op op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[r] = op(v[r], __shfl_xor_sync(0xffffffffu, v[r], off));
      if (lane == 0) part[warp][r] = v[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < rep) {
    float x = part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) x = op(x, part[w][threadIdx.x]);
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// Runs body(row, t) over the row's live slots t < m, kUnroll of this thread's
// slots a trip, the next trip's rows loaded before this trip's arithmetic
// (load(t) returns the row, or zeros past m).  Every thread runs the same
// trips, so the body's shuffles always find their whole warp.
template <int kStride, typename Load, typename Body>
__device__ __forceinline__ void walk(int m, int first, Load load,
                                     Body body) {
  constexpr int kStep = kStride * kUnroll;
  using Row = decltype(load(0));
  Row cur[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) cur[u] = load(u * kStride + first);
  for (int base = 0; base < m; base += kStep) {
    Row next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      next[u] = load(base + kStep + u * kStride + first);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      body(cur[u], base + u * kStride + first);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
  }
}

struct KV {
  uint4 k, v;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = DH / kVec;     // lanes reading one slot's row
  constexpr int kSlots = 32 / kLanes;   // slots a warp reads at once
  constexpr int kStride = kWarps * kSlots;
  static_assert(DH % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "a slot's row is whole 16-byte vectors inside one warp");
  extern __shared__ __align__(16) unsigned char dyn[];
  T* sc = reinterpret_cast<T*>(dyn);           // [rep][cap]: scores, then p
  float* red = reinterpret_cast<float*>(dyn);  // [kWarps][rep][DH], last
  __shared__ Shared<DH> sh;

  const int C = a.C, rep = a.rep, cap = a.cap;
  const float scale = a.scale;
  const int b = blockIdx.x / a.Hkv, g = blockIdx.x % a.Hkv;
  const int pos = a.cur_pos[b];
  const int m = pos >= C ? C : pos + 1;   // the live slots [0, m)
  const bool stored = m <= cap;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const int first = warp * kSlots + lane / kLanes;
  const long long row = static_cast<long long>(a.Hkv) * DH;
  const long long head = (static_cast<long long>(b) * C * a.Hkv + g) * DH
                         + sub * kVec;
  const T* kp = static_cast<const T*>(a.k) + head;
  const T* vp = static_cast<const T*>(a.v) + head;
  const long long q0 = (static_cast<long long>(b) * a.Hkv + g) * rep * DH;
  for (int i = threadIdx.x; i < rep * DH; i += kThreads)
    sh.q[i] = to_f(static_cast<const T*>(a.q)[q0 + i]);
  __syncthreads();

  auto load = [&](const T* base, int t) {
    return t < m ? __ldg(reinterpret_cast<const uint4*>(base + t * row))
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  auto load_k = [&](int t) { return load(kp, t); };
  // A slot's raw score against query head r, from this lane's part of its
  // K row; explicit intrinsics, so every pass computes the same bits.
  auto score = [&](const uint4& kc, int r, T& raw) {
    const T* e = reinterpret_cast<const T*>(&kc);
    const float* qr = sh.q + r * DH + sub * kVec;
    float d = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) d = __fmaf_rn(to_f(e[j]), qr[j], d);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
    raw = round_to<T>(d);
    return __fmul_rn(to_f(raw), scale);
  };
  auto prob = [&](float s, int r) {
    return round_to<T>(__fdiv_rn(expf(__fsub_rn(s, sh.max[r])), sh.sum[r]));
  };

  // (1) Scores and their max.
  float acc1[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc1[r] = -CUDART_INF_F;
  walk<kStride>(m, first, load_k, [&](const uint4& kc, int t) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        T raw;
        const float s = score(kc, r, raw);
        if (t < m) {
          acc1[r] = fmaxf(acc1[r], s);
          if (stored && sub == 0) sc[r * cap + t] = raw;
        }
      }
    }
  });
  auto most = [](float x, float y) { return fmaxf(x, y); };
  block_fold(acc1, rep, sh.part, sh.max, most);

  // (2) The softmax's sum, then p over the scores.
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc1[r] = 0.0f;
  if (stored) {
    for (int t = threadIdx.x; t < m; t += kThreads) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float s = __fmul_rn(to_f(sc[r * cap + t]), scale);
          acc1[r] += expf(__fsub_rn(s, sh.max[r]));
        }
      }
    }
  } else {
    walk<kStride>(m, first, load_k, [&](const uint4& kc, int t) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          T raw;
          const float s = score(kc, r, raw);
          if (t < m && sub == 0) acc1[r] += expf(__fsub_rn(s, sh.max[r]));
        }
      }
    });
  }
  auto plus = [](float x, float y) { return x + y; };
  block_fold(acc1, rep, sh.part, sh.sum, plus);
  if (stored) {
    for (int t = threadIdx.x; t < m; t += kThreads) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep)
          sc[r * cap + t] =
              prob(__fmul_rn(to_f(sc[r * cap + t]), scale), r);
      }
    }
    __syncthreads();
  }

  // (3) PV: this thread's slice of dh for every query head.
  float acc[kMaxRep][kVec];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.0f;
  }
  auto add = [&](const uint4& vc, int r, float p) {
    const T* e = reinterpret_cast<const T*>(&vc);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      acc[r][j] = __fmaf_rn(p, to_f(e[j]), acc[r][j]);
  };
  if (stored) {
    walk<kStride>(m, first, [&](int t) { return load(vp, t); },
                  [&](const uint4& vc, int t) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) add(vc, r, t < m ? to_f(sc[r * cap + t]) : 0.0f);
      }
    });
  } else {
    walk<kStride>(m, first,
                  [&](int t) { return KV{load(kp, t), load(vp, t)}; },
                  [&](const KV& kv, int t) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          T raw;
          const float s = score(kv.k, r, raw);
          add(kv.v, r, t < m ? to_f(prob(s, r)) : 0.0f);
        }
      }
    });
  }
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
          acc[r][j] = __fadd_rn(acc[r][j],
                                __shfl_xor_sync(0xffffffffu, acc[r][j], off));
      }
    }
  }
  __syncthreads();     // every thread is done with sc before red takes it
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          red[(warp * rep + r) * DH + sub * kVec + j] = acc[r][j];
      }
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + q0;
  for (int i = threadIdx.x; i < rep * DH; i += kThreads) {
    float x = red[i];
    for (int w = 1; w < kWarps; ++w) x = __fadd_rn(x, red[w * rep * DH + i]);
    o[i] = round_to<T>(x);
  }
}

// The slots of a row whose rep x slots scores shared memory holds.
int stored_slots(int elem, int rep, int C) {
  const int cap = kScoreBytes / (rep * elem);
  return cap < C ? cap : C;
}

// Lets the kernel take kScoreBytes of dynamic shared memory, once a
// device.  The limit is the most any launch takes (the scores' room, which
// also holds the fold's floats), the same for every shape: a limit lowered
// for one layer would not fit the launches of another that a CUDA graph
// already holds.
template <typename T, int DH>
cudaError_t allow_scores() {
  static_assert(static_cast<size_t>(kScoreBytes) >=
                    static_cast<size_t>(kWarps) * kMaxRep * DH * sizeof(float),
                "the fold's floats fit the scores' room");
  static std::atomic<unsigned> allowed{0};   // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attn_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScoreBytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

template <typename T, int DH>
int launch(int B, int C, int Hkv, int rep, float scale, const void* q,
           const void* k, const void* v, const void* cur_pos, void* o,
           void* stream) {
  const cudaError_t err = allow_scores<T, DH>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = stored_slots(static_cast<int>(sizeof(T)), rep, C);
  const size_t scores = static_cast<size_t>(rep) * cap * sizeof(T);
  const size_t reduce =
      static_cast<size_t>(kWarps) * rep * DH * sizeof(float);
  const Args a{C, Hkv, rep, cap, scale, q, k, v,
               static_cast<const int32_t*>(cur_pos), o};
  decode_attn_kernel<T, DH>
      <<<B * Hkv, kThreads, scores > reduce ? scores : reduce,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16, else float.  dh must be 16, 64 or 128,
// 1 <= rep <= 8, and B, C and Hkv above 0 (the wrapper checks; another dh
// or rep returns cudaErrorInvalidValue).  q, k, v and o are contiguous,
// k and v on 16-byte boundaries; cur_pos[b] >= 0.
extern "C" int decode_attn_launch(int bf16, int dh, int B, int C, int Hkv,
                                  int rep, float scale, const void* q,
                                  const void* k, const void* v,
                                  const void* cur_pos, void* o,
                                  void* stream) {
  if (rep < 1 || rep > kMaxRep || B < 1 || C < 1 || Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto fn) {
    return fn(B, C, Hkv, rep, scale, q, k, v, cur_pos, o, stream);
  };
  if (bf16) {
    if (dh == 16) return go(launch<__nv_bfloat16, 16>);
    if (dh == 64) return go(launch<__nv_bfloat16, 64>);
    if (dh == 128) return go(launch<__nv_bfloat16, 128>);
  } else {
    if (dh == 16) return go(launch<float, 16>);
    if (dh == 64) return go(launch<float, 64>);
    if (dh == 128) return go(launch<float, 128>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
