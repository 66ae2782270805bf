// A measuring probe, not a port of a TPU kernel: the time of a serial
// chain's steps on this card, the least time of K11 (witness_seq.cu).
//
// K11's batch is B dependent steps: each reads its set's row as the earlier
// steps left it, then may write one way.  Its least time is therefore B
// times the least step, whatever its bytes or operations would allow.  The
// probe runs B steps of the least such work by one thread: a load whose
// address the previous step's load gave, and a store into the same row.
// The words are a random cycle over the rows of a table plane, rows W words
// apart (K11's stride): word 0 of a row holds the next row's first word,
// word 1 takes the step's store.
//
// Two memories: the words in global memory, read and written as K11 reads
// and writes its table (plain loads and stores), or staged into shared
// memory first and written back at the end, the fastest memory that a
// serial step could use while the table fits in a block's shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStageThreads = 256;
constexpr int kMaxSharedWords = 48 * 1024 / 4;

template <bool kShared>
__global__ void chain_probe_kernel(int B, int n_words,
                                   int32_t* __restrict__ words,
                                   int32_t* __restrict__ end) {
  extern __shared__ int32_t staged[];
  int32_t* w = words;
  if (kShared) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
      staged[i] = words[i];
    }
    __syncthreads();
    w = staged;
  }
  if (threadIdx.x == 0) {
    int32_t cur = 0;
    for (int b = 0; b < B; ++b) {
      const int32_t next = w[cur];
      w[cur + 1] = b;
      cur = next;
    }
    *end = cur;
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
      words[i] = staged[i];
    }
  }
}

}  // namespace

// Runs B steps from word 0 of ``words`` (n_words int32, a cycle as above,
// in global memory) and writes the word the chain ended on to ``end``.
// ``shared`` != 0 stages the words in shared memory (at most 48 KB).
extern "C" int chain_probe_launch(int B, int n_words, int shared, void* words,
                                  void* end, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<int32_t*>(words);
  auto* e = static_cast<int32_t*>(end);
  if (shared) {
    if (n_words > kMaxSharedWords) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    chain_probe_kernel<true><<<1, kStageThreads,
                               static_cast<size_t>(n_words) * 4, s>>>(
        B, n_words, w, e);
  } else {
    chain_probe_kernel<false><<<1, 32, 0, s>>>(B, n_words, w, e);
  }
  return static_cast<int>(cudaGetLastError());
}
