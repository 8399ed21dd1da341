// Keys-only sorts of rows and chunks, and the bitonic network's passes, for
// Hopper (sm_90a) on one int64 key.
//
// Four kernels.  Each replaces a TPU kernel of the JAX package:
//
//   sort_rows_kernel     genome_assembly_tpu/ops/sort_pallas.py::_sort_kernel
//                        (wrapper sort_rows_pallas): every row of [rows, C]
//                        sorted ascending.
//   chunk_sort_kernel    ops/bitonic_pallas.py::_chunk_kernel (_run_chunk_pass)
//                        for the merge levels 2, 4 .. s (s <= chunk), which is
//                        what the sort sends: every run of s keys sorted.
//   big_ce_kernel        ops/bitonic_pallas.py::_big_ce_kernel (_run_big_ce):
//                        ONE stage at distance d >= chunk of merge level `size`.
//   finish_kernel        ops/bitonic_pallas.py::_finish_kernel (_run_finish):
//                        the stages chunk/2 .. 1 of ONE merge level.
//
// Same functions, other form.  The TPU kernels carry a key as two uint32
// lanes in a [rows, width] layout, flip the sign bit for unsigned order and
// find a partner with lane and sublane rolls.  Here a key is one signed
// int64 (every real key is < 2^62 and the padding is int64 max, so signed
// order is the lane order) and the array is flat.
//
// The network.  A stage (d, size) compare-exchanges every pair (i, i + d); a
// thread owns a PAIR: it reads both keys and writes the smaller and the
// larger one back in the order the level asks for.  The direction of a pair
// comes from the GLOBAL position of its lower key, up = (i & size) == 0, so
// chunks compose into one network and at the last level (size == total) every
// pair sorts ascending.  d and size are launch arguments: one compiled kernel
// serves every stage of every level, which is what the prefetched scalars
// bought on the TPU.  Equal keys are indistinguishable, so every pass is a
// fixed function of its input and is held bit-exact against its plain tensor
// version pass by pass.
//
// The two sorts are no network.  The levels 2, 4 .. s of the network sort any
// input: they leave every run of s consecutive keys sorted, ascending where
// the run's global start p has (p & s) == 0, else descending; the row sort is
// the same with s == C and every row ascending.  Keys are values only, so any
// sort gives the same bits.  sort_rows_kernel and chunk_sort_kernel are the
// block merge sort of block_sort.cuh (register levels up to 16 keys, then one
// merge round per level: 4 + 8 levels for a row of 4096 where the network has
// 78 barrier-separated stages, 4 + 10 for 2^14 keys where it has 105), on the
// flat array: a thread block takes block_keys >= s consecutive keys, that is
// block_keys / s whole runs, however short a run is, 16 keys a thread, and its
// last block is guarded by the array's end.  chunk_sort_kernel writes a descending run by
// reading it backwards out of shared memory; the direction bit comes from the
// 64-bit global position.  The merge sort starts from single keys, so it is
// right on any input.  A list of levels that is no such prefix ([2 chunk],
// [2, chunk, 2^40]) is a partial network and no sort; no sort sends one, and
// the wrapper refuses it on the card.
//
// What bounds them on this card.  Every kernel moves 16 bytes a key (read
// once, written once) through device memory.  big_ce_kernel does one compare
// for them: bytes.  It reads and writes coalesced (neighbouring threads own
// neighbouring keys; from d = 32 on a warp touches two runs of 256 contiguous
// bytes) and can work in place, since a pair is owned by one thread.  The two
// merge sorts wait for shared memory: a merge step is one dependent load at a
// data-dependent bank, eight to ten rounds of them a key.  finish_kernel runs
// log2(chunk) stages in shared memory with a block barrier after each:
// shared-memory traffic and barriers.
//
// A difference of the card: a block has 227 KB of shared memory, so a chunk
// is at most 2^14 keys (128 KB; 136 KB in the merge sort's skewed layout)
// where the TPU's is 2^17; a merge level therefore has three more
// device-memory stages here than there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

// sort_key, position, sort_blocks, and kMaxBlocks: the kernels stride over
// their rows, chunks or pairs, so any count works, also one above the
// grid-dimension limit
using namespace block_sort;

constexpr int kMaxSharedKeys = kMaxBlockKeys;  // of a row, a chunk, a block of the merge sorts
constexpr int kSortKeysPerThread = 16;  // of the two merge sorts: the largest block has 1024 threads
constexpr int kPairThreads = 256;

// Order the pair (a: lower position, b: higher) ascending when `up`,
// descending otherwise.
__device__ __forceinline__ void compare_exchange(sort_key& a, sort_key& b, bool up) {
  if ((a > b) == up) {
    const sort_key t = a;
    a = b;
    b = t;
  }
}

// One stage (distance d, merge level `size`) over `len` keys in shared
// memory whose first key has global position `base`.  Pair p of the stage
// is (i, i + d) with i = p with a zero bit inserted at d's position.
__device__ __forceinline__ void shared_stage(sort_key* s, int len, int d,
                                             position base, position size) {
  for (int p = threadIdx.x; p < len / 2; p += blockDim.x) {
    const int i = 2 * p - (p & (d - 1));
    sort_key a = s[i];
    sort_key b = s[i + d];
    compare_exchange(a, b, ((base + static_cast<position>(i)) & size) == 0);
    s[i] = a;
    s[i + d] = b;
  }
  __syncthreads();
}

// The stages of merge level `size` that fit in `len` keys:
// min(size, len) / 2 .. 1.
__device__ __forceinline__ void shared_level(sort_key* s, int len,
                                             position base, position size) {
  int d = size / 2 < static_cast<position>(len / 2) ? static_cast<int>(size / 2) : len / 2;
  for (; d >= 1; d >>= 1) {
    shared_stage(s, len, d, base, size);
  }
}

__device__ __forceinline__ void load_shared(sort_key* s, const sort_key* g, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s[i] = g[i];
  }
  __syncthreads();
}

__device__ __forceinline__ void store_shared(sort_key* g, const sort_key* s, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    g[i] = s[i];
  }
  __syncthreads();  // the block's next row or chunk overwrites the shared keys
}

// `in` and `out` of every kernel may be the same buffer (never partly
// overlapping ones): a row, a chunk or a pair is read and written by the
// one block or thread that owns it.

// Every run of c keys of the flat [rows * c] array ascending.  blockDim.x *
// kSortKeysPerThread is a power of two and a multiple of c.
__global__ void __launch_bounds__(BLOCK_SORT_MAX_THREADS(kMaxSharedKeys, kSortKeysPerThread))
sort_rows_kernel(const sort_key* in, sort_key* out, unsigned long long n_keys, int c) {
  extern __shared__ sort_key s[];
  sort_blocks<kSortKeysPerThread, false>(s, in, out, n_keys, 1, c);
}

// Every run of `top` keys sorted, the run at global position p ascending iff
// (p & top) == 0.  blockDim.x * kSortKeysPerThread is a power of two and a
// multiple of top.
__global__ void __launch_bounds__(BLOCK_SORT_MAX_THREADS(kMaxSharedKeys, kSortKeysPerThread))
chunk_sort_kernel(const sort_key* in, sort_key* out, unsigned long long n_keys, int top) {
  extern __shared__ sort_key s[];
  sort_blocks<kSortKeysPerThread, true>(s, in, out, n_keys, 1, top);
}

__global__ void __launch_bounds__(1024)
finish_kernel(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
              unsigned long long size) {
  extern __shared__ sort_key s[];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const position base = static_cast<position>(c) * chunk;
    load_shared(s, in + base, chunk);
    shared_level(s, chunk, base, size);
    store_shared(out + base, s, chunk);
  }
}

__global__ void __launch_bounds__(kPairThreads)
big_ce_kernel(const sort_key* in, sort_key* out, unsigned long long n_pairs,
              unsigned long long d, unsigned long long size) {
  const position stride = static_cast<position>(gridDim.x) * blockDim.x;
  for (position p = static_cast<position>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n_pairs; p += stride) {
    const position i = 2 * p - (p & (d - 1));
    sort_key a = in[i];
    sort_key b = in[i + d];
    compare_exchange(a, b, (i & size) == 0);
    out[i] = a;
    out[i + d] = b;
  }
}

// Grid, block and shared bytes of the stage-by-stage kernel over `units` chunks
// of `len` keys; raises the kernel's dynamic shared-memory limit
// when the keys need more than the 48 KB every kernel may use.
template <typename Kernel>
cudaError_t shared_config(Kernel kernel, long long units, int len, int threads,
                          int* blocks, int* block_threads, size_t* bytes) {
  if (units < 1 || len < 2 || len > kMaxSharedKeys || !is_pow2(len) ||
      threads < 32 || threads > 1024 || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  const int useful = len / 2 < 32 ? 32 : len / 2;  // one pair a thread at most
  *block_threads = threads < useful ? threads : useful;
  *blocks = units < kMaxBlocks ? static_cast<int>(units) : kMaxBlocks;
  *bytes = static_cast<size_t>(len) * sizeof(sort_key);
  return allow_shared(kernel, *bytes);
}

// One launch of a merge-sort kernel: runs of `top` keys (a power of two from
// 2) of the flat n_keys keys, a whole number of them; block_keys keys a thread
// block, a power of two from the larger of top and the keys a thread to the
// most a block holds.
template <typename Kernel>
cudaError_t launch_merge_sort(Kernel kernel, const void* in, void* out,
                              unsigned long long n_keys, int top, int block_keys,
                              void* stream) {
  if (n_keys < 1 || top < 2 || !is_pow2(top) || n_keys % top != 0 || !is_pow2(block_keys) ||
      block_keys < top || block_keys < kSortKeysPerThread || block_keys > kMaxSharedKeys) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = staged_bytes(block_keys);
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_blocks(n_keys, block_keys), block_keys / kSortKeysPerThread, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_keys, top);
  return cudaGetLastError();
}

}  // namespace

// Every launcher launches on `stream`, allocates nothing and synchronises
// nothing.  It returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes its kernel does not take.

extern "C" int bitonic_max_shared_keys() { return kMaxSharedKeys; }

// Every row of [rows, top] ascending.  block_keys: keys one thread block takes
// (whole rows).
extern "C" int sort_rows_launch(const void* in, void* out, long long rows, int top,
                                int block_keys, void* stream) {
  if (rows < 1 || top < 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_merge_sort(
      sort_rows_kernel, in, out, static_cast<unsigned long long>(rows) * top, top, block_keys,
      stream));
}

// The merge levels 2, 4 .. top of the network on n_keys flat keys: every run
// of top keys sorted, ascending iff its global start has the top bit clear.
extern "C" int chunk_sort_launch(const void* in, void* out, unsigned long long n_keys, int top,
                                 int block_keys, void* stream) {
  return static_cast<int>(launch_merge_sort(chunk_sort_kernel, in, out, n_keys, top, block_keys,
                                            stream));
}

extern "C" int finish_launch(const void* in, void* out, long long n_chunks, int chunk,
                             unsigned long long size, int threads, void* stream) {
  if (!is_pow2(size) || size < static_cast<unsigned long long>(chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks, block_threads;
  size_t bytes;
  cudaError_t err = shared_config(finish_kernel, n_chunks, chunk, threads,
                                  &blocks, &block_threads, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<blocks, block_threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_chunks, chunk, size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int big_ce_launch(const void* in, void* out, unsigned long long n,
                             unsigned long long d, unsigned long long size, void* stream) {
  if (!is_pow2(d) || !is_pow2(size) || size < 2 * d || n == 0 || n % (2 * d) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long n_pairs = n / 2;
  const unsigned long long want = (n_pairs + kPairThreads - 1) / kPairThreads;
  const int blocks = want < static_cast<unsigned long long>(kMaxBlocks)
                         ? static_cast<int>(want) : kMaxBlocks;
  big_ce_kernel<<<blocks, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_pairs, d, size);
  return static_cast<int>(cudaGetLastError());
}
