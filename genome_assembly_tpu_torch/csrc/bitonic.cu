// Keys-only bitonic sorting network for Hopper (sm_90a) on one int64 key.
//
// Four kernels, one compare-exchange.  Each replaces a TPU kernel of the
// JAX package:
//
//   sort_rows_kernel   genome_assembly_tpu/ops/sort_pallas.py::_sort_kernel
//                      (wrapper sort_rows_pallas): every row of [rows, C]
//                      sorted ascending, the row held in fast memory.
//   chunk_sort_kernel  ops/bitonic_pallas.py::_chunk_kernel (_run_chunk_pass):
//                      every stage with distance < chunk of the merge levels
//                      the caller lists, on one chunk in fast memory.
//   big_ce_kernel      ops/bitonic_pallas.py::_big_ce_kernel (_run_big_ce):
//                      ONE stage at distance d >= chunk of merge level `size`.
//   finish_kernel      ops/bitonic_pallas.py::_finish_kernel (_run_finish):
//                      the stages chunk/2 .. 1 of ONE merge level.
//
// Same network, other form.  The TPU kernels carry a key as two uint32
// lanes in a [rows, width] layout, flip the sign bit for unsigned order and
// find a partner with lane and sublane rolls.  Here a key is one signed
// int64 (every real key is < 2^62 and the padding is int64 max, so signed
// order is the lane order), the array is flat, and a thread owns a PAIR
// (i, i + d): it reads both keys and writes the smaller and the larger one
// back in the order the level asks for.  The direction of a pair comes from
// the GLOBAL position of its lower key, up = (i & size) == 0, so chunks
// compose into one network and at the last level (size == total) every pair
// sorts ascending.  d and size are launch arguments: one compiled kernel
// serves every stage of every level, which is what the prefetched scalars
// bought on the TPU.  Equal keys are indistinguishable, so every pass is a
// fixed function of its input and is held bit-exact against its plain
// tensor version pass by pass.
//
// What bounds them on this card.  big_ce_kernel moves 16 bytes a key (read
// once, written once) for one compare: bytes.  It reads and writes
// coalesced (neighbouring threads own neighbouring keys; from d = 32 on a
// warp touches two runs of 256 contiguous bytes) and can work in place,
// since a pair is owned by one thread.  The three
// shared-memory kernels also move 16 bytes a key through device memory,
// but run log2(chunk) (finish) to log2(chunk)*(log2(chunk)+1)/2 (chunk
// sort, row sort) stages on it in shared memory with a block barrier after
// each: shared-memory traffic and barriers, not device memory, are what
// they wait for.  Several stages a thread could run in registers between
// barriers; that is left to a later change, this is the plain form.
//
// A difference of the card: a block has 227 KB of shared memory, so a chunk
// is at most 2^14 keys (128 KB) where the TPU's is 2^17; a merge level
// therefore has three more device-memory stages here than there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long sort_key;             // one int64 key
typedef unsigned long long position;    // global index, distance, level size

constexpr int kMaxSharedKeys = 1 << 14;  // 128 KB of the block's 227 KB
// grid cap: the kernels stride over their rows, chunks or pairs, so any
// count works, also one above the grid-dimension limit
constexpr int kMaxBlocks = 132 * 16;
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

__global__ void __launch_bounds__(1024)
sort_rows_kernel(const sort_key* in, sort_key* out, long long rows, int c) {
  extern __shared__ sort_key s[];
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * c;
    load_shared(s, in + off, c);
    // positions are taken within the row, so the last level (size == c)
    // is ascending in every row
    for (int size = 2; size <= c; size <<= 1) {
      shared_level(s, c, 0, static_cast<position>(size));
    }
    store_shared(out + off, s, c);
  }
}

// size_mask: bit b set <=> merge level 2^b is run, in ascending order.
__global__ void __launch_bounds__(1024)
chunk_sort_kernel(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
                  unsigned long long size_mask) {
  extern __shared__ sort_key s[];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const position base = static_cast<position>(c) * chunk;
    load_shared(s, in + base, chunk);
    for (int b = 1; b < 63; ++b) {
      if ((size_mask >> b) & 1ull) {
        shared_level(s, chunk, base, 1ull << b);
      }
    }
    store_shared(out + base, s, chunk);
  }
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

bool is_pow2(unsigned long long x) { return x != 0 && (x & (x - 1)) == 0; }

// Grid, block and shared bytes of a shared-memory kernel over `units` rows
// or chunks of `len` keys; raises the kernel's dynamic shared-memory limit
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
  if (*bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*bytes));
  }
  return cudaSuccess;
}

}  // namespace

// Every launcher launches on `stream`, allocates nothing and synchronises
// nothing.  It returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes its kernel does not take.

extern "C" int bitonic_max_shared_keys() { return kMaxSharedKeys; }

extern "C" int sort_rows_launch(const void* in, void* out, long long rows, int c,
                                int threads, void* stream) {
  int blocks, block_threads;
  size_t bytes;
  cudaError_t err = shared_config(sort_rows_kernel, rows, c, threads,
                                  &blocks, &block_threads, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_rows_kernel<<<blocks, block_threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_sort_launch(const void* in, void* out, long long n_chunks, int chunk,
                                 unsigned long long size_mask, int threads, void* stream) {
  // levels 2^1 .. 2^62; bit 0 and bit 63 name no level
  if ((size_mask & 1ull) || (size_mask >> 63)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks, block_threads;
  size_t bytes;
  cudaError_t err = shared_config(chunk_sort_kernel, n_chunks, chunk, threads,
                                  &blocks, &block_threads, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_sort_kernel<<<blocks, block_threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_chunks, chunk,
      size_mask);
  return static_cast<int>(cudaGetLastError());
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
