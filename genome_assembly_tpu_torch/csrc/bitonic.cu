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
// The network.  A stage (d, size) compare-exchanges every pair (i, i + d);
// in big_ce_kernel a thread owns a PAIR: it reads both keys and writes the
// smaller and the larger one back in the order the level asks for (in
// finish_kernel a thread owns V keys, see there).  The direction of a pair
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
// data-dependent bank, eight to ten rounds of them a key.  finish_kernel
// moves its 16 bytes a key too: it keeps the keys in registers for log2(V)
// stages at a time (V keys a thread) and goes through shared memory only
// between those groups, twice for a chunk of 2^14 keys at V = 32 (three
// times at 16), where a stage-by-stage kernel reads and writes the chunk
// there 14 times, each behind a block barrier.
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

// The stages chunk/2 .. 1 of merge level `size` on every chunk, V keys a
// thread, chunk / V threads a block, one chunk at a time.  The stages are
// taken in groups of log2(V) stage bits, from the top: in a group a thread
// holds the V keys whose positions differ in the group's bits and agree with
// its thread index in all others, so the group's stages are compare-exchanges
// between its own registers with no barrier.  The first group is loaded
// straight from device memory (key t + j * chunk / V: coalesced across
// threads), the last one holds the low bits, V consecutive keys a thread;
// between two groups the keys go through shared memory in block_sort.cuh's
// skewed layout, where neither layout meets a bank twice.  Stored straight
// from registers, a thread's V consecutive keys make every store of a warp
// touch 32 lines; on the card those stores, not the stages, were the cost of
// this kernel's first form.  So the last group is stored through the warp's
// own slice of the buffer, transposed: a warp barrier, no block barrier,
// every store of a warp one contiguous run.
// The last group may share bits with the one before; it runs only the stages
// that are left.  The level's direction is one bit a chunk (size >= chunk):
// a descending chunk is sorted as the complement of its keys (~x reverses
// the order of int64 and is its own inverse), so every compare-exchange is
// an ascending one.
template <int V>
__global__ void __launch_bounds__(BLOCK_SORT_MAX_THREADS(kMaxSharedKeys, V))
finish_kernel(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
              unsigned long long size) {
  extern __shared__ sort_key s[];
  constexpr int G = V == 2 ? 1 : V == 4 ? 2 : V == 8 ? 3 : V == 16 ? 4 : 5;  // log2(V)
  const int log_chunk = 31 - __clz(chunk);
  const int t = threadIdx.x;
  const int first = log_chunk - G;  // the first group: bits first .. log_chunk - 1
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const position base = static_cast<position>(c) * chunk;
    const sort_key flip = (base & size) == 0 ? 0 : ~0ll;
    sort_key r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = in[base + t + (j << first)] ^ flip;
    int lo = first;       // the group's lowest bit
    int done = log_chunk;  // the stages of bits done .. log_chunk - 1 have run
    while (true) {
#pragma unroll
      for (int b = G - 1; b >= 0; --b) {
        if (lo + b < done) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if ((j & (1 << b)) == 0) order(r[j], r[j | (1 << b)]);
          }
        }
      }
      done = lo;
      if (lo == 0) break;
      // to the next group's layout: key j of thread t lies at position
      // (t's bits below lo) | j << lo | (t's other bits) << (lo + G)
      const int next = lo > G ? lo - G : 0;
      const int from = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + G));
      const int to = (t & ((1 << next) - 1)) | ((t >> next) << (next + G));
      __syncthreads();  // every thread has read what the buffer held before
#pragma unroll
      for (int j = 0; j < V; ++j) s[staged<V>(from | (j << lo))] = r[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = s[staged<V>(to | (j << next))];
      lo = next;
    }
    if (first == 0) {  // one group: the chunk is this thread's, no buffer
#pragma unroll
      for (int j = 0; j < V; ++j) out[base + j] = r[j] ^ flip;
      continue;
    }
    // the last group holds V consecutive keys a thread, a warp's lanes one
    // run of lanes * V keys: it goes out through the warp's own slice of the
    // buffer (the slice the warp read last, so no block barrier), transposed,
    // so that each store of the warp is one contiguous run
    const int lanes = blockDim.x < 32 ? blockDim.x : 32;
    const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1;
    const int lane = t & 31;
    const int slice = (t - lane) * V;
    __syncwarp(mask);
#pragma unroll
    for (int j = 0; j < V; ++j) s[staged<V>((t << G) | j)] = r[j];
    __syncwarp(mask);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = slice + j * lanes + lane;
      out[base + i] = s[staged<V>(i)] ^ flip;
    }
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

// Bytes of shared memory finish_kernel<V> takes for a chunk: none where one
// group holds all its stages, else the chunk in the skewed layout.
inline size_t finish_shared_bytes(int chunk, int v) {
  return chunk > v ? staged_bytes(chunk) : 0;
}

template <int V>
cudaError_t launch_finish(const void* in, void* out, long long n_chunks, int chunk,
                          unsigned long long size, cudaStream_t stream) {
  const size_t bytes = finish_shared_bytes(chunk, V);
  cudaError_t err = allow_shared(finish_kernel<V>, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = n_chunks < kMaxBlocks ? static_cast<int>(n_chunks) : kMaxBlocks;
  finish_kernel<V><<<blocks, chunk / V, bytes, stream>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_chunks, chunk, size);
  return cudaGetLastError();
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

// The stages chunk/2 .. 1 of merge level `size` on every chunk.  per_thread:
// keys a thread holds (a power of two from 2 to 32; a chunk shorter than that
// takes one thread of `chunk` keys); the block has chunk / that threads.
extern "C" int finish_launch(const void* in, void* out, long long n_chunks, int chunk,
                             unsigned long long size, int per_thread, void* stream) {
  if (n_chunks < 1 || chunk < 2 || chunk > kMaxSharedKeys || !is_pow2(chunk) || !is_pow2(size) ||
      size < static_cast<unsigned long long>(chunk) || per_thread < 2 || per_thread > 32 ||
      !is_pow2(per_thread)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int v = per_thread < chunk ? per_thread : chunk;
  if (chunk / v > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (v) {
    case 2: err = launch_finish<2>(in, out, n_chunks, chunk, size, st); break;
    case 4: err = launch_finish<4>(in, out, n_chunks, chunk, size, st); break;
    case 8: err = launch_finish<8>(in, out, n_chunks, chunk, size, st); break;
    case 16: err = launch_finish<16>(in, out, n_chunks, chunk, size, st); break;
    case 32: err = launch_finish<32>(in, out, n_chunks, chunk, size, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// Shared bytes a launch of finish_kernel takes: what bitonic_cuda.finish_shape
// must agree with.
extern "C" long long finish_shared_launch_bytes(int chunk, int per_thread) {
  return static_cast<long long>(finish_shared_bytes(chunk, per_thread < chunk ? per_thread : chunk));
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
