// Keys-only merge-path sort passes for Hopper (sm_90a) on one int64 key.
//
// Two kernels.  Each replaces a TPU kernel of the JAX package's
// genome_assembly_tpu/ops/mergepath_pallas.py:
//
//   local_merge_kernel  _local_merge_kernel (wrapper _local_merge_pass): inside
//                       every block of `chunk` keys, the Batcher odd-even merge
//                       levels the caller lists (2 base_run .. chunk), fused
//                       between one load and one store of the chunk.
//   merge_pass_kernel   _merge_kernel (wrapper _merge_pass): one merge level
//                       run -> 2 run in ONE pass over the array.  Output tile i
//                       (T keys) is the first T keys of the merge of the windows
//                       A[a0 : a0 + T) and B[b0 : b0 + T) of its run pair, each
//                       read as +inf at and past its run's end; (a0, b0) is the
//                       tile's merge-path split, found outside the kernel
//                       (ops/mergepath_sort.py::merge_splits).
//
// Same functions, other form.  The TPU kernels hold a key as two uint32 lanes
// in a [rows, width] layout, shift the flat array with lane and sublane rolls
// to meet a partner or to align a window, copy whole 8-row groups (hence pad
// rows behind the array) and get the splits as prefetched scalars.  Here a key
// is one signed int64 (real keys are < 2^62, padding and the +inf mask are
// int64 max, so signed order is the lane order), the array is flat, positions
// are 64-bit, a block loads its own two split values, and every load is
// guarded by its run's end: nothing outside the array is read, so there are no
// pad rows.
//
// local_merge_kernel.  Design: the odd-even network in place in shared memory,
// one thread per pair, one block barrier per stage -- the stage structure of
// bitonic.cu with another partner rule and no direction bit.  Stage k == m of
// level 2 m pairs p with p + m where (p & m) == 0; a stage k < m pairs p with
// p + k where (p & k) == k and (p & (2 m - 1)) + k < 2 m; the lower position
// keeps the smaller key.  Chosen over per-level merge-path merges between two
// shared-memory buffers because it holds a chunk of 2^14 keys (one buffer of
// 128 KB, not two of 64 KB), which saves one merge_pass over the array, and
// because it equals its plain tensor version on ANY input, not only on
// ascending runs.  The price is sum(log2 L) stages (50 for runs of 2^10 in a
// chunk of 2^14) where merges would take log2(chunk / base_run) rounds.
// What bounds it: it moves 16 bytes a key through device memory once, but is
// bound by its stages' shared-memory traffic and barriers, like finish_kernel.
//
// merge_pass_kernel.  One block per output tile.  The block loads the real part
// of both windows into shared memory with coalesced 8-byte loads (the windows
// start anywhere, so nothing wider) and fills the rest with +inf.  Thread t
// then owns the V consecutive outputs from the tile's diagonal t V: a binary
// search in the two shared windows for the largest j with A[j-1] <= B[tV-j]
// (equal keys of A first, the rule of merge_splits), then V sequential merge
// steps with the two heads in registers.  The results wait in registers for a
// barrier, go back to shared memory (skewed by one key in 16, so that threads
// V keys apart hit different banks) and are stored coalesced.  Since t V + V <=
// T, neither head index leaves its window during the steps: no bound checks.
// What bounds it: bytes, 16 a key and pass.  Not yet at that bound: every tile
// loads 2 T keys to write T (the second read of a key comes from a tile next
// door and mostly from L2), the sequential steps read shared memory at
// data-dependent addresses (bank conflicts, not measured), and load, merge and
// store of a block do not overlap.
//
// A difference of the card: the chunk is at most 2^14 keys where the TPU's is
// 2^17, so a sort has three more merge_pass levels here than there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long sort_key;             // one int64 key
typedef unsigned long long position;    // global index, run length

constexpr sort_key kSentinel = 0x7FFFFFFFFFFFFFFFll;  // +inf; the padding key
constexpr int kMaxChunkKeys = 1 << 14;  // local_merge: 128 KB of the block's 227 KB
constexpr int kMaxTileKeys = 1 << 13;   // merge_pass: two windows, 16 bytes a tile key
constexpr int kMaxBlocks = 132 * 16;    // local_merge strides over its chunks
constexpr int kLocalMergeThreads = 1024;  // of a local_merge block, one pair a thread at most

// One stage of merge level `window` over `len` keys in shared memory (a whole
// number of windows).  Pair q is (i, i + k): for k == m, i is q with a zero
// bit inserted at k's position; for k < m the same moved up by k, which is
// the upper half of a block of 2 k keys meeting the lower half of the next
// block, dropped where that block lies in the next window.
__device__ __forceinline__ void merge_stage(sort_key* s, int len, int k, int window) {
  const int shift = 2 * k == window ? 0 : k;
  for (int q = threadIdx.x; q < len / 2; q += blockDim.x) {
    const int i = 2 * q - (q & (k - 1)) + shift;
    if ((i & (window - 1)) + k < window) {
      const sort_key a = s[i];
      const sort_key b = s[i + k];
      if (a > b) {
        s[i] = b;
        s[i + k] = a;
      }
    }
  }
  __syncthreads();
}

// `in` and `out` may be the same buffer: a chunk is read and written by the
// one block that owns it.  level_mask: bit b set <=> level 2^b, ascending.
__global__ void __launch_bounds__(1024)
local_merge_kernel(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
                   unsigned int level_mask) {
  extern __shared__ sort_key s[];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const size_t base = static_cast<size_t>(c) * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      s[i] = in[base + i];
    }
    __syncthreads();
    for (int window = 2; window <= chunk; window <<= 1) {
      if (level_mask & static_cast<unsigned int>(window)) {
        for (int k = window / 2; k >= 1; k >>= 1) {
          merge_stage(s, chunk, k, window);
        }
      }
    }
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      out[base + i] = s[i];
    }
    __syncthreads();  // the block's next chunk overwrites the shared keys
  }
}

// Where key p of the tile waits in shared memory for its store.
__device__ __forceinline__ int staged(int p) { return p + (p >> 4); }

// `out` must not overlap `in`: a tile reads from anywhere in its run pair.
// a0, b0: [n_tiles] start of each tile's windows, inside or at the end of its
// runs (a start outside is read as an empty window).  blockDim.x * V == tile.
template <int V>
__global__ void __launch_bounds__(1024)
merge_pass_kernel(const sort_key* in, sort_key* out, const long long* a0, const long long* b0,
                  long long n_tiles, int tile, unsigned long long run) {
  extern __shared__ sort_key s[];
  sort_key* sa = s;          // window of A, then the staged results
  sort_key* sb = s + tile + (tile >> 4);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const position first = static_cast<position>(t) * tile;
    const position a_begin = first / (2 * run) * (2 * run);
    const position a_end = a_begin + run;
    const position b_end = a_end + run;
    const position a_at = static_cast<position>(a0[t]);
    const position b_at = static_cast<position>(b0[t]);
    int a_len = 0, b_len = 0;
    if (a_at >= a_begin && a_at < a_end) {
      a_len = a_end - a_at < static_cast<position>(tile) ? static_cast<int>(a_end - a_at) : tile;
    }
    if (b_at >= a_end && b_at < b_end) {
      b_len = b_end - b_at < static_cast<position>(tile) ? static_cast<int>(b_end - b_at) : tile;
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      sa[i] = i < a_len ? in[a_at + i] : kSentinel;
      sb[i] = i < b_len ? in[b_at + i] : kSentinel;
    }
    __syncthreads();

    // the split of this thread's diagonal: the largest j in [0, d] with
    // j == 0 or A[j-1] <= B[d-j]  (d < tile, so both indices stay inside)
    const int d = threadIdx.x * V;
    int lo = 0, hi = d;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sa[mid - 1] <= sb[d - mid]) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    int ia = lo, ib = d - lo;
    sort_key head_a = sa[ia];
    sort_key head_b = sb[ib];
    sort_key merged[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // ia + ib == d + v <= tile - 1 before the step; after the thread's last
      // step a head index may reach `tile`, which the skewed layout still holds
      if (head_a <= head_b) {
        merged[v] = head_a;
        head_a = sa[++ia];
      } else {
        merged[v] = head_b;
        head_b = sb[++ib];
      }
    }
    __syncthreads();  // every thread has read its keys: the windows may go
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sa[staged(d + v)] = merged[v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      out[first + i] = sa[staged(i)];
    }
    __syncthreads();  // the block's next tile overwrites the shared keys
  }
}

bool is_pow2(unsigned long long x) { return x != 0 && (x & (x - 1)) == 0; }

// shared bytes of a merge_pass block: two windows, each with room for the
// skew of the staged results and for a head index one past the window
size_t merge_pass_bytes(int tile) {
  return 2 * static_cast<size_t>(tile + (tile >> 4) + 1) * sizeof(sort_key);
}

template <int V>
cudaError_t launch_merge_pass(const sort_key* in, sort_key* out, const long long* a0,
                              const long long* b0, long long n_tiles, int tile,
                              unsigned long long run, cudaStream_t stream) {
  const size_t bytes = merge_pass_bytes(tile);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        merge_pass_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int blocks = n_tiles < 0x7FFFFFFFll ? static_cast<int>(n_tiles) : 0x7FFFFFFF;
  merge_pass_kernel<V><<<blocks, tile / V, bytes, stream>>>(in, out, a0, b0, n_tiles, tile, run);
  return cudaGetLastError();
}

}  // namespace

// Every launcher launches on `stream`, allocates nothing and synchronises
// nothing.  It returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes its kernel does not take.

extern "C" int mergepath_max_chunk_keys() { return kMaxChunkKeys; }
extern "C" int mergepath_max_tile_keys() { return kMaxTileKeys; }

extern "C" int local_merge_launch(const void* in, void* out, long long n_chunks, int chunk,
                                  unsigned int level_mask, void* stream) {
  // levels 2 .. chunk; bit 0 names no level
  if (n_chunks < 1 || chunk < 2 || chunk > kMaxChunkKeys || !is_pow2(chunk) ||
      (level_mask & 1u) || level_mask >= 2u * static_cast<unsigned int>(chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int useful = chunk / 2 < 32 ? 32 : chunk / 2;  // one pair a thread at most
  const int block_threads = kLocalMergeThreads < useful ? kLocalMergeThreads : useful;
  const int blocks = n_chunks < kMaxBlocks ? static_cast<int>(n_chunks) : kMaxBlocks;
  const size_t bytes = static_cast<size_t>(chunk) * sizeof(sort_key);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        local_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  local_merge_kernel<<<blocks, block_threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(in), static_cast<sort_key*>(out), n_chunks, chunk,
      level_mask);
  return static_cast<int>(cudaGetLastError());
}

// per_thread: outputs one thread merges (2, 4 or 8); the block has
// tile / per_thread threads.
extern "C" int merge_pass_launch(const void* in, void* out, const void* a0, const void* b0,
                                 long long n_tiles, int tile, unsigned long long run,
                                 int per_thread, void* stream) {
  if (n_tiles < 1 || tile < 2 || tile > kMaxTileKeys || !is_pow2(tile) || !is_pow2(run) ||
      run < static_cast<unsigned long long>(tile) || in == out ||
      per_thread > tile || tile / per_thread > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sort_key* src = static_cast<const sort_key*>(in);
  sort_key* dst = static_cast<sort_key*>(out);
  const long long* a = static_cast<const long long*>(a0);
  const long long* b = static_cast<const long long*>(b0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (per_thread) {
    case 2: err = launch_merge_pass<2>(src, dst, a, b, n_tiles, tile, run, st); break;
    case 4: err = launch_merge_pass<4>(src, dst, a, b, n_tiles, tile, run, st); break;
    case 8: err = launch_merge_pass<8>(src, dst, a, b, n_tiles, tile, run, st); break;
    default: break;
  }
  return static_cast<int>(err);
}
