// Keys-only merge-path sort passes for Hopper (sm_90a) on one int64 key.
//
// Three kernels.  The first two replace a TPU kernel of the JAX package's
// genome_assembly_tpu/ops/mergepath_pallas.py each; the third replaces that
// module's merge_splits, which is plain tensor code there.
//
//   local_merge_kernel   _local_merge_kernel (wrapper _local_merge_pass): inside
//                        every block of `chunk` keys, ascending runs of
//                        `base_run` keys become ascending runs of `top` keys
//                        (the merge levels 2 base_run .. top), fused between
//                        one load and one store of the chunk.
//   merge_pass_kernel    _merge_kernel (wrapper _merge_pass): one merge level
//                        run -> 2 run in ONE pass over the array.  Output tile
//                        t (T keys) is the merge of A[a0[t] : a0[t+1]) and
//                        B[b0[t] : b0[t+1]) of its run pair A | B; (a0, b0) is
//                        the tile's merge-path split.
//   merge_splits_kernel  merge_splits: for every output tile of one merge level
//                        the merge-path crossing on the tile's diagonal.
//
// Same functions, other form.  The TPU kernels hold a key as two uint32 lanes
// in a [rows, width] layout, shift the flat array with lane and sublane rolls
// to meet a partner or to align a window, copy whole 8-row groups (hence pad
// rows behind the array), merge by the Batcher odd-even network and get the
// splits as prefetched scalars.  Here a key is one signed int64 (real keys are
// < 2^62, padding is int64 max, so signed order is the lane order), the array
// is flat, positions are 64-bit, a block loads its own split values, and a
// merge is the serial two-heads merge of a thread's own piece of the output:
// on ascending runs it gives what the network gives, equal keys being
// indistinguishable.
//
// The merge step, shared by the first two kernels (block_sort.cuh:
// diagonal_split, merge_steps).  A thread owns V consecutive outputs from
// diagonal d of a pair of ascending segments A (la keys) and B (lb keys) in
// shared memory.  It finds where the diagonal crosses the merge path by binary
// search, then takes V times the smaller head.  Nothing pads the segments, and
// real keys may equal the padding key, so the heads are guarded by INDEX, never
// by value; a head past its segment is never read.  The V results wait in
// registers for a barrier and then go to shared memory, skewed by one key in 16
// so that threads V keys apart hit different banks.
//
// local_merge_kernel.  The block merge sort of block_sort.cuh, which the row
// sort and the chunk sort of bitonic.cu run too: one chunk (at most 2^14 keys)
// in ONE shared buffer in the skewed layout, chunk / V threads, V keys a thread
// (16 for a full chunk: 1024 threads), the levels up to V in registers, then a
// round per level.  Runs of 2^10 in a chunk of 2^14 take 4 rounds (8 barriers);
// from base_run 1 the kernel is a whole chunk sort (the register levels and 10
// rounds).  The rounds equal the odd-even network only on valid input (runs of
// base_run ascending), which is all the sort sends.
// What bounds it: it moves 16 bytes a key through device memory once; its
// time is the rounds' shared-memory latency (a dependent load a merge step)
// under one block an SM.
//
// merge_pass_kernel.  One block per output tile.  Tile t ends where tile t + 1
// of the same run pair begins, the pair's last tile at the runs' ends, so the
// block loads exactly T keys: A[a0 : a1) and B[b0 : b1) back to back into one
// shared buffer with coalesced 8-byte loads (a split is aligned to nothing
// wider).  Then the merge step above with la = a1 - a0, lb = b1 - b0, and a
// coalesced store of the staged results.  The kernel trusts its splits: a
// start outside its run, an end before its start or segments longer than a
// tile together are cut to what lies inside, so nothing outside the run pair
// or the shared buffer is ever read; the output of such a tile means nothing.
// What bounds it: bytes, 16 a key and pass.
//
// merge_splits_kernel.  One thread per tile; the same search on the tile's
// diagonal over the whole runs in device memory: at most ceil(log2(run)) + 1
// steps of two independent 8-byte loads.  What bounds it: one chain of
// dependent load latencies; all tiles search at once.
//
// A difference of the card: the chunk is at most 2^14 keys where the TPU's is
// 2^17, so a sort has three more merge_pass levels here than there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

using namespace block_sort;  // sort_key, position, staged, diagonal_split, merge_steps, sort_blocks

constexpr int kMaxChunkKeys = kMaxBlockKeys;  // local_merge: one chunk a block
constexpr int kMaxTileKeys = 1 << 13;   // merge_pass: 8.5 bytes a tile key
constexpr int kSplitThreads = 256;      // of a merge_splits block

// `in` and `out` may be the same buffer: a chunk is read and written by the
// one block that owns it.  blockDim.x * V == chunk; base_run < top <= chunk,
// powers of two.
template <int V>
__global__ void __launch_bounds__(BLOCK_SORT_MAX_THREADS(kMaxChunkKeys, V))
local_merge_kernel(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
                   int base_run, int top) {
  extern __shared__ sort_key s[];
  sort_blocks<V, false>(s, in, out, static_cast<size_t>(n_chunks) * chunk, base_run, top);
}

// x cut into [low, high]
__device__ __forceinline__ position cut(position x, position low, position high) {
  return x < low ? low : (x > high ? high : x);
}

// `out` must not overlap `in`: a tile reads from anywhere in its run pair.
// a0, b0: [n_tiles] start of each tile's segments.  blockDim.x * V == tile.
template <int V>
__global__ void __launch_bounds__(BLOCK_SORT_MAX_THREADS(kMaxTileKeys, V))
merge_pass_kernel(const sort_key* in, sort_key* out, const long long* a0, const long long* b0,
                  long long n_tiles, int tile, unsigned long long run) {
  extern __shared__ sort_key s[];
  const position tiles_a_pair = 2 * run / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const position first = static_cast<position>(t) * tile;
    const position a_begin = first / (2 * run) * (2 * run);
    const position a_end = a_begin + run;
    const position b_end = a_end + run;
    const bool last = (static_cast<position>(t) + 1) % tiles_a_pair == 0;
    // a start outside its run, an end before its start: an empty segment
    const position a_at = cut(static_cast<position>(a0[t]), a_begin, a_end);
    const position b_at = cut(static_cast<position>(b0[t]), a_end, b_end);
    const position a_to = last ? a_end : cut(static_cast<position>(a0[t + 1]), a_at, a_end);
    const position b_to = last ? b_end : cut(static_cast<position>(b0[t + 1]), b_at, b_end);
    const position tile_keys = static_cast<position>(tile);
    const int la = static_cast<int>(a_to - a_at < tile_keys ? a_to - a_at : tile_keys);
    const int lb = static_cast<int>(b_to - b_at < tile_keys - la ? b_to - b_at : tile_keys - la);
    // blockDim.x * V == tile >= la + lb: V coalesced loads in flight
    sort_key merged[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = threadIdx.x + v * blockDim.x;
      if (i < la + lb) merged[v] = i < la ? in[a_at + i] : in[b_at + (i - la)];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = threadIdx.x + v * blockDim.x;
      if (i < la + lb) s[i] = merged[v];
    }
    __syncthreads();

    const int d = threadIdx.x * V;
    auto a = [&](int i) { return s[i]; };
    auto b = [&](int i) { return s[la + i]; };
    const int j = diagonal_split(d, la, lb, a, b);
    merge_steps<V>(merged, j, d - j, la, lb, a, b);
    __syncthreads();  // every thread has read its keys: the segments may go
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s[staged<V>(d + v)] = merged[v];
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[first + threadIdx.x + v * blockDim.x] = s[staged<V>(threadIdx.x + v * blockDim.x)];
    }
    __syncthreads();  // the block's next tile overwrites the shared keys
  }
}

// Tile t of the output of one merge level starts at out0 = t * tile, on
// diagonal d = out0 - base of its run pair A = key[base : base + run), B =
// key[base + run : base + 2 run).  a0 = base + j, b0 = base + run + d - j for
// the largest j in [max(0, d - run), min(d, run)] with j at its lower end or
// A[j-1] <= B[d-j]; aend and bend are the runs' ends.
__global__ void __launch_bounds__(kSplitThreads)
merge_splits_kernel(const sort_key* key, long long* a0, long long* b0, long long* aend,
                    long long* bend, long long n_tiles, int tile, unsigned long long run) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  const position out0 = static_cast<position>(t) * tile;
  const position base = out0 / (2 * run) * (2 * run);
  const position d = out0 - base;
  const sort_key* a_keys = key + base;
  const sort_key* b_keys = a_keys + run;
  position lo = d > run ? d - run : 0;
  position hi = d < run ? d : run;
  while (lo < hi) {
    const position mid = (lo + hi + 1) >> 1;
    if (a_keys[mid - 1] <= b_keys[d - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  a0[t] = static_cast<long long>(base + lo);
  b0[t] = static_cast<long long>(base + run + (d - lo));
  aend[t] = static_cast<long long>(base + run);
  bend[t] = static_cast<long long>(base + 2 * run);
}

template <int V>
cudaError_t launch_local_merge(const sort_key* in, sort_key* out, long long n_chunks, int chunk,
                               int base_run, int top, cudaStream_t stream) {
  const size_t bytes = staged_bytes(chunk);
  cudaError_t err = allow_shared(local_merge_kernel<V>, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = grid_blocks(static_cast<size_t>(n_chunks) * chunk, chunk);
  local_merge_kernel<V><<<blocks, chunk / V, bytes, stream>>>(in, out, n_chunks, chunk, base_run,
                                                             top);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_merge_pass(const sort_key* in, sort_key* out, const long long* a0,
                              const long long* b0, long long n_tiles, int tile,
                              unsigned long long run, cudaStream_t stream) {
  const size_t bytes = staged_bytes(tile);
  cudaError_t err = allow_shared(merge_pass_kernel<V>, bytes);
  if (err != cudaSuccess) return err;
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

// Ascending runs of base_run keys -> ascending runs of top keys inside every
// chunk.  per_thread: keys one thread owns (2 .. 32); the block has
// chunk / per_thread threads.
extern "C" int local_merge_launch(const void* in, void* out, long long n_chunks, int chunk,
                                  int base_run, int top, int per_thread, void* stream) {
  if (n_chunks < 1 || chunk < 2 || chunk > kMaxChunkKeys || !is_pow2(chunk) || base_run < 1 ||
      !is_pow2(base_run) || !is_pow2(top) || top <= base_run || top > chunk ||
      per_thread > chunk || chunk / per_thread > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sort_key* src = static_cast<const sort_key*>(in);
  sort_key* dst = static_cast<sort_key*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (per_thread) {
    case 2: err = launch_local_merge<2>(src, dst, n_chunks, chunk, base_run, top, st); break;
    case 4: err = launch_local_merge<4>(src, dst, n_chunks, chunk, base_run, top, st); break;
    case 8: err = launch_local_merge<8>(src, dst, n_chunks, chunk, base_run, top, st); break;
    case 16: err = launch_local_merge<16>(src, dst, n_chunks, chunk, base_run, top, st); break;
    case 32: err = launch_local_merge<32>(src, dst, n_chunks, chunk, base_run, top, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// per_thread: outputs one thread merges (2, 4, 8 or 16); the block has
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
    case 16: err = launch_merge_pass<16>(src, dst, a, b, n_tiles, tile, run, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// The four [n_tiles] int64 outputs of merge_splits for one merge level.
extern "C" int merge_splits_launch(const void* key, void* a0, void* b0, void* aend, void* bend,
                                   long long n_tiles, int tile, unsigned long long run,
                                   void* stream) {
  if (n_tiles < 1 || tile < 2 || !is_pow2(tile) || !is_pow2(run) ||
      run < static_cast<unsigned long long>(tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_tiles + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  merge_splits_kernel<<<static_cast<int>(blocks), kSplitThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sort_key*>(key), static_cast<long long*>(a0),
      static_cast<long long*>(b0), static_cast<long long*>(aend), static_cast<long long*>(bend),
      n_tiles, tile, run);
  return static_cast<int>(cudaGetLastError());
}
