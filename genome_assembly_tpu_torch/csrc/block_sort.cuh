// The block merge sort: one device routine for three kernels on one int64 key.
//
//   sort_rows_kernel    (bitonic.cu)    every row of [rows, C] ascending
//   chunk_sort_kernel   (bitonic.cu)    every run of s keys sorted, ascending or
//                                       descending by the run's global position
//   local_merge_kernel  (mergepath.cu)  ascending runs of base_run keys become
//                                       ascending runs of top keys
//
// All three are `sort_blocks`: a block takes blockDim.x * V consecutive keys of
// the flat array (block_keys, a power of two, at most 2^14, a multiple of top)
// into ONE shared buffer, turns ascending runs of base_run keys into ascending
// runs of top keys there, and writes them back; a run is found by position
// masks, so the merges never cross a multiple of top.  The loads and stores
// are guarded by the array's end, so the array need not be a whole number of
// blocks (it is a whole number of runs of top keys): what a block holds past
// the end is padding that is merged among itself only and never stored.
//
// The layout.  Key p of the block lies at staged<V>(p): one key of room after
// every 16 (32 where a thread owns 32), so that the first keys of neighbouring
// threads, V keys apart, fall into different banks.
//
// The sort.  Runs shorter than V are merged in registers, each thread on its
// own V keys, by the compile-time odd-even merge levels 2 base_run .. min(V,
// top).  Then one round per level run -> 2 run: every thread finds by binary
// search where diagonal d of its run pair A | B crosses the merge path (the
// largest j in [max(0, d - lb), min(d, la)] with j at its lower end or A[j-1]
// <= B[d-j]: equal keys of A first), takes V times the smaller head into
// registers, barrier, writes its V results back in place, barrier.  Nothing
// pads the runs, and real keys may equal the padding key, so the heads are
// guarded by INDEX, never by value: take from A iff B is used up, or A is not
// and head_a <= head_b; a head past its segment is never read.  Sorting 2^14
// keys from single keys takes the register levels to 16 and 10 rounds (20
// barriers) where a bitonic network takes 105 barrier-separated stages.
//
// What bounds it.  Device memory moves 16 bytes a key once: a quarter of the
// time where a block of 2^14 keys has its SM alone and nothing overlaps its
// loads and stores; blocks of 4096 keys, several an SM, hide most of it.  The
// rest is the rounds: per key and round one dependent shared-memory load at a
// data-dependent bank and some thirty 32-bit instructions (the 64-bit compare
// and selects, the index guards, the skewed addresses), about 0.3 to 0.65 ms a
// round over 2^28 keys on an H100.  Tried there and taken out again: the next
// key of both heads fetched a step ahead (14 to 29 % slower), heads guarded by
// the padding value instead of the index (1 % faster), the rounds up to 32 V
// keys as a bitonic merge across a warp's registers by shuffle (no faster, 64
// registers).  Keys are values only and equal keys are indistinguishable, so
// on ascending runs the result is what a merge network gives, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace block_sort {

typedef long long sort_key;             // one int64 key
typedef unsigned long long position;    // global index, run length

constexpr int kMaxBlockKeys = 1 << 14;  // 136 KB of the block's 227 KB, skew included
constexpr int kMaxBlocks = 132 * 16;    // grid cap: the kernels stride over their blocks of keys
constexpr sort_key kPadKey = 0x7FFFFFFFFFFFFFFFll;  // what a block holds past the array's end

// Where key p of a block or tile lies in the skewed layout.
template <int V>
__device__ __forceinline__ int staged(int p) { return p + (p >> (V > 16 ? 5 : 4)); }

// bytes of shared memory for `keys` keys in the skewed layout, one to spare
inline size_t staged_bytes(int keys) {
  return static_cast<size_t>(keys + (keys >> 4) + 1) * sizeof(sort_key);
}

// the most threads a block of V keys a thread can have for `keys` keys
#define BLOCK_SORT_MAX_THREADS(keys, V) ((keys) / (V) > 1024 ? 1024 : (keys) / (V))

inline bool is_pow2(unsigned long long x) { return x != 0 && (x & (x - 1)) == 0; }

// Raises the kernel's dynamic shared-memory limit where it needs more than the
// 48 KB every kernel may use.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The largest j in [max(0, d - lb), min(d, la)] with j at the lower end or
// a(j - 1) <= b(d - j): how many keys of A precede diagonal d of the merge.
template <typename ReadA, typename ReadB>
__device__ __forceinline__ int diagonal_split(int d, int la, int lb, ReadA a, ReadB b) {
  int lo = d > lb ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a(mid - 1) <= b(d - mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// V steps of the two-heads merge from (ia, ib); a(i) and b(i) read key i of
// their segment and are called only with i inside it.
template <int V, typename ReadA, typename ReadB>
__device__ __forceinline__ void merge_steps(sort_key (&merged)[V], int ia, int ib, int la, int lb,
                                            ReadA a, ReadB b) {
  sort_key head_a = 0, head_b = 0;
  if (ia < la) head_a = a(ia);
  if (ib < lb) head_b = b(ib);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool from_a = ib >= lb || (ia < la && head_a <= head_b);
    merged[v] = from_a ? head_a : head_b;
    if (from_a) {
      ++ia;
      if (ia < la) head_a = a(ia);
    } else {
      ++ib;
      if (ib < lb) head_b = b(ib);
    }
  }
}

// One compare-exchange of two registers; the lower index keeps the smaller key.
__device__ __forceinline__ void order(sort_key& low, sort_key& high) {
  const sort_key a = low, b = high;
  low = a < b ? a : b;
  high = a < b ? b : a;
}

// The odd-even merge levels 2 base_run .. min(V, top) on a thread's own V keys.  Level
// 2 m: stage k == m pairs p with p + m where (p & m) == 0; a stage k < m pairs p
// with p + k where (p & k) == k and (p & (2 m - 1)) + k < 2 m.  All indices
// are compile-time constants after unrolling: the keys stay in registers.
template <int V>
__device__ __forceinline__ void merge_in_registers(sort_key (&r)[V], int base_run, int top) {
#pragma unroll
  for (int log_window = 1; (1 << log_window) <= V; ++log_window) {
    const int window = 1 << log_window;
    if (window > base_run && window <= top) {
#pragma unroll
      for (int log_k = log_window - 1; log_k >= 0; --log_k) {
        const int k = 1 << log_k;
#pragma unroll
        for (int p = 0; p < V; ++p) {
          const bool pair = 2 * k == window ? (p & k) == 0
                                            : (p & k) == k && (p & (window - 1)) + k < window;
          if (pair) order(r[p], r[(p + k) & (V - 1)]);  // a pair has p + k < V
        }
      }
    }
  }
}

// The block's keys [base, base + blockDim.x * V) of `in` into the layout, the
// padding key for positions from `end` on: V coalesced loads in flight per
// thread, then the stores.  Ends behind a barrier.
template <int V>
__device__ __forceinline__ void load_keys(sort_key* s, const sort_key* in, size_t base,
                                          size_t end) {
  sort_key loaded[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t p = base + threadIdx.x + v * blockDim.x;
    loaded[v] = p < end ? in[p] : kPadKey;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) s[staged<V>(threadIdx.x + v * blockDim.x)] = loaded[v];
  __syncthreads();
}

// Inside the blockDim.x * V keys of `s`, ascending runs of base_run keys
// become ascending runs of top keys; base_run < top, powers of two, top at
// most the block's keys.  Begins behind a barrier, ends behind one.
template <int V>
__device__ __forceinline__ void merge_runs(sort_key* s, int base_run, int top) {
  const int first = threadIdx.x * V;  // of this thread's V keys in the block
  sort_key merged[V];
  if (base_run < V) {
    // only this thread touches these V keys: no barrier before the levels
#pragma unroll
    for (int v = 0; v < V; ++v) merged[v] = s[staged<V>(first + v)];
    merge_in_registers<V>(merged, base_run, top);
#pragma unroll
    for (int v = 0; v < V; ++v) s[staged<V>(first + v)] = merged[v];
    __syncthreads();
  }
  for (int run = base_run < V ? V : base_run; 2 * run <= top; run <<= 1) {
    const int pair_at = first & ~(2 * run - 1);
    const int d = first - pair_at;
    auto a = [&](int i) { return s[staged<V>(pair_at + i)]; };
    auto b = [&](int i) { return s[staged<V>(pair_at + run + i)]; };
    const int j = diagonal_split(d, run, run, a, b);
    merge_steps<V>(merged, j, d - j, run, run, a, b);
    __syncthreads();  // every thread has read its keys: the runs may go
#pragma unroll
    for (int v = 0; v < V; ++v) s[staged<V>(first + v)] = merged[v];
    __syncthreads();
  }
}

// The block's keys out of the layout to [base, min(base + blockDim.x * V,
// end)) of `out`, coalesced.  With kAlternate a run of top keys whose global
// start has the top bit set is written in descending order: the store stays
// coalesced, the read walks the run backwards through the layout.  Ends behind
// a barrier: the block's next keys overwrite the shared ones.
template <int V, bool kAlternate>
__device__ __forceinline__ void store_keys(sort_key* out, const sort_key* s, size_t base,
                                           size_t end, int top) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = threadIdx.x + v * blockDim.x;
    const size_t p = base + i;
    const bool down = kAlternate && (p & static_cast<size_t>(top)) != 0;
    if (p < end) out[p] = s[staged<V>(down ? i ^ (top - 1) : i)];
  }
  __syncthreads();
}

// The body of the three kernels.  `in` and `out` may be the same buffer: a
// block of keys is read whole, before it is written, by the one thread block
// that owns it.  n_keys is a whole number of runs of top keys; blockDim.x * V
// is a power of two and a multiple of top.
template <int V, bool kAlternate>
__device__ __forceinline__ void sort_blocks(sort_key* s, const sort_key* in, sort_key* out,
                                            size_t n_keys, int base_run, int top) {
  const size_t block_keys = static_cast<size_t>(blockDim.x) * V;
  for (size_t base = blockIdx.x * block_keys; base < n_keys; base += gridDim.x * block_keys) {
    load_keys<V>(s, in, base, n_keys);
    merge_runs<V>(s, base_run, top);
    store_keys<V, kAlternate>(out, s, base, n_keys, top);
  }
}

// Grid of a sort_blocks kernel over n_keys keys in blocks of block_keys.
inline int grid_blocks(size_t n_keys, int block_keys) {
  const size_t units = (n_keys + block_keys - 1) / block_keys;
  return units < static_cast<size_t>(kMaxBlocks) ? static_cast<int>(units) : kMaxBlocks;
}

}  // namespace block_sort
