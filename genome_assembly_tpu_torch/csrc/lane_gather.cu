// Row-wise lane gather for Hopper (sm_90a): out[r, c] = x[r, idx[r, c]].
//
// Replaces the TPU kernel of the JAX package's primitive probe,
// tools/bench_prims.py::gk (launched by its pallas_gather): a whole
// [rows, cols] block in VMEM, out = take_along_axis(x, idx, axis=1).  Same
// function on any number of rows; 32-bit values with int32 indices (the
// probe's uint32 bits held in int32) or 64-bit values with int64 indices
// (the port's keys).  The caller keeps 0 <= idx < cols; an index outside a
// row is never dereferenced here (its output is 0), and the wrapper's
// dispatcher refuses such indices before it launches.
//
// Bound: bytes.  x and idx are read once and out written once, three arrays
// of one element size; the gather does no arithmetic worth counting.  A
// random gather straight from device memory would move a 32-byte sector for
// every 4 or 8 bytes it uses, so the design keeps every global access
// coalesced and does the random part in shared memory:
//
//   * a block takes a tile of whole rows: as many consecutive rows as fit
//     kTileBytes (at least one row), which lie back to back in memory, but
//     no more than leave kBlocksPerSm tiles for every multiprocessor, so a
//     small array (the probe's [256, 128]) still spreads over the card;
//   * its threads copy the tile's x into shared memory, neighbouring
//     threads on neighbouring elements;
//   * after one barrier each thread reads its elements' indices (coalesced),
//     gathers from the staged row (the random access, in shared memory) and
//     stores (coalesced).  A thread walks its elements with a stride of the
//     block's size and keeps its (row, column) by subtraction, not division.
//
// A row wider than kMaxStagedBytes (48 KB: 12,288 int32 or 6,144 int64
// columns) is not staged: that launch gathers straight from device memory,
// still with coalesced index loads and stores.  Blocks stride over the
// tiles, so any number of rows fits the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTileBytes = 16 * 1024;      // shared memory a block stages
constexpr long long kMaxStagedBytes = 48 * 1024;  // widest row that is staged
constexpr long long kMaxBlocks = 1 << 20;
constexpr long long kBlocksPerSm = 4;

template <typename T, typename I, bool kStaged>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ x, const I* __restrict__ idx, T* __restrict__ out,
                   long long rows, int cols, int rows_per_tile) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* staged = reinterpret_cast<T*>(shared_raw);
  const long long n_tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * rows_per_tile;
    const long long tile_rows = rows - r0 < rows_per_tile ? rows - r0 : rows_per_tile;
    const long long n = tile_rows * cols;
    const long long base = r0 * cols;
    if (kStaged) {
      for (long long e = threadIdx.x; e < n; e += kThreads) staged[e] = x[base + e];
      __syncthreads();
    }
    // (row, column) of element e = threadIdx.x, then of e += kThreads
    long long row = threadIdx.x / cols;
    long long col = threadIdx.x % cols;
    const long long step_rows = kThreads / cols;
    const long long step_cols = kThreads % cols;
    for (long long e = threadIdx.x; e < n; e += kThreads) {
      const long long j = static_cast<long long>(idx[base + e]);
      T v = T(0);
      if (j >= 0 && j < cols) {
        v = kStaged ? staged[row * cols + j] : x[base + row * cols + j];
      }
      out[base + e] = v;
      row += step_rows;
      col += step_cols;
      if (col >= cols) {
        col -= cols;
        row += 1;
      }
    }
    if (kStaged) __syncthreads();  // the next tile overwrites the staged rows
  }
}

template <typename T, typename I>
cudaError_t launch(const void* x, const void* idx, void* out, long long rows, int cols,
                   int sms, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(cols) * sizeof(T);
  const bool staged = row_bytes <= kMaxStagedBytes;
  long long rows_per_tile = staged ? kTileBytes / row_bytes : kTileBytes / sizeof(T) / cols;
  const long long spread = (rows + kBlocksPerSm * sms - 1) / (kBlocksPerSm * sms);
  if (rows_per_tile > spread) rows_per_tile = spread;
  if (rows_per_tile < 1) rows_per_tile = 1;
  if (rows_per_tile > rows) rows_per_tile = rows;
  const long long n_tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const int blocks = static_cast<int>(n_tiles < kMaxBlocks ? n_tiles : kMaxBlocks);
  const T* xs = static_cast<const T*>(x);
  const I* is = static_cast<const I*>(idx);
  T* os = static_cast<T*>(out);
  if (staged) {
    const size_t shared = static_cast<size_t>(rows_per_tile * row_bytes);
    lane_gather_kernel<T, I, true><<<blocks, kThreads, shared, stream>>>(
        xs, is, os, rows, cols, static_cast<int>(rows_per_tile));
  } else {
    lane_gather_kernel<T, I, false><<<blocks, kThreads, 0, stream>>>(
        xs, is, os, rows, cols, static_cast<int>(rows_per_tile));
  }
  return cudaGetLastError();
}

}  // namespace

// Columns of the widest row whose launch stages it in shared memory.
extern "C" long long lane_gather_max_staged_cols(int elem_bytes) {
  return elem_bytes > 0 ? kMaxStagedBytes / elem_bytes : 0;
}

// out[r, c] = x[r, idx[r, c]] over [rows, cols] contiguous arrays on the
// calling thread's current card, which has `sms` multiprocessors; elem_bytes
// 4 (int32 values, int32 indices) or 8 (int64 values, int64 indices);
// `stream` a stream of that card.  The caller (lane_gather_op.cpp) makes the
// card current and reads its multiprocessors once.  Returns a cudaError_t
// (0: launched).
extern "C" int lane_gather_launch(const void* x, const void* idx, void* out, long long rows,
                                  int cols, int elem_bytes, int sms, void* stream) {
  if (rows < 1 || cols < 1 || sms < 1 || (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = elem_bytes == 4
      ? launch<int32_t, int32_t>(x, idx, out, rows, cols, sms, st)
      : launch<long long, long long>(x, idx, out, rows, cols, sms, st);
  return static_cast<int>(err);
}
