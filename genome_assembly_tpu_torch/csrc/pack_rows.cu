// K0, the fast-mode row packer for Hopper (sm_90a): a batch of reads given
// as their ASCII bases one after another becomes the zero-padded rows of
// 2-bit codes that the fused scan (fast_scan.cu) reads.
//
// Replaces no TPU kernel: the JAX package pads and encodes its batches on
// the host (io/reads.py::batch_reads), and so did this port.  On the host
// that took more of an assembly than every kernel together (two index
// arrays of 8 bytes a base and a scatter into the padded rows), and the
// padding crossed to the card with the bases.  So the host now sends each
// batch's bases unpadded, with the lengths and their exclusive sum (the
// start of each read among the bases), and this kernel builds the rows.
//
// Function: row r of `codes` is table[bases[starts[r] + c]] for c below
// lengths[r] and 0 from there to the row's end.  The 256-entry table is
// passed in (ops/encode.py::_ASCII_TO_CODE, the host's own: lowercase acgt
// as uppercase, any other byte as 3).  Starts and lengths are int32: a
// batch holds fewer than 2^31 bases (the wrapper checks).
//
// Bound: bytes.  Each base is read once and each row byte written once
// (plus 8 bytes a row of starts and lengths); a byte costs a table look-up
// and a shift.  The design:
//
//   * one warp a row, eight rows a block, no barrier after the table is in
//     shared memory; rows share nothing.
//   * a lane owns four neighbouring columns: four byte loads from the
//     bases (a read starts anywhere, so they are not aligned), looked up in
//     shared memory and put together into one 4-byte store, so a warp
//     stores 128 contiguous bytes an instruction.  Rows whose width is not
//     a multiple of 4 store byte by byte.
//   * a column at or past the row's length is written 0, so the rows need
//     no zeroed buffer; a length is clamped to [0, width] and a base is
//     read only inside the bases, whatever the inputs hold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsABlock = 8;             // warps of a block: one row each
constexpr int kThreads = 32 * kRowsABlock;  // also the table's entries
constexpr int kColsALane = 4;
constexpr int kColsAWarp = 32 * kColsALane;

static_assert(kThreads == 256, "one table entry a thread");

__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const uint8_t* __restrict__ bases, long long n_bases,
                 const int32_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ table, uint8_t* __restrict__ codes,
                 int n, int width, int word_stores) {
  __shared__ uint8_t lut[kThreads];
  lut[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsABlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const long long start = starts[row];
  int len = lengths[row];
  len = len < 0 ? 0 : (len > width ? width : len);
  uint8_t* out = codes + row * width;
  for (int c = kColsALane * lane; c < width; c += kColsAWarp) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kColsALane; ++j) {
      const long long p = start + c + j;
      if (c + j < len && p >= 0 && p < n_bases) {
        word |= static_cast<uint32_t>(lut[__ldg(bases + p)]) << (8 * j);
      }
    }
    if (word_stores) {
      *reinterpret_cast<uint32_t*>(out + c) = word;
    } else {
#pragma unroll
      for (int j = 0; j < kColsALane; ++j) {
        if (c + j < width) out[c + j] = static_cast<uint8_t>(word >> (8 * j));
      }
    }
  }
}

}  // namespace

extern "C" int pack_rows_launch(const void* bases, long long n_bases, const void* starts,
                                const void* lengths, const void* table, void* codes,
                                int n, int width, void* stream) {
  if (n < 1 || width < 1 || n_bases < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int word_stores =
      (width % kColsALane == 0) && (reinterpret_cast<uintptr_t>(codes) % kColsALane == 0);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kRowsABlock - 1) /
                                                kRowsABlock);
  pack_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), n_bases, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lengths), static_cast<const uint8_t*>(table),
      static_cast<uint8_t*>(codes), n, width, word_stores);
  return static_cast<int>(cudaGetLastError());
}
