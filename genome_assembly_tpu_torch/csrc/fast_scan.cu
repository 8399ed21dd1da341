// Fused fast-mode scan for Hopper (sm_90a): canonical k-mer key + minimizer
// of every k-window of a padded read batch, in one pass.
//
// Replaces the TPU kernel genome_assembly_tpu/ops/minimizer_pallas.py::
// _scan_kernel (wrapper fast_scan_pallas).  Same function: per m-mer
// position min(m-mer, reverse complement); per window the minimum of those
// over its k-m+1 positions, and the smaller packed value of the k-mer and
// its reverse complement.  Differences of form, not of result: the key is
// one int64 (the TPU kernel writes two uint32 lanes, key = hi << 32 | lo),
// and windows that do not exist (start + k > length) are written as
// sentinels here instead of being masked by the caller afterwards.
//
// Bound: bytes.  The batch is read once (B*L bytes of codes, 4*B of
// lengths) and 12 bytes are written per window slot; the arithmetic is a
// few hundred integer operations per window.  So the design only has to
// keep every intermediate out of device memory and write coalesced: one
// block works on one read at a time, the read's codes and the per-position
// canonical m-mer scores live in shared memory, each thread owns one
// window, packs the k-mer and its reverse complement in two 64-bit
// registers with a loop of k steps, and neighbouring threads store
// neighbouring outputs.  The doubling pyramids and the sparse-table window
// minimum of the TPU kernel served a vector unit; they have no place here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLen = 8192;  // codes + scores: 5 bytes per base of shared memory
// grid cap: 16 resident blocks of 128 threads fill each of an H100's 132
// SMs; the kernel strides over the reads
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
fast_scan_kernel(const uint8_t* __restrict__ codes,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ mmer_out,
                 long long* __restrict__ key_out,
                 int batch, int max_len, int k, int m) {
  extern __shared__ int32_t smem[];
  int32_t* s_canon = smem;                                      // [max_len]
  uint8_t* s_codes = reinterpret_cast<uint8_t*>(smem + max_len);  // [max_len]

  const int n_win = max_len - k + 1;
  const int n_mpos = max_len - m + 1;
  const int wwin = k - m + 1;
  const long long key_sentinel = 0x7FFFFFFFFFFFFFFFLL;
  const int32_t mmer_sentinel = 0x7FFFFFFF;

  for (int row = blockIdx.x; row < batch; row += gridDim.x) {
    const uint8_t* row_codes = codes + static_cast<size_t>(row) * max_len;
    for (int i = threadIdx.x; i < max_len; i += kThreads) {
      s_codes[i] = row_codes[i];
    }
    __syncthreads();

    // phase 1: canonical m-mer score of every m-mer position
    for (int i = threadIdx.x; i < n_mpos; i += kThreads) {
      uint32_t fwd = 0, rc = 0;
      for (int j = 0; j < m; ++j) {
        const uint32_t c = s_codes[i + j];
        fwd = (fwd << 2) | c;
        rc |= (3u - c) << (2 * j);
      }
      s_canon[i] = static_cast<int32_t>(fwd < rc ? fwd : rc);
    }
    __syncthreads();

    // phase 2: one thread per window
    const int len = lengths[row];
    const size_t out_base = static_cast<size_t>(row) * n_win;
    for (int w = threadIdx.x; w < n_win; w += kThreads) {
      int32_t mm = mmer_sentinel;
      long long key = key_sentinel;
      if (w + k <= len) {
        int32_t best = s_canon[w];
        for (int j = 1; j < wwin; ++j) {
          const int32_t v = s_canon[w + j];
          best = v < best ? v : best;
        }
        unsigned long long fwd = 0, rc = 0;
        for (int j = 0; j < k; ++j) {
          const unsigned long long c = s_codes[w + j];
          fwd = (fwd << 2) | c;
          rc |= (3ull - c) << (2 * j);
        }
        mm = best;
        key = static_cast<long long>(fwd < rc ? fwd : rc);
      }
      mmer_out[out_base + w] = mm;
      key_out[out_base + w] = key;
    }
    __syncthreads();  // the next read overwrites the shared row
  }
}

}  // namespace

// Launches on `stream`; allocates nothing, synchronises nothing.  Returns
// the cudaError_t of the launch (0 on success), or cudaErrorInvalidValue
// for shapes the kernel does not take.
extern "C" int fast_scan_launch(const void* codes, const void* lengths,
                                void* mmer_out, void* key_out,
                                int batch, int max_len, int k, int m,
                                void* stream) {
  if (batch < 1 || max_len < 1 || max_len > kMaxLen || m < 1 || m > 15 ||
      k < m || k > 31 || k > max_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = batch < kMaxBlocks ? batch : kMaxBlocks;
  const size_t shared = static_cast<size_t>(max_len) * (sizeof(int32_t) + 1);
  fast_scan_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(mmer_out), static_cast<long long*>(key_out),
      batch, max_len, k, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fast_scan_max_len() { return kMaxLen; }
