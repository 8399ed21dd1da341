// Fused fast-mode scan for Hopper (sm_90a): canonical k-mer key, minimizer
// and validity of every k-window of a padded read batch, in one pass.
//
// Replaces the TPU kernel genome_assembly_tpu/ops/minimizer_pallas.py::
// _scan_kernel (wrapper fast_scan_pallas).  Same function: per m-mer
// position min(m-mer, reverse complement); per window the minimum of those
// over its k-m+1 positions, and the smaller packed value of the k-mer and
// its reverse complement.  Differences of form, not of result: the key is
// one int64 (the TPU kernel writes two uint32 lanes, key = hi << 32 | lo),
// and windows that do not exist (start + k > length) are written as
// sentinels here, with `valid` false, instead of being masked by the
// caller afterwards.
//
// Bound: bytes.  The batch is read once (B*L bytes of codes, 4*B of
// lengths) and 13 bytes are written per window slot (m-mer 4, key 8, valid
// 1).  So a window may cost only a few dozen instructions, whatever k and m
// are.  The design:
//
//   * one warp per read, no block barrier; the reads of a block share
//     nothing.  A lane loads four bases (one 4-byte load where the row is
//     aligned, else four guarded byte loads: the row stride L need not be a
//     multiple of 4), and eight lanes OR their bytes into one 64-bit word of
//     32 two-bit bases by three shuffles.  The warp's words live in shared
//     memory, first base in the highest bits, with one zero word after them.
//   * the 64 bits from base p on are two words and a funnel shift.  The
//     forward k-mer is their top 2k bits; its reverse complement comes from
//     the same 64 bits: reverse the bits (__brevll), swap the bits of every
//     pair back, complement, keep the low 2k bits.  That is the plain
//     version's rc |= (3 - c) << 2j with the first base lowest.  The
//     canonical m-mer at every position is the same in 32 bits.
//   * the window minimum is a log-step table over the warp's m-mer scores in
//     shared memory (the TPU kernel's sparse table): after the levels of
//     span 1, 2, .. s (s the largest power of two <= k-m+1) entry p holds the
//     minimum over [p, p + s), and a window is the minimum of two entries.
//     The levels run in place, 128 positions at a time: every lane reads its
//     four before any lane writes, and a level reads only later positions.
//   * neighbouring lanes own neighbouring windows, so every store is
//     coalesced; the kernel writes `valid` itself.
//
// A valid window reads only bases below the read's length, so nothing
// relies on the zero padding after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;    // warps of a block: one read each
constexpr int kMaxLen = 8192;   // one warp's words and scores: 4.25 bytes a base
constexpr int kBasesARound = 128;  // four a lane
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// 64-bit words of one warp's read: 32 bases a word, rounds of 128 bases,
// and one zero word after them for the funnel shift
__host__ __device__ inline int words_of(int max_len) {
  return 4 * ((max_len + kBasesARound - 1) / kBasesARound) + 1;
}

// 8-byte units of shared memory one warp uses: its words and its int32 scores
__host__ __device__ inline int warp_units(int max_len) {
  return words_of(max_len) + (max_len + 1) / 2;
}

// The 64 bits of the read from base p on (base p in the two highest bits).
__device__ __forceinline__ unsigned long long bits_from(const unsigned long long* words, int p) {
  const unsigned long long hi = words[p >> 5];
  const unsigned long long lo = words[(p >> 5) + 1];
  const int s = 2 * (p & 31);
  return s ? (hi << s) | (lo >> (64 - s)) : hi;
}

// The 2-bit groups of x in reverse order.
__device__ __forceinline__ unsigned long long reverse_pairs(unsigned long long x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ uint32_t reverse_pairs(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
fast_scan_kernel(const uint8_t* __restrict__ codes,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ mmer_out,
                 long long* __restrict__ key_out,
                 bool* __restrict__ valid_out,
                 int batch, int max_len, int k, int m) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_words = words_of(max_len);
  unsigned long long* words = smem + (threadIdx.x >> 5) * warp_units(max_len);
  int32_t* score = reinterpret_cast<int32_t*>(words + n_words);

  const int n_win = max_len - k + 1;
  const int n_mpos = max_len - m + 1;
  const int width = k - m + 1;
  int span = 1;  // of the table's last level: the largest power of two <= width
  while (2 * span <= width) span *= 2;
  const unsigned long long key_mask = (1ull << (2 * k)) - 1;
  const uint32_t mmer_mask = (1u << (2 * m)) - 1;
  const long long key_sentinel = 0x7FFFFFFFFFFFFFFFLL;
  const int32_t mmer_sentinel = 0x7FFFFFFF;

  const long long row = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
  if (row >= batch) return;  // the whole warp: a warp is one read
  const uint8_t* src = codes + row * max_len;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
  const int len = lengths[row];  // loaded here: its latency hides behind the pack

  // pack: four bases a lane, eight lanes a word
  for (int round = 0; round < max_len; round += kBasesARound) {
    const int p = round + 4 * lane;
    uint32_t four = 0;  // base p + t in byte t
    if (aligned && p + 4 <= max_len) {
      four = *reinterpret_cast<const uint32_t*>(src + p);
    } else {
      for (int t = 0; t < 4; ++t) {
        if (p + t < max_len) four |= static_cast<uint32_t>(src[p + t]) << (8 * t);
      }
    }
    const uint32_t byte = ((four & 3u) << 6) | (((four >> 8) & 3u) << 4) |
                          (((four >> 16) & 3u) << 2) | ((four >> 24) & 3u);
    unsigned long long word = static_cast<unsigned long long>(byte) << (56 - 8 * (lane & 7));
    word |= __shfl_xor_sync(kFullMask, word, 1);
    word |= __shfl_xor_sync(kFullMask, word, 2);
    word |= __shfl_xor_sync(kFullMask, word, 4);
    if ((lane & 7) == 0) words[(round >> 5) + (lane >> 3)] = word;
  }
  if (lane == 0) words[n_words - 1] = 0;
  __syncwarp();

  // the canonical m-mer at every position
#pragma unroll 4
  for (int p = lane; p < n_mpos; p += 32) {
    const uint32_t top = static_cast<uint32_t>(bits_from(words, p) >> 32);
    const uint32_t fwd = top >> (32 - 2 * m);
    const uint32_t rc = ~reverse_pairs(top) & mmer_mask;
    score[p] = static_cast<int32_t>(fwd < rc ? fwd : rc);
  }
  __syncwarp();

  // the log-step table: entry p becomes the minimum over [p, p + 2 h)
  for (int h = 1; 2 * h <= width; h *= 2) {
    for (int round = 0; round < n_mpos; round += 128) {
      int32_t v[4];
      bool has[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = round + 32 * i + lane;
        has[i] = p + h < n_mpos;
        v[i] = 0;
        if (has[i]) {
          const int32_t a = score[p], b = score[p + h];
          v[i] = a < b ? a : b;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (has[i]) score[round + 32 * i + lane] = v[i];
      }
      __syncwarp();
    }
  }

  // one lane a window
  const long long out = row * n_win;
#pragma unroll 4
  for (int w = lane; w < n_win; w += 32) {
    const bool ok = w + k <= len;
    int32_t mm = mmer_sentinel;
    long long key = key_sentinel;
    if (ok) {
      const unsigned long long x = bits_from(words, w);
      const unsigned long long fwd = x >> (64 - 2 * k);
      const unsigned long long rc = ~reverse_pairs(x) & key_mask;
      key = static_cast<long long>(fwd < rc ? fwd : rc);
      const int32_t a = score[w], b = score[w + width - span];
      mm = a < b ? a : b;
    }
    mmer_out[out + w] = mm;
    key_out[out + w] = key;
    valid_out[out + w] = ok;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing, synchronises nothing.  Returns
// the cudaError_t of the launch (0 on success), or cudaErrorInvalidValue
// for shapes the kernel does not take.
extern "C" int fast_scan_launch(const void* codes, const void* lengths,
                                void* mmer_out, void* key_out, void* valid_out,
                                int batch, int max_len, int k, int m,
                                void* stream) {
  if (batch < 1 || max_len < 1 || max_len > kMaxLen || m < 1 || m > 15 ||
      k < m || k > 31 || k > max_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // as many warps a block as 48 KB of shared memory hold, at most kMaxWarps
  const size_t per_warp = static_cast<size_t>(warp_units(max_len)) * 8;
  int warps = static_cast<int>((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  // one read a warp: a grid of as many blocks as that takes (at most 2^31 - 1,
  // since batch is an int) leaves the card no half-full last wave of blocks
  // that stride over the reads
  const int blocks = static_cast<int>((static_cast<long long>(batch) + warps - 1) / warps);
  fast_scan_kernel<<<blocks, 32 * warps, per_warp * warps, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(mmer_out), static_cast<long long*>(key_out),
      static_cast<bool*>(valid_out), batch, max_len, k, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fast_scan_max_len() { return kMaxLen; }
