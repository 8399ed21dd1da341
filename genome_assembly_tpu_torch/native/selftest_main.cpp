// Sanitizer self-test driver for the native replay engine.
//
// Built with -fsanitize=address,undefined by native/build.py's
// build_sanitizer_selftest() and run by the test suite: exercises the full
// replay (build -> prune -> expand -> extend x2 -> print) on a synthetic
// insertion stream so ASan/UBSan sweep the engine's memory handling
// (SURVEY.md section 5.2 -- the reference ships with latent memory bugs;
// this guards ours).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int ga_parity_replay(int k, int m, int cutoff, int64_t n_groups,
                                const uint32_t* mmer, const uint32_t* kmer_hi,
                                const uint32_t* kmer_lo,
                                const int64_t* id_offsets,
                                const int32_t* read_ids, int verbose,
                                char** out_text, int64_t* out_stats);
extern "C" void ga_free(char* p);

int main() {
  // k=6, m=3: overlapping 6-mers from a tiny synthetic genome walk,
  // repeated so pruning keeps them; keys/mmers packed with T=0 G=1 C=2 A=3.
  const int k = 6, m = 3, cutoff = 1;
  std::vector<uint32_t> mmer, hi, lo;
  std::vector<int64_t> offsets{0};
  std::vector<int32_t> ids;
  // deterministic pseudo-genome of 2-bit codes
  uint32_t x = 12345;
  std::vector<int> genome;
  for (int i = 0; i < 64; i++) {
    x = x * 1103515245 + 12345;
    genome.push_back((x >> 16) & 3);
  }
  for (int i = 0; i + k <= (int)genome.size(); i++) {
    uint32_t kv = 0, mv = 0;
    for (int j = 0; j < k; j++) kv = (kv << 2) | genome[i + j];
    for (int j = 0; j < m; j++) mv = (mv << 2) | genome[i + j];
    mmer.push_back(mv);
    hi.push_back(0);
    lo.push_back(kv);
    ids.push_back(i);
    ids.push_back(i + 100);  // two occurrences -> survives cutoff 1
    offsets.push_back((int64_t)ids.size());
  }
  char* text = nullptr;
  int64_t stats[3] = {0, 0, 0};
  int rc = ga_parity_replay(k, m, cutoff, (int64_t)mmer.size(), mmer.data(),
                            hi.data(), lo.data(), offsets.data(), ids.data(),
                            /*verbose=*/1, &text, stats);
  if (rc != 0) {
    fprintf(stderr, "replay aborted: %s\n", text ? text : "?");
    ga_free(text);
    return 1;
  }
  size_t len = strlen(text);
  printf("ok pre=%lld post=%lld ext=%lld out_bytes=%zu\n",
         (long long)stats[0], (long long)stats[1], (long long)stats[2], len);
  ga_free(text);
  return 0;
}
