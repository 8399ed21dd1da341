// Native parity replay engine.
//
// C++ implementation of the order-faithful replay specified by
// parity/replay.py: rebuilds the reference program's two-level chained hash
// layout from the device-produced insertion stream and replays
// prune -> expand -> extend(fwd) -> extend(bwd) -> print with the exact
// semantics of the reference (twitu/genome-assembly binning.c:462-1144,
// zhash.c) including its quirks:
//   - polynomial hash with per-character modulo and the prime size ladder
//     (zhash.c:171-182, 13-17), head insertion, grow at count > size/2,
//     chain-reversing rehash (zhash.c:53-80, 184-214);
//   - deletion-safe iterators with static state that RESUME mid-table when
//     re-entered with the same table after a multiple-extension bailout
//     (binning.c:298-460, 539, 629);
//   - the extension ordering from mmer "CTT..T" with the score limit 65*m
//     caused by getbp('A') returning the character value (binning.c:672);
//   - adjacency-aware unlink cases, including the entry_count bookkeeping
//     bug in the greedy loop (binning.c:745-765 never decrements);
//   - occurrence (not distinct-read) counting and descending read-id lists.
//
// States the reference could only resolve through undefined behavior
// (dead branch binning.c:710; dangling-slot frees) abort with an error;
// tools/oracle.py's instrumented build shows they never fire on supported
// inputs.  This file is an original implementation -- not a translation of
// the reference sources -- driven by the behavioral contract in SURVEY.md
// section 2.1.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

const size_t kHashSizes[] = {
    53,        101,       211,       503,       1553,     3407,
    6803,      12503,     25013,     50261,     104729,   250007,
    500009,    1000003,   2000029,   4000037,   10000019, 25000009,
    50000047,  104395301, 217645177, 512927357, 1000000007};
const size_t kNumSizes = sizeof(kHashSizes) / sizeof(kHashSizes[0]);

const char kBaseByCode[] = "TGCA";  // T=0 G=1 C=2 A=3

inline int base_val(char c) {
  switch (c) {
    case 'T': return 0;
    case 'G': return 1;
    case 'C': return 2;
    case 'A': return 3;
    default: return 3;  // getval default (binning.c:107-109)
  }
}

inline long score_of(const std::string& s) {
  long score = 0;
  for (char c : s) score = score * 4 + base_val(c);
  return score;
}

struct ReplayAbort {
  std::string message;
};

using IdList = std::vector<int>;
using Lists = std::vector<IdList>;  // one read-id list per base pair

template <typename V>
struct EntryT {
  std::string key;
  V val;
  EntryT* next = nullptr;
  bool alive = true;
};

template <typename V>
struct TableT {
  using Entry = EntryT<V>;
  size_t size_index = 0;
  long entry_count = 0;
  std::vector<Entry*> buckets;
  bool alive = true;

  TableT() : buckets(kHashSizes[0], nullptr) {}

  size_t size() const { return kHashSizes[size_index]; }

  size_t hash(const std::string& key) const {
    size_t size = kHashSizes[size_index];
    size_t h = 0;
    for (char c : key) h = (17 * h + (unsigned char)c) % size;
    return h;
  }

  Entry* find(const std::string& key) const {
    Entry* e = buckets[hash(key)];
    while (e != nullptr && e->key != key) e = e->next;
    return e;
  }

  // zhash_set: replace in place if present, else head-insert + grow.
  // Returns true if a rehash occurred.
  template <typename Alloc>
  bool set(const std::string& key, V val, Alloc&& alloc_entry) {
    size_t h = hash(key);
    for (Entry* e = buckets[h]; e != nullptr; e = e->next) {
      if (e->key == key) {
        e->val = val;
        return false;
      }
    }
    Entry* e = alloc_entry();
    e->key = key;
    e->val = val;
    e->next = buckets[h];
    buckets[h] = e;
    entry_count++;
    if ((size_t)entry_count > size() / 2 && size_index + 1 < kNumSizes) {
      rehash(size_index + 1);
      return true;
    }
    return false;
  }

  void rehash(size_t new_index) {
    std::vector<Entry*> old;
    old.swap(buckets);
    size_index = new_index;
    buckets.assign(kHashSizes[new_index], nullptr);
    for (Entry* head : old) {
      Entry* e = head;
      while (e != nullptr) {
        Entry* nxt = e->next;
        size_t h = hash(e->key);
        e->next = buckets[h];
        buckets[h] = e;
        e = nxt;
      }
    }
  }
};

using Table2 = TableT<Lists*>;
using L2Entry = Table2::Entry;
using Table1 = TableT<Table2*>;
using L1Entry = Table1::Entry;

// Deletion-safe iterator with persistent ("static") state, one instance per
// nesting level, matching iterate_level_{one,two}_hash exactly.
template <typename Table>
struct LevelIter {
  using Entry = typename Table::Entry;
  Table* table = nullptr;
  Entry** slot = nullptr;
  size_t index = 0;
  bool remove = false;
  const char* name;

  explicit LevelIter(const char* n) : name(n) {}

  void mark_remove() { remove = true; }

  Entry** next(Table* t) {
    if (table != t) {
      table = t;
      slot = nullptr;
      index = 0;
    }
    if (slot != nullptr && *slot != nullptr) {
      if (!remove) {
        if (!(*slot)->alive)
          throw ReplayAbort{std::string(name) +
                            ": iterator advanced through freed entry"};
        slot = &(*slot)->next;
      } else {
        Entry* temp = *slot;
        *slot = temp->next;
        temp->alive = false;
        table->entry_count--;
        remove = false;
      }
    }
    if (slot == nullptr || *slot == nullptr) {
      while (index < table->size()) {
        if (table->buckets[index] != nullptr) {
          slot = &table->buckets[index];
          index++;
          break;
        }
        index++;
      }
    }
    if (slot == nullptr || *slot == nullptr) {
      table = nullptr;
      return nullptr;
    }
    if (!(*slot)->alive)
      throw ReplayAbort{std::string(name) + ": iterator returned freed entry"};
    return slot;
  }
};

// merge_sorted_list (llist.c:46-81): descending merge, equal heads dedup one.
IdList merge_sorted_ids(const IdList& a, const IdList& b) {
  IdList out;
  out.reserve(a.size() + b.size());
  size_t i = 0, j = 0;
  while (i < a.size() && j < b.size()) {
    if (a[i] > b[j]) out.push_back(a[i++]);
    else if (a[i] < b[j]) out.push_back(b[j++]);
    else { out.push_back(a[i++]); j++; }
  }
  out.insert(out.end(), a.begin() + i, a.end());
  out.insert(out.end(), b.begin() + j, b.end());
  return out;
}

class Engine {
 public:
  Engine(int k, int m, int cutoff) : k_(k), m_(m), cutoff_(cutoff),
      iter_l1_("level_one"), iter_l2_("level_two") {}

  std::deque<L1Entry> l1_pool_;
  std::deque<L2Entry> l2_pool_;
  std::deque<Table2> t2_pool_;
  std::deque<Lists> lists_pool_;

  L1Entry* alloc_l1() { l1_pool_.emplace_back(); return &l1_pool_.back(); }
  L2Entry* alloc_l2() { l2_pool_.emplace_back(); return &l2_pool_.back(); }
  Table2* alloc_t2() { t2_pool_.emplace_back(); return &t2_pool_.back(); }
  Lists* alloc_lists() { lists_pool_.emplace_back(); return &lists_pool_.back(); }

  void build(int64_t n_groups, const uint32_t* mmer, const uint32_t* khi,
             const uint32_t* klo, const int64_t* id_offsets,
             const int32_t* read_ids, int64_t n_raw = 0,
             const int64_t* raw_idx = nullptr,
             const char* raw_mmer = nullptr, const char* raw_kmer = nullptr) {
    // raw-key override channel (non-ACGT parity, binning.c:1023-1028:
    // uncomplemented keys store the READ's raw bytes verbatim): group
    // raw_idx[i] uses the given byte strings instead of the packed
    // decode.  raw_idx must be ascending.
    int n_lo = k_ < 16 ? k_ : 16;
    int64_t ri = 0;
    for (int64_t g = 0; g < n_groups; g++) {
      std::string mstr, kstr;
      if (ri < n_raw && raw_idx[ri] == g) {
        mstr.assign(raw_mmer + ri * m_, m_);
        kstr.assign(raw_kmer + ri * k_, k_);
        ri++;
      } else {
        mstr = decode(mmer[g], m_);
        uint64_t kv = ((uint64_t)khi[g] << (2 * n_lo)) | klo[g];
        kstr = decode64(kv, k_);
      }
      Table2* t2;
      L1Entry* me = l1_.find(mstr);
      if (me == nullptr) {
        t2 = alloc_t2();
        l1_.set(mstr, t2, [this] { return alloc_l1(); });
      } else {
        t2 = me->val;
      }
      Lists* lists = alloc_lists();
      lists->emplace_back();
      IdList& ids = lists->back();
      int64_t lo = id_offsets[g], hi = id_offsets[g + 1];
      ids.reserve(hi - lo);
      for (int64_t i = hi - 1; i >= lo; i--) ids.push_back(read_ids[i]);
      t2->set(kstr, lists, [this] { return alloc_l2(); });
      n_pre_++;
    }
  }

  void prune() {
    for (;;) {
      L1Entry** slot = iter_l1_.next(&l1_);
      if (slot == nullptr) break;
      if (prune_kmers((*slot)->val) == nullptr) {
        (*slot)->val = nullptr;
        iter_l1_.mark_remove();
      }
    }
  }

  Table2* prune_kmers(Table2* table) {
    for (;;) {
      L2Entry** slot = iter_l2_.next(table);
      if (slot == nullptr) break;
      const IdList& ids = (*slot)->val->at(0);
      long count = 1;
      size_t pos = 0;
      while (pos + 1 < ids.size() && count <= cutoff_) { count++; pos++; }
      if (count <= cutoff_) {
        (*slot)->val = nullptr;
        iter_l2_.mark_remove();
      }
    }
    if (table->entry_count == 0) {
      table->alive = false;
      return nullptr;
    }
    return table;
  }

  void expand() {
    for (;;) {
      L1Entry** ms = iter_l1_.next(&l1_);
      if (ms == nullptr) break;
      Table2* t2 = (*ms)->val;
      for (;;) {
        L2Entry** ks = iter_l2_.next(t2);
        if (ks == nullptr) break;
        Lists* lists = (*ks)->val;
        size_t len = (*ks)->key.size();
        IdList base = lists->at(0);
        lists->assign(len, base);
        n_post_prune_++;
      }
    }
  }

  // find_kmer_extension / more_kmer_extension (binning.c:477-649).
  // self_entry non-null skips the key's own entry (first extension only).
  struct Found { L2Entry** slot; Table2* table; };
  Found find_extension(const std::string& key, long mmer_score, bool forward,
                       L2Entry* self_entry) {
    int m1 = m_ - 1;
    L2Entry** ext_slot = nullptr;
    Table2* ext_table = nullptr;
    bool multiple = false;
    for (int i = 0; i < 4 && !multiple; i++) {
      std::string cm;
      if (forward) {
        cm = key.substr(key.size() - m1) + kBaseByCode[i];
      } else {
        cm = std::string(1, kBaseByCode[i]) + key.substr(0, m1);
      }
      if (score_of(cm) > mmer_score) continue;
      L1Entry* me = l1_.find(cm);
      if (me == nullptr || me->val == nullptr) continue;
      Table2* t = me->val;
      for (;;) {
        L2Entry** ce = iter_l2_.next(t);
        if (ce == nullptr) break;
        L2Entry* c = *ce;
        if (self_entry != nullptr && c == self_entry) continue;
        if (!compare_overlap(key, c->key, forward)) continue;
        if (ext_slot != nullptr) {
          ext_slot = nullptr;
          ext_table = nullptr;
          multiple = true;
          break;
        }
        ext_table = t;
        ext_slot = ce;
      }
    }
    return {ext_slot, ext_table};
  }

  bool compare_overlap(const std::string& a0, const std::string& b0,
                       bool forward) {
    const std::string& a = forward ? a0 : b0;
    const std::string& b = forward ? b0 : a0;
    size_t k1 = k_ - 1;
    return a.compare(a.size() - k1, k1, b, 0, k1) == 0;
  }

  std::string merge_keys(const std::string& a, const std::string& b,
                         bool forward) {
    size_t k1 = k_ - 1;
    if (forward) return a + b.substr(k1);
    return b + a.substr(k1);
  }

  Lists* merge_lists(Lists* ap, Lists* bp, bool forward) {
    if (!forward) std::swap(ap, bp);
    const Lists& a = *ap;
    const Lists& b = *bp;
    size_t k1 = k_ - 1;
    Lists* out = alloc_lists();
    out->reserve(a.size() + b.size() - k1);
    for (size_t i = 0; i < a.size() - k1; i++) out->push_back(a[i]);
    for (size_t i = 0; i < k1; i++)
      out->push_back(merge_sorted_ids(a[a.size() - k1 + i], b[i]));
    for (size_t i = k1; i < b.size(); i++) out->push_back(b[i]);
    return out;
  }

  void extend_all(bool forward) {
    std::string mmer = "C" + std::string(m_ - 1, 'T');
    long mmer_score = score_of(mmer);
    long score_limit = 65L * m_;  // getbp('A') == 'A' == 65 (binning.c:672)
    while (mmer_score <= score_limit) {
      L1Entry* me = l1_.find(mmer);
      if (me != nullptr && me->val != nullptr) {
        Table2* mmer_hash = me->val;
        size_t size_at_entry = mmer_hash->size();
        size_t array_index = 0;
        while (array_index < mmer_hash->size()) {
          if (mmer_hash->size() != size_at_entry)
            throw ReplayAbort{"level-2 table rehashed during extension"};
          L2Entry** kmer_slot = &mmer_hash->buckets[array_index];
          while (*kmer_slot != nullptr) {
            kmer_slot = extend_one(mmer_hash, kmer_slot, mmer_score, forward);
          }
          array_index++;
        }
      }
      // next_smaller_mmer (binning.c:129-145)
      for (int i = m_ - 1; i >= 0; i--) {
        if (mmer[i] == 'A') {
          mmer[i] = 'T';
        } else {
          mmer[i] = kBaseByCode[base_val(mmer[i]) + 1];
          break;
        }
      }
      mmer_score++;
    }
  }

  L2Entry** extend_one(Table2* mmer_hash, L2Entry** kmer_slot,
                       long mmer_score, bool forward) {
    L2Entry* entry = *kmer_slot;
    Found f = find_extension(entry->key, mmer_score, forward, entry);
    if (f.slot == nullptr) return &entry->next;

    L2Entry* a = *kmer_slot;
    L2Entry* b = *f.slot;
    std::string new_key = merge_keys(a->key, b->key, forward);
    Lists* new_lists = merge_lists(a->val, b->val, forward);

    if (b->next == a) {
      // binning.c:698-708
      kmer_slot = f.slot;
      L2Entry* temp = *kmer_slot;
      *kmer_slot = temp->next;
      temp->alive = false;
      temp = *kmer_slot;
      *kmer_slot = temp->next;
      temp->alive = false;
      mmer_hash->entry_count -= 2;
    } else {
      if (a->next == b || f.slot == &a->next)
        throw ReplayAbort{
            "kmer entry directly precedes extension entry (binning.c:710 "
            "dead branch; reference behavior undefined)"};
      L2Entry* temp = *kmer_slot;
      *kmer_slot = temp->next;
      temp->alive = false;
      mmer_hash->entry_count--;
      temp = *f.slot;
      *f.slot = temp->next;
      temp->alive = false;
      f.table->entry_count--;
    }

    // Greedy further extension (binning.c:734-766).  The reference never
    // decrements entry_count here -- replicated.
    for (;;) {
      f = find_extension(new_key, mmer_score, forward, nullptr);
      if (f.slot == nullptr) break;
      L2Entry* e = *f.slot;
      new_key = merge_keys(new_key, e->key, forward);
      new_lists = merge_lists(new_lists, e->val, forward);
      if (e == *kmer_slot) {
        L2Entry* temp = *kmer_slot;
        *kmer_slot = temp->next;
        temp->alive = false;
      } else if (e->next == *kmer_slot) {
        kmer_slot = f.slot;
        L2Entry* temp = *kmer_slot;
        *kmer_slot = temp->next;
        temp->alive = false;
      } else {
        if (kmer_slot == &e->next)
          throw ReplayAbort{
              "iterator slot dangles into freed extension entry (reference "
              "UB)"};
        L2Entry* temp = *f.slot;
        *f.slot = temp->next;
        temp->alive = false;
      }
    }
    size_t size_before = mmer_hash->size();
    mmer_hash->set(new_key, new_lists, [this] { return alloc_l2(); });
    if (mmer_hash->size() != size_before)
      throw ReplayAbort{
          "zhash_set during extension triggered a rehash (reference UAF "
          "hazard)"};
    return kmer_slot;
  }

  std::string print_kmers() {
    std::string out;
    for (;;) {
      L1Entry** ms = iter_l1_.next(&l1_);
      if (ms == nullptr) break;
      Table2* t2 = (*ms)->val;
      for (;;) {
        L2Entry** ks = iter_l2_.next(t2);
        if (ks == nullptr) break;
        out += (*ks)->key;
        out += '\n';
        n_post_ext_++;
      }
    }
    return out;
  }

  std::string print_kmer_read_ids() {
    std::string out;
    for (;;) {
      L1Entry** ms = iter_l1_.next(&l1_);
      if (ms == nullptr) break;
      out += (*ms)->key;
      out += '\n';
      Table2* t2 = (*ms)->val;
      for (;;) {
        L2Entry** ks = iter_l2_.next(t2);
        if (ks == nullptr) break;
        out += (*ks)->key;
        out += '\n';
        n_post_ext_++;
        for (const IdList& ids : *(*ks)->val) {
          for (int id : ids) {
            out += std::to_string(id);
            out += ' ';
          }
          out += '\n';
        }
      }
      out += '\n';
    }
    return out;
  }

  std::string decode(uint32_t v, int n) {
    std::string s(n, 'T');
    for (int j = 0; j < n; j++) s[n - 1 - j] = kBaseByCode[(v >> (2 * j)) & 3];
    return s;
  }

  std::string decode64(uint64_t v, int n) {
    std::string s(n, 'T');
    for (int j = 0; j < n; j++) s[n - 1 - j] = kBaseByCode[(v >> (2 * j)) & 3];
    return s;
  }

  int k_, m_, cutoff_;
  Table1 l1_;
  LevelIter<Table1> iter_l1_;
  LevelIter<Table2> iter_l2_;
  long n_pre_ = 0, n_post_prune_ = 0, n_post_ext_ = 0;
};

}  // namespace

extern "C" {

// Full replay.  Returns 0 on success (out_text = malloc'd output buffer) or
// 1 on abort (out_text = malloc'd error message).  out_stats[0..2] =
// pre-prune entries, post-prune entries, post-extension entries.
int ga_parity_replay_raw(int k, int m, int cutoff, int64_t n_groups,
                         const uint32_t* mmer, const uint32_t* kmer_hi,
                         const uint32_t* kmer_lo, const int64_t* id_offsets,
                         const int32_t* read_ids, int64_t n_raw,
                         const int64_t* raw_idx, const char* raw_mmer,
                         const char* raw_kmer, int verbose, char** out_text,
                         int64_t* out_stats) {
  try {
    Engine eng(k, m, cutoff);
    eng.build(n_groups, mmer, kmer_hi, kmer_lo, id_offsets, read_ids,
              n_raw, raw_idx, raw_mmer, raw_kmer);
    eng.prune();
    eng.expand();
    eng.extend_all(true);
    eng.extend_all(false);
    std::string out = verbose ? eng.print_kmer_read_ids() : eng.print_kmers();
    *out_text = (char*)malloc(out.size() + 1);
    memcpy(*out_text, out.data(), out.size());
    (*out_text)[out.size()] = '\0';
    if (out_stats != nullptr) {
      out_stats[0] = eng.n_pre_;
      out_stats[1] = eng.n_post_prune_;
      out_stats[2] = eng.n_post_ext_;
    }
    return 0;
  } catch (const ReplayAbort& e) {
    *out_text = (char*)malloc(e.message.size() + 1);
    memcpy(*out_text, e.message.data(), e.message.size());
    (*out_text)[e.message.size()] = '\0';
    return 1;
  }
}

int ga_parity_replay(int k, int m, int cutoff, int64_t n_groups,
                     const uint32_t* mmer, const uint32_t* kmer_hi,
                     const uint32_t* kmer_lo, const int64_t* id_offsets,
                     const int32_t* read_ids, int verbose, char** out_text,
                     int64_t* out_stats) {
  try {
    Engine eng(k, m, cutoff);
    eng.build(n_groups, mmer, kmer_hi, kmer_lo, id_offsets, read_ids);
    eng.prune();
    eng.expand();
    eng.extend_all(true);
    eng.extend_all(false);
    std::string out = verbose ? eng.print_kmer_read_ids() : eng.print_kmers();
    *out_text = (char*)malloc(out.size() + 1);
    memcpy(*out_text, out.data(), out.size());
    (*out_text)[out.size()] = '\0';
    if (out_stats != nullptr) {
      out_stats[0] = eng.n_pre_;
      out_stats[1] = eng.n_post_prune_;
      out_stats[2] = eng.n_post_ext_;
    }
    return 0;
  } catch (const ReplayAbort& e) {
    *out_text = (char*)malloc(e.message.size() + 1);
    memcpy(*out_text, e.message.data(), e.message.size());
    (*out_text)[e.message.size()] = '\0';
    return 1;
  }
}

void ga_free(char* p) { free(p); }

}  // extern "C"
