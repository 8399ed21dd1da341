"""Order-faithful replay of the reference's prune/expand/extend phases.

The reference's unitig extension (find_kmer_extensions, binning.c:659-783) is
order-dependent: which k-mers merge depends on m-mer processing order, bucket
order (hash function + table size history), and chain order (head insertion +
rehash points) -- SURVEY.md 2.1.10.  Bit-identical output therefore requires
simulating the reference's chained hash tables exactly: same hash function
(zgenerate_hash, zhash.c:171-182), same prime size ladder and growth
thresholds (zhash.c:13-17, 75-79), same head-insertion and rehash chain
reversal (zhash.c:71-73, 197-211), same deferred-deletion iterators with
*static* state (binning.c:298-460) -- including the quirk that an iterator
abandoned mid-table by a multiple-extension bailout (binning.c:539, 629)
*resumes* where it left off if the same table is probed next.

This module is the executable specification in Python; the C++ engine in
native/ is the production implementation validated against it.  Neither is a
translation of the reference source: both simulate the documented semantics
with index-based structures.

Insertion order is recovered from the device-counted table: each entry's
first_seen stream index orders (mmer, kmer) insertions; occurrence lists do
not affect layout (only entry insertions grow tables), so values are
installed up front.

Cases the reference could only resolve through undefined behavior (freeing a
node while another live slot dangles into it: the dead adjacency branch at
binning.c:710 whose condition duplicates binning.c:698, and dangling-slot
frees in the greedy loop) are asserted absent; tools/oracle.py's
instrumented build verifies they never fire on the supported fixtures.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from genome_assembly_tpu_torch.ops.encode import BASE_BY_CODE, score_str

# Prime size ladder shared by zhash.c:13-17 and binning.c:20-23.
HASH_SIZES = (
    53, 101, 211, 503, 1553, 3407, 6803, 12503, 25013, 50261,
    104729, 250007, 500009, 1000003, 2000029, 4000037, 10000019,
    25000009, 50000047, 104395301, 217645177, 512927357, 1000000007,
)


class ReplayError(RuntimeError):
    """The replay hit a state the reference could only resolve via UB."""


class Entry:
    """One hash entry (zhash.h:14-18). ``alive`` tracks frees: a freed
    entry keeps its fields (the reference reads a freed entry's ``next``
    only in states we assert never happen)."""

    __slots__ = ("key", "val", "next", "alive")

    def __init__(self, key: str, val):
        self.key = key
        self.val = val
        self.next: Optional["Entry"] = None
        self.alive = True


class Slot:
    """A pointer *cell*: either a bucket head or some entry's next field.

    Mirrors the reference's ZHashEntry** idiom so chain surgery and the
    deletion-safe iterators translate one-to-one.
    """

    __slots__ = ("table", "idx", "entry")

    def __init__(self, table=None, idx=None, entry=None):
        self.table = table
        self.idx = idx
        self.entry = entry

    def get(self) -> Optional[Entry]:
        if self.entry is not None:
            return self.entry.next
        return self.table.buckets[self.idx]

    def set(self, value: Optional[Entry]) -> None:
        if self.entry is not None:
            self.entry.next = value
        else:
            self.table.buckets[self.idx] = value


class SimTable:
    """Chained string-key hash table with the reference's exact layout
    dynamics (zhash.c): polynomial hash mod current size, head insertion,
    grow at entry_count > size/2, chain-reversing rehash."""

    __slots__ = ("size_index", "entry_count", "buckets", "alive")

    def __init__(self, size_index: int = 0):
        self.size_index = size_index
        self.entry_count = 0
        self.buckets: List[Optional[Entry]] = [None] * HASH_SIZES[size_index]
        self.alive = True

    @property
    def size(self) -> int:
        return HASH_SIZES[self.size_index]

    def hash(self, key: str) -> int:
        # zgenerate_hash (zhash.c:171-182): mod applied at every step.
        h = 0
        size = HASH_SIZES[self.size_index]
        for ch in key:
            h = (17 * h + ord(ch)) % size
        return h

    def get(self, key: str):
        e = self.buckets[self.hash(key)]
        while e is not None and e.key != key:
            e = e.next
        return e.val if e is not None else None

    def set(self, key: str, val) -> None:
        # zhash_set (zhash.c:53-80): replace value in place if present (old
        # value NOT freed -- SURVEY.md 2.1.12), else head-insert + maybe grow.
        h = self.hash(key)
        e = self.buckets[h]
        while e is not None:
            if e.key == key:
                e.val = val
                return
            e = e.next
        e = Entry(key, val)
        e.next = self.buckets[h]
        self.buckets[h] = e
        self.entry_count += 1
        if self.entry_count > self.size // 2:
            self.rehash(min(self.size_index + 1, len(HASH_SIZES) - 1))

    def rehash(self, new_index: int) -> None:
        # zhash_rehash (zhash.c:184-214): old buckets in index order, each
        # chain head-to-tail, head-inserted into the new array (so entries
        # of one old chain that collide again end up reversed).
        if new_index == self.size_index:
            return
        old = self.buckets
        self.size_index = new_index
        self.buckets = [None] * HASH_SIZES[new_index]
        for head in old:
            e = head
            while e is not None:
                nxt = e.next
                h = self.hash(e.key)
                e.next = self.buckets[h]
                self.buckets[h] = e
                e = nxt


def free_entry(entry: Entry) -> None:
    """zfree_entry(entry, false) (zhash.c:163-169): mark dead, keep fields."""
    entry.alive = False


class LevelIterator:
    """The deletion-safe static-state iterator (binning.c:298-371, duplicated
    at 387-460).  One instance per nesting level, exactly like the two
    static-variable copies in the reference.  Passing the same table resumes;
    a different table resets; completing a table clears the state."""

    __slots__ = ("table", "slot", "index", "remove", "name")

    def __init__(self, name: str):
        self.table: Optional[SimTable] = None
        self.slot: Optional[Slot] = None
        self.index = 0
        self.remove = False
        self.name = name

    def mark_remove(self) -> None:
        # iterate_*_hash(NULL, dont-care, true)
        self.remove = True

    def __call__(self, table: SimTable, indirection: bool):
        if self.table is not table:
            self.table = table
            self.slot = None
            self.index = 0
        if self.slot is not None and self.slot.get() is not None:
            if not self.remove:
                cur = self.slot.get()
                if not cur.alive:
                    raise ReplayError(
                        f"{self.name}: iterator advanced through freed entry"
                    )
                self.slot = Slot(entry=cur)
            else:
                temp = self.slot.get()
                self.slot.set(temp.next)
                free_entry(temp)
                self.table.entry_count -= 1
                self.remove = False
        if self.slot is None or self.slot.get() is None:
            while self.index < self.table.size:
                if self.table.buckets[self.index] is not None:
                    self.slot = Slot(table=self.table, idx=self.index)
                    self.index += 1
                    break
                self.index += 1
        if self.slot is None or self.slot.get() is None:
            self.table = None
            return None
        result = self.slot.get()
        if not result.alive:
            raise ReplayError(f"{self.name}: iterator returned freed entry")
        return self.slot if indirection else result


def merge_sorted_ids(a: List[int], b: List[int]) -> List[int]:
    """merge_sorted_list (llist.c:46-81): descending merge; equal heads keep
    one node (duplicates *within* one list survive)."""
    out: List[int] = []
    i = j = 0
    while i < len(a) and j < len(b):
        if a[i] > b[j]:
            out.append(a[i]); i += 1
        elif a[i] < b[j]:
            out.append(b[j]); j += 1
        else:
            out.append(a[i]); i += 1; j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


class ReferenceReplay:
    """Builds the two-level table from the insertion stream, then replays
    prune -> expand -> extend(fwd) -> extend(bwd) -> print."""

    def __init__(self, k: int, m: int, cutoff: int = 1):
        self.k = k
        self.m = m
        self.cutoff = cutoff
        self.l1 = SimTable()
        self.iter_l1 = LevelIterator("level_one")
        self.iter_l2 = LevelIterator("level_two")
        # Counters mirroring tools/oracle.py's instrumented build, for
        # cross-checking which adjacency cases fired.
        self.case_counts = {"c1": 0, "c3": 0, "d1": 0, "d2": 0, "d3": 0}

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------

    def build(
        self, groups: Sequence[Tuple[str, str, Sequence[int]]]
    ) -> None:
        """Install pre-prune entries in first-seen stream order.

        groups: (mmer, kmer, read_ids ascending-stream-order) sorted by
        first occurrence.  Occurrence events don't change table layout, so
        each entry is installed once with its final descending read-id list
        (head-shift insertion semantics, binning.c:1060-1069).
        """
        for mmer, kmer, ids in groups:
            l2 = self.l1.get(mmer)
            if l2 is None:
                l2 = SimTable()
                self.l1.set(mmer, l2)
            # process_read only calls zhash_set for unseen kmers
            # (binning.c:1052-1057), so each group appears exactly once.
            l2.set(kmer, [int(x) for x in reversed(list(ids))])

    # ------------------------------------------------------------------
    # Prune (prune_data / prune_kmers, binning.c:1078-1144)
    # ------------------------------------------------------------------

    def prune(self) -> None:
        while True:
            slot = self.iter_l1(self.l1, True)
            if slot is None:
                break
            if self._prune_kmers(slot.get().val) is None:
                slot.get().val = None
                self.iter_l1.mark_remove()

    def _prune_kmers(self, table: SimTable) -> Optional[SimTable]:
        while True:
            slot = self.iter_l2(table, True)
            if slot is None:
                break
            ids = slot.get().val
            # count = min(len, cutoff + 1); delete when count <= cutoff
            count = 1
            pos = 0
            while pos + 1 < len(ids) and count <= self.cutoff:
                count += 1
                pos += 1
            if count <= self.cutoff:
                slot.get().val = None
                self.iter_l2.mark_remove()
        if table.entry_count == 0:
            table.alive = False
            return None
        return table

    # ------------------------------------------------------------------
    # Expand (expand_read_id_list, binning.c:857-888)
    # ------------------------------------------------------------------

    def expand(self) -> None:
        while True:
            mmer_entry = self.iter_l1(self.l1, False)
            if mmer_entry is None:
                break
            l2 = mmer_entry.val
            while True:
                kmer_entry = self.iter_l2(l2, False)
                if kmer_entry is None:
                    break
                ids = kmer_entry.val
                # first BP aliases the original list, the rest deep-copy
                kmer_entry.val = [ids] + [
                    list(ids) for _ in range(len(kmer_entry.key) - 1)
                ]

    # ------------------------------------------------------------------
    # Extension (find_kmer_extensions et al., binning.c:462-783)
    # ------------------------------------------------------------------

    def _merge_lists(self, a_lists, b_lists, forward: bool):
        # merge_lists (binning.c:154-195)
        if not forward:
            a_lists, b_lists = b_lists, a_lists
        k1 = self.k - 1
        head = a_lists[: len(a_lists) - k1]
        overlap = [
            merge_sorted_ids(a_lists[len(a_lists) - k1 + i], b_lists[i])
            for i in range(k1)
        ]
        return head + overlap + b_lists[k1:]

    def _merge_keys(self, a_key: str, b_key: str, forward: bool) -> str:
        # merge_keys (binning.c:223-241)
        k1 = self.k - 1
        if forward:
            return a_key + b_key[k1:]
        return b_key + a_key[k1:]

    def _compare_overlap(self, a: str, b: str, forward: bool) -> bool:
        # compare_overlap (binning.c:200-218)
        if not forward:
            a, b = b, a
        k1 = self.k - 1
        return a[len(a) - k1 :] == b[:k1]

    def _find_extension(
        self, key: str, mmer_score: int, forward: bool, self_entry: Optional[Entry]
    ) -> Tuple[Optional[Slot], Optional[SimTable]]:
        """find_kmer_extension (self_entry set; binning.c:477-559) and
        more_kmer_extension (self_entry None; binning.c:572-649)."""
        m1 = self.m - 1
        ext_slot: Optional[Slot] = None
        ext_table: Optional[SimTable] = None
        multiple = False
        for i in range(4):
            if forward:
                cm = key[len(key) - m1 :] + BASE_BY_CODE[i] if m1 else BASE_BY_CODE[i]
            else:
                cm = BASE_BY_CODE[i] + key[:m1]
            if score_str(cm) > mmer_score:
                continue
            t = self.l1.get(cm)
            if t is None:
                continue
            while True:
                ce = self.iter_l2(t, True)
                if ce is None:
                    break
                c = ce.get()
                if self_entry is not None and c is self_entry:
                    continue
                if not self._compare_overlap(key, c.key, forward):
                    continue
                if ext_slot is not None:
                    ext_slot = None
                    ext_table = None
                    multiple = True
                    break
                ext_table = t
                ext_slot = ce
            if multiple:
                break
        return ext_slot, ext_table

    def extend_all(self, forward: bool) -> None:
        """find_kmer_extensions (binning.c:659-783)."""
        m = self.m
        mmer = list("C" + "T" * (m - 1))
        mmer_score = score_str("".join(mmer))
        # getbp('A') hits the default case returning the char 'A' == 65
        # (binning.c:672, SURVEY.md 2.1.7), so the loop overshoots past the
        # max score and probes a few non-canonical m-mers harmlessly.
        score_limit = 65 * m
        while mmer_score <= score_limit:
            mmer_hash = self.l1.get("".join(mmer))
            if mmer_hash is not None:
                size_at_entry = mmer_hash.size
                array_index = 0
                while array_index < mmer_hash.size:
                    if mmer_hash.size != size_at_entry:
                        raise ReplayError(
                            "level-2 table rehashed during extension (the "
                            "reference would have a use-after-free here)"
                        )
                    kmer_slot = Slot(table=mmer_hash, idx=array_index)
                    while kmer_slot.get() is not None:
                        kmer_slot = self._extend_one(
                            mmer_hash, kmer_slot, mmer_score, forward
                        )
                    array_index += 1
            # next_smaller_mmer (binning.c:129-145)
            for i in range(m - 1, -1, -1):
                if mmer[i] == "A":
                    mmer[i] = "T"
                else:
                    mmer[i] = BASE_BY_CODE[BASE_BY_CODE.index(mmer[i]) + 1]
                    break
            mmer_score += 1

    def _extend_one(
        self, mmer_hash: SimTable, kmer_slot: Slot, mmer_score: int, forward: bool
    ) -> Slot:
        """One body of the inner chain walk (binning.c:688-773).

        Returns the kmer_slot to continue from (the reference advances the
        slot only when no extension happened; deletions leave it pointing at
        the next candidate already).
        """
        entry = kmer_slot.get()
        ext_slot, ext_table = self._find_extension(
            entry.key, mmer_score, forward, self_entry=entry
        )
        if ext_slot is None:
            return Slot(entry=entry)

        a = kmer_slot.get()
        b = ext_slot.get()
        new_key = self._merge_keys(a.key, b.key, forward)
        new_lists = self._merge_lists(a.val, b.val, forward)

        if b.next is a:
            # binning.c:698-708: extension node directly precedes the kmer
            # node; delete both through the extension slot.
            self.case_counts["c1"] += 1
            kmer_slot = ext_slot
            temp = kmer_slot.get()
            kmer_slot.set(temp.next)
            free_entry(temp)  # extension node
            temp = kmer_slot.get()
            kmer_slot.set(temp.next)
            free_entry(temp)  # kmer node
            mmer_hash.entry_count -= 2
        else:
            # binning.c:710-721 is dead code: its condition duplicates the
            # first branch, so kmer-directly-precedes-extension falls into
            # the generic branch where the reference would free through a
            # dangling slot; assert it cannot happen.
            if a.next is b or ext_slot.entry is a:
                raise ReplayError(
                    "kmer entry directly precedes extension entry: reference "
                    "behavior is undefined (binning.c:710 dead branch)"
                )
            self.case_counts["c3"] += 1
            temp = kmer_slot.get()
            kmer_slot.set(temp.next)
            free_entry(temp)  # kmer node
            mmer_hash.entry_count -= 1
            temp = ext_slot.get()
            ext_slot.set(temp.next)
            free_entry(temp)  # extension node
            ext_table.entry_count -= 1

        # Greedy further extension (binning.c:734-766).
        while True:
            ext_slot, ext_table = self._find_extension(
                new_key, mmer_score, forward, self_entry=None
            )
            if ext_slot is None:
                break
            e = ext_slot.get()
            new_key2 = self._merge_keys(new_key, e.key, forward)
            new_lists = self._merge_lists(new_lists, e.val, forward)
            new_key = new_key2
            if e is kmer_slot.get():
                # binning.c:745-750: extension node == iterator target
                self.case_counts["d1"] += 1
                temp = kmer_slot.get()
                kmer_slot.set(temp.next)
                free_entry(temp)
            elif e.next is kmer_slot.get():
                # binning.c:752-758: extension node precedes iterator target
                self.case_counts["d2"] += 1
                kmer_slot = ext_slot
                temp = kmer_slot.get()
                kmer_slot.set(temp.next)
                free_entry(temp)
            else:
                # binning.c:760-765: generic unlink (bare free in the
                # reference -- leaks the key, no structural difference).
                if kmer_slot.entry is e:
                    raise ReplayError(
                        "iterator slot dangles into freed extension entry "
                        "(reference UB; instrumented oracle shows this never "
                        "fires on supported inputs)"
                    )
                self.case_counts["d3"] += 1
                temp = ext_slot.get()
                ext_slot.set(temp.next)
                free_entry(temp)
            # NOTE: the reference never decrements entry_count in this loop
            # (binning.c:745-765) -- replicate the bookkeeping bug.
        self._zhash_set_no_grow_guard(mmer_hash, new_key, new_lists)
        return kmer_slot

    def _zhash_set_no_grow_guard(self, table: SimTable, key: str, val) -> None:
        before = table.size
        table.set(key, val)
        if table.size != before:
            raise ReplayError(
                "zhash_set during extension triggered a rehash while the "
                "outer loop holds bucket pointers (reference UAF hazard, "
                "binning.c:685-687 + zhash.c:184-214)"
            )

    # ------------------------------------------------------------------
    # Output (print_kmers / print_kmer_read_ids, binning.c:785-843)
    # ------------------------------------------------------------------

    def print_kmers(self) -> List[str]:
        out: List[str] = []
        while True:
            mmer_entry = self.iter_l1(self.l1, False)
            if mmer_entry is None:
                break
            l2 = mmer_entry.val
            while True:
                kmer_entry = self.iter_l2(l2, False)
                if kmer_entry is None:
                    break
                out.append(kmer_entry.key)
        return out

    def print_kmer_read_ids(self) -> str:
        lines: List[str] = []
        while True:
            mmer_entry = self.iter_l1(self.l1, False)
            if mmer_entry is None:
                break
            lines.append(mmer_entry.key)
            l2 = mmer_entry.val
            while True:
                kmer_entry = self.iter_l2(l2, False)
                if kmer_entry is None:
                    break
                lines.append(kmer_entry.key)
                for bp_list in kmer_entry.val:
                    # printf("%d ", ...) per id then newline: trailing space
                    lines.append("".join(f"{i} " for i in bp_list))
            lines.append("")
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------

    def run(
        self, groups: Sequence[Tuple[str, str, Sequence[int]]]
    ) -> List[str]:
        """Full phase replay; returns print_kmers lines."""
        self.build(groups)
        self.prune()
        self.expand()
        self.extend_all(True)
        self.extend_all(False)
        return self.print_kmers()


def groups_from_host_table(host, k: int, m: int):
    """HostTable (pre-prune extraction, int64 k-mer keys) ->
    insertion-ordered group tuples."""
    import numpy as np

    from genome_assembly_tpu_torch.ops import encode

    order = np.argsort(np.asarray(host.first_seen), kind="stable")
    out = []
    for g in order:
        mmer = encode.unpack_int(int(host.mmer[g]), m)
        kmer = encode.unpack_int(int(host.kmer[g]), k)
        out.append((mmer, kmer, [int(x) for x in host.read_ids[g]]))
    return out
