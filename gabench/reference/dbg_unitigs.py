"""Plain reference of a fast-mode assembly, and the comparison that decides
``correct``.

Plain torch on whatever device the caller names; it imports nothing of the
program.  The semantics, stated for strings:

* a k-mer's canonical form is the lexicographically smaller of the k-mer and
  its reverse complement;
* every window of k bases of every read is counted under its canonical
  form, and a k-mer is kept iff its count is above the cutoff;
* each kept k-mer has two states, the k-mer as kept and its reverse
  complement; state s has an edge to state t iff the last k - 1 bases of s
  are the first k - 1 of t.  The edge is a unitig edge iff s has that one
  successor, t has that one predecessor, and t is not s read on the other
  strand;
* a unitig is a maximal path of unitig edges, or a cycle of them, spelled
  as its first state's k bases and then the last base of each later state;
  each unitig is given once, on either strand.

The comparison reads the program's output only to judge it: spellings are
compared on a strand-free form (a cycle also free of its starting point), so
neither side's choice of strand or start matters.

Reads are fixed-length ACGT rows (``generate.ReadSet``).  Keys pack a k-mer
two bits a base, A C G T = 0 1 2 3, the first base highest, so key order is
string order.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# every number compared is a count of mismatches, held to 0
LIMITS = {"reads_diff": 0, "kmers_diff": 0, "ends_diff": 0, "unitigs_diff": 0}

BLOCK_ROWS = 1 << 20
_CODE = np.full(256, 4, dtype=np.uint8)
_CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _check_k(k: int) -> None:
    if not (k % 2 == 1 and 1 <= k <= 31):
        raise ValueError(f"the reference takes odd k <= 31 (no palindromic k-mers), got {k}")


def window_keys(codes: torch.Tensor, k: int):
    """(forward, reverse-complement) keys of every window of [R, L] codes
    0..3, each [R, L - k + 1] int64."""
    c = codes.long()
    w = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], w), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[:, j:j + w]
        rc = rc | ((3 - c[:, j:j + w]) << (2 * j))
    return fwd, rc


def reverse_complement(keys: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros_like(keys)
    for j in range(k):
        out = (out << 2) | (3 - ((keys >> (2 * j)) & 3))
    return out


def canonical_windows(reads: np.ndarray, k: int, device) -> torch.Tensor:
    """Canonical keys of every window of every read (ASCII rows)."""
    parts = []
    for lo in range(0, reads.shape[0], BLOCK_ROWS):
        codes = torch.from_numpy(_CODE[reads[lo:lo + BLOCK_ROWS]]).to(device)
        fwd, rc = window_keys(codes, k)
        parts.append(torch.minimum(fwd, rc).reshape(-1))
    return torch.cat(parts)


def member(sorted_set: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x's elements that are in a sorted 1-D tensor."""
    if sorted_set.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    i = torch.searchsorted(sorted_set, x).clamp(max=sorted_set.numel() - 1)
    return sorted_set[i] == x


def kept_kmers(reads: np.ndarray, k: int, cutoff: int, device):
    """Sorted canonical keys whose count is above the cutoff."""
    _check_k(k)
    uniq, counts = torch.unique(canonical_windows(reads, k, device), sorted=True,
                                return_counts=True)
    return uniq[counts > cutoff]


def _rank(prev: torch.Tensor, rounds: int):
    """(root, distance) of every state along ``prev``: pointer doubling."""
    ids = torch.arange(prev.numel(), device=prev.device)
    root = torch.where(prev >= 0, prev, ids)
    dist = (prev >= 0).long()
    for _ in range(rounds):
        dist = dist + dist[root]
        root = root[root]
    return root, dist


def unitig_spellings(kept: torch.Tensor, k: int) -> List[str]:
    """Every unitig of the graph of the sorted kept keys, once each."""
    _check_k(k)
    n = kept.numel()
    if n == 0:
        return []
    device = kept.device
    mask = (1 << (2 * k)) - 1
    val = torch.stack([kept, reverse_complement(kept, k)], dim=1).reshape(-1)
    states = torch.arange(2 * n, device=device)
    succ = torch.full_like(states, -1)
    outdeg = torch.zeros_like(states)
    for base in range(4):
        t = ((val << 2) | base) & mask
        canon = torch.minimum(t, reverse_complement(t, k))
        idx = torch.searchsorted(kept, canon).clamp(max=n - 1)
        hit = kept[idx] == canon
        outdeg += hit
        succ = torch.where(hit, 2 * idx + (t != canon), succ)
    # a state's predecessors are the successors of its other strand
    indeg = outdeg.view(n, 2).flip(1).reshape(-1)
    unitig_edge = (outdeg == 1) & (indeg[succ.clamp(min=0)] == 1) & (succ != (states ^ 1))
    prev = torch.full_like(states, -1)
    prev[succ[unitig_edge]] = states[unitig_edge]

    rounds = max(1, math.ceil(math.log2(2 * n))) + 1
    root, _ = _rank(prev, rounds)
    on_cycle = prev[root] >= 0
    if bool(on_cycle.any()):
        # start each cycle at its smallest state
        low = torch.where(on_cycle, states, 2 * n)
        back = torch.where(on_cycle, prev, states)
        for _ in range(rounds):
            low = torch.minimum(low, low[back])
            back = back[back]
        prev = torch.where(on_cycle & (low == states), -1, prev)
    head, rank = _rank(prev, rounds)

    # a unitig is walked on both strands: keep one walk per smallest node
    low_node = torch.full_like(states, n).scatter_reduce(0, head, states >> 1, reduce="amin")
    low_head = torch.full_like(states, 2 * n).scatter_reduce(
        0, low_node[head], head, reduce="amin")
    keep = low_head[low_node[head]] == head
    order = torch.argsort(head * (2 * n) + rank)
    order = order[keep[order]]
    h, r = head[order], rank[order]
    starts = torch.ones_like(keep[order])
    starts[1:] = h[1:] != h[:-1]
    first = order[starts]
    chain = torch.cumsum(starts.long(), 0) - 1
    lengths = torch.bincount(chain) + (k - 1)
    offsets = torch.zeros(first.numel() + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lengths, 0)
    buf = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
    for j in range(k):
        buf[offsets[:-1] + j] = ((val[first] >> (2 * (k - 1 - j))) & 3).to(torch.uint8)
    later = ~starts
    buf[offsets[chain[later]] + (k - 1) + r[later]] = (val[order[later]] & 3).to(torch.uint8)
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[buf.cpu().numpy()].tobytes().decode()
    offs = offsets.cpu().tolist()
    return [text[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def _rc(s: str) -> str:
    return s.encode().translate(_RC)[::-1].decode()


def least_rotation(s: str) -> str:
    """The lexicographically least rotation of s (Booth)."""
    d = s + s
    fail = [-1] * len(d)
    best = 0
    for j in range(1, len(d)):
        c, i = d[j], fail[j - best - 1]
        while i != -1 and c != d[best + i + 1]:
            if c < d[best + i + 1]:
                best = j - i - 1
            i = fail[i]
        if i == -1 and c != d[best]:
            if c < d[best]:
                best = j
            fail[j - best] = -1
        else:
            fail[j - best] = i + 1
    return d[best:best + len(s)]


def strand_free(s: str, k: int):
    """A spelling's form free of strand, and, where it closes on itself
    (its first k - 1 bases are its last), of where the cycle starts."""
    if len(s) >= k and s[:k - 1] == s[len(s) - k + 1:]:
        period = s[:len(s) - k + 1]
        return ("cycle", min(least_rotation(period), least_rotation(_rc(period))))
    return ("path", min(s, _rc(s)))


def _ends(s: str, k: int):
    if len(s) >= k and s[:k - 1] == s[len(s) - k + 1:]:
        return ("cycle", len(s) - k + 1)
    if len(s) < k:
        return ("short", s)
    a, b = s[:k], s[len(s) - k:]
    return tuple(sorted((min(a, _rc(a)), min(b, _rc(b)))))


def _multiset_diff(a, b) -> int:
    ca, cb = collections.Counter(a), collections.Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def spelled_kmers(spellings: Sequence[str], k: int, device):
    """(canonical keys of every window of the spellings, windows that hold
    a letter other than ACGT, spellings shorter than k)."""
    if not spellings:
        return torch.zeros(0, dtype=torch.int64, device=device), 0, 0
    flat = np.frombuffer("".join(spellings).encode(), dtype=np.uint8)
    lengths = torch.tensor([len(s) for s in spellings], dtype=torch.int64)
    short = int((lengths < k).sum())
    codes = torch.from_numpy(_CODE[flat]).to(device)
    if codes.numel() < k:
        return torch.zeros(0, dtype=torch.int64, device=device), 0, short
    fwd, rc = window_keys(codes.clamp(max=3)[None, :], k)
    canon = torch.minimum(fwd, rc)[0]
    which = torch.repeat_interleave(torch.arange(len(spellings)), lengths).to(device)
    inside = which[: canon.numel()] == which[k - 1:]
    bad = torch.cumsum(torch.cat([codes.new_zeros(1, dtype=torch.int64), (codes == 4).long()]), 0)
    clean = (bad[k:] - bad[: canon.numel()]) == 0
    return canon[inside & clean], int((inside & ~clean).sum()), short


class Expected:
    """What the reference makes of one read set: kept keys and unitigs."""

    def __init__(self, reads: np.ndarray, params: dict, device):
        self.reads = reads
        self.k = params["k"]
        self.kept = kept_kmers(reads, self.k, params["abundance_cutoff"], device)
        self.spellings = unitig_spellings(self.kept, self.k)
        self.forms = [strand_free(s, self.k) for s in self.spellings]
        self.ends = [_ends(s, self.k) for s in self.spellings]


def reads_diff(made: np.ndarray, loaded: Sequence[str]) -> int:
    """Reads loaded that differ from those written, and reads missing or extra."""
    n = min(len(loaded), made.shape[0])
    diff = abs(len(loaded) - made.shape[0])
    joined = "".join(loaded[:n]).encode()
    if len(joined) == made[:n].size:
        return diff + int((np.frombuffer(joined, dtype=np.uint8).reshape(made[:n].shape)
                           != made[:n]).any(axis=1).sum())
    return diff + sum(a != b.tobytes().decode() for a, b in zip(loaded[:n], made[:n]))


def judge(expected: Expected, loaded: Sequence[str], output: Sequence[str],
          device) -> Dict[str, int]:
    """The numbers compared, each a count of mismatches against the
    reference: reads loaded, kept k-mers the output covers (each once),
    unitig ends, and unitig spellings."""
    k = expected.k
    keys, unclean, short = spelled_kmers(output, k, device)
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    kept = expected.kept.to(device)
    kmers = (int((counts - 1).sum()) + int((~member(kept, uniq)).sum())
             + int((~member(uniq, kept)).sum()) + unclean + short)
    return {
        "reads_diff": reads_diff(expected.reads, loaded),
        "kmers_diff": kmers,
        "ends_diff": _multiset_diff([_ends(s, k) for s in output], expected.ends),
        "unitigs_diff": _multiset_diff([strand_free(s, k) for s in output], expected.forms),
    }
