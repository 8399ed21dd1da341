"""Port vs JAX package: dBG link join, pointer jumping, materialization (CPU).

Node tables are built with numpy/Python from seeded strings, handed to both
packages (``convert`` maps the (khi, klo, valid) triple to the port's
(kmer, valid) pair), and every output is compared field by field: integers
and strings, tolerance 0.  The returned unitig list is compared in ORDER.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import dbg as jdbg
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import dbg as tdbg
from genome_assembly_tpu_torch.ops import encode as tenc

_RC = str.maketrans("ACGT", "TGCA")


def _rc(s):
    return s.translate(_RC)[::-1]


def _random_dna(seed, n):
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), size=n))


def _node_table(seqs, k, pad=0):
    """Sorted distinct canonical k-mers of `seqs` as the JAX (khi, klo, valid)
    numpy triple, with `pad` sentinel rows appended."""
    vals = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            vals.add(min(tenc.pack_str(w), tenc.pack_str(_rc(w))))
    vals = sorted(vals)
    n_lo = min(k, 16)
    hi = np.array([v >> (2 * n_lo) for v in vals] + [0xFFFFFFFF] * pad, dtype=np.uint32)
    lo = np.array([v & ((1 << (2 * n_lo)) - 1) for v in vals] + [0xFFFFFFFF] * pad,
                  dtype=np.uint32)
    valid = np.array([True] * len(vals) + [False] * pad)
    return hi, lo, valid


def _tables():
    """name -> (seqs, k, pad): random k-mer sets, path graphs, hairpins,
    repeats (cycles), with and without padding rows, k below / at / above
    the 16-base lane split."""
    g = _random_dna(1, 400)
    hairpin = _random_dna(2, 60)
    return {
        "random_reads_k11": ([_random_dna(10 + i, 40) for i in range(30)], 11, 0),
        "random_reads_k5_dense": ([_random_dna(50 + i, 30) for i in range(20)], 5, 7),
        "path_k15": ([g], 15, 0),
        "path_k17_padded": ([g], 17, 33),
        "path_k31_padded": ([_random_dna(3, 300)], 31, 5),
        "hairpin_k9": ([hairpin + _rc(hairpin)], 9, 3),
        "hairpin_k21": ([hairpin + "A" + _rc(hairpin), _random_dna(4, 80)], 21, 0),
        "tandem_repeat_cycles_k7": (
            [_random_dna(5, 12) * 6, _random_dna(6, 9) * 5, _random_dna(7, 120)], 7, 11),
        "single_node": (["ACGTTGCATGC"], 11, 0),
        "all_padding": ([], 9, 6),
    }


TABLES = _tables()


def _both_graphs(name):
    seqs, k, pad = TABLES[name]
    hi, lo, valid = _node_table(seqs, k, pad)
    jlinks = jdbg.build_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k)
    jgraph = jdbg.pointer_jump(jlinks)
    kmer, tvalid = convert.padded_keys_from_lanes(hi, lo, valid)
    tlinks = tdbg.build_unitig_links_join(kmer, tvalid, k=k)
    tgraph = tdbg.pointer_jump(tlinks)
    return (hi, lo, valid, jgraph), (kmer, tvalid, tgraph), k


@pytest.mark.parametrize("name", sorted(TABLES))
def test_build_unitig_links_join_matches_jax(name):
    (_, _, _, jgraph), (_, _, tgraph), _ = _both_graphs(name)
    want = np.asarray(jgraph.next_state)
    got = tgraph.next_state.numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("name", sorted(TABLES))
def test_pointer_jump_matches_jax_on_graphs(name):
    (_, _, _, jgraph), (_, _, tgraph), _ = _both_graphs(name)
    nxt, head, rank, is_cycle = convert.graph_to_int32(tgraph)
    assert np.array_equal(nxt, np.asarray(jgraph.next_state))
    assert np.array_equal(is_cycle, np.asarray(jgraph.is_cycle))
    assert np.array_equal(head, np.asarray(jgraph.head))
    assert np.array_equal(rank, np.asarray(jgraph.rank))


def test_cycle_tables_really_have_cycles():
    (_, _, _, jgraph), _, _ = _both_graphs("tandem_repeat_cycles_k7")
    assert bool(np.asarray(jgraph.is_cycle).any())


def _hand_built_next_state(cycle_lens, chain_lens, n_isolated, seed):
    """A functional graph with in-degree <= 1: disjoint cycles and chains
    over randomly permuted state ids, plus isolated states."""
    n = sum(cycle_lens) + sum(chain_lens) + n_isolated
    ids = np.random.default_rng(seed).permutation(n)
    nxt = np.full(n, -1, dtype=np.int32)
    at = 0
    for c in cycle_lens:
        members = ids[at : at + c]
        nxt[members] = np.roll(members, -1)
        at += c
    for c in chain_lens:
        members = ids[at : at + c]
        nxt[members[:-1]] = members[1:]
        at += c
    return nxt


@pytest.mark.parametrize(
    "cycle_lens,chain_lens,n_isolated",
    [
        ((2, 3, 4, 7), (1, 2, 5, 16, 33), 3),
        ((2,), (), 0),
        ((7, 7, 4, 4, 3, 2, 2), (9,), 1),
        ((), (64, 1, 1, 3), 2),
        ((3, 4), (100,), 0),
        ((), (), 5),
    ],
)
def test_pointer_jump_matches_jax_on_hand_built_links(cycle_lens, chain_lens, n_isolated):
    nxt = _hand_built_next_state(cycle_lens, chain_lens, n_isolated, seed=len(cycle_lens))
    want = jdbg.pointer_jump(jnp.asarray(nxt))
    got = tdbg.pointer_jump(torch.from_numpy(nxt.astype(np.int64)))
    g_nxt, head, rank, is_cycle = convert.graph_to_int32(got)
    assert np.array_equal(g_nxt, nxt)
    assert np.array_equal(is_cycle, np.asarray(want.is_cycle))
    assert int(is_cycle.sum()) == sum(cycle_lens)
    assert np.array_equal(head, np.asarray(want.head))
    assert np.array_equal(rank, np.asarray(want.rank))
    # a JAX graph carried across gives the same tensors
    carried = convert.graph_from_int32(
        np.asarray(want.next_state), np.asarray(want.head),
        np.asarray(want.rank), np.asarray(want.is_cycle))
    assert all(torch.equal(a, b) for a, b in zip(carried, got))


@pytest.mark.parametrize("name", sorted(TABLES))
def test_materialize_unitigs_matches_jax(name):
    (hi, lo, valid, jgraph), (kmer, tvalid, tgraph), k = _both_graphs(name)
    want = jdbg.materialize_unitigs(hi, lo, valid, jgraph, k)
    got = tdbg.materialize_unitigs(kmer, tvalid, tgraph, k)
    assert got == want  # same strings, same order


@pytest.mark.parametrize("name", sorted(TABLES))
def test_materialize_unitigs_cov_and_member_nodes_match_jax(name):
    (hi, lo, valid, jgraph), (kmer, tvalid, tgraph), k = _both_graphs(name)
    counts = np.random.default_rng(0).integers(1, 50, size=hi.shape[0]).astype(np.uint32)
    counts[~valid] = 0
    want, w_sum, w_n = jdbg.materialize_unitigs_cov(hi, lo, valid, jgraph, k, counts)
    got, g_sum, g_n = tdbg.materialize_unitigs_cov(
        kmer, tvalid, tgraph, k, torch.from_numpy(counts.astype(np.int64)))
    assert got == want
    assert np.array_equal(g_sum, w_sum) and np.array_equal(g_n, w_n)
    w_off, w_rows = jdbg.unitig_member_nodes(hi, lo, want, k)
    g_off, g_rows = tdbg.unitig_member_nodes(kmer, got, k)
    assert np.array_equal(g_off, w_off) and np.array_equal(g_rows, w_rows)
    # every real node lies in exactly one unitig, once
    assert np.array_equal(np.sort(g_rows), np.arange(int(valid.sum())))


def test_member_nodes_rejects_foreign_kmer():
    (_, _, _, _), (kmer, _, _), k = _both_graphs("path_k15")
    with pytest.raises(AssertionError):
        tdbg.unitig_member_nodes(kmer, ["A" * k], k)


def test_links_join_rejects_even_k():
    with pytest.raises(ValueError):
        tdbg.build_unitig_links_join(
            torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool), k=10)


def test_links_join_on_empty_table():
    links = tdbg.build_unitig_links_join(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool), k=11)
    graph = tdbg.pointer_jump(links)
    assert links.shape == (0,) and graph.head.shape == (0,)
    assert tdbg.materialize_unitigs(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool), graph, 11) == []
