"""Port vs JAX package: the dBG phases past device memory (CPU).

``build_unitig_links_ooc`` (hash-partitioned link join), ``pointer_jump_bulk``
(per-round jump, chunked rounds) and ``materialize_unitigs_device`` go through
both packages on the node tables of tests/test_torch_dbg.py (random reads,
paths, hairpins, tandem-repeat cycles, padding) and on hand-built link
arrays; each must equal the JAX function AND the port's in-core
counterpart (``build_unitig_links_join``, ``pointer_jump``,
``materialize_unitigs[_cov]``), integers and strings at tolerance 0, the
unitig list in ORDER.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import dbg as jdbg
from genome_assembly_tpu.ops import outofcore as jooc
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import dbg as tdbg
from genome_assembly_tpu_torch.ops import outofcore as tooc

from test_torch_dbg import TABLES, _hand_built_next_state, _node_table

# the node tables of tests/test_torch_dbg.py, and tests/test_dbg.py's
# palindromic junction (GGATCC), padded
CASES = dict(TABLES, palindrome_junction_k7=(["ACGTGCAATCGGATCCA"], 7, 2))
LINK_TABLES = ["random_reads_k11", "path_k17_padded", "path_k31_padded",
               "hairpin_k21", "tandem_repeat_cycles_k7"]


def _keys(name):
    seqs, k, pad = CASES[name]
    hi, lo, valid = _node_table(seqs, k, pad)
    kmer, tvalid = convert.padded_keys_from_lanes(hi, lo, valid)
    return (hi, lo, valid), (kmer, tvalid), k


def _links_both(name, jax_kw=None, **kw):
    """(JAX links, its overflow count, the port's links, the port's join);
    ``jax_kw`` goes to the JAX call alone."""
    (hi, lo, valid), (kmer, tvalid), k = _keys(name)
    want, wovf = jdbg.build_unitig_links_ooc(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k, **kw, **(jax_kw or {}))
    got = tdbg.build_unitig_links_ooc(kmer, tvalid, k=k, **kw)
    join = tdbg.build_unitig_links_join(kmer, tvalid, k=k)
    return np.asarray(want).astype(np.int64), int(wovf), got, join


def _force_plan(monkeypatch, module, tiny_cap=False, **force):
    """module.range_group_plan with some of its arguments forced, and with
    ``tiny_cap`` a staging cap far below every partition's share."""
    real = module.range_group_plan

    def plan(n_units, unit_records, **kw):
        cap_bp, G = real(n_units, unit_records, **{**kw, **force})
        return (max(16, unit_records // 32) if tiny_cap else cap_bp), G
    monkeypatch.setattr(module, "range_group_plan", plan)


@pytest.mark.parametrize("name", LINK_TABLES)
@pytest.mark.parametrize("partitions,chunk_nodes,group_size", [(3, 32, None), (5, 128, 2)])
def test_links_ooc_match_jax_and_the_join(monkeypatch, name, partitions, chunk_nodes,
                                          group_size):
    """Chunks that split the node array and pad it, one and several passes
    (the port's group width forced through its plan)."""
    if group_size is not None:
        _force_plan(monkeypatch, tooc, group_size=group_size)
    want, wovf, got, join = _links_both(
        name, partitions=partitions, chunk_nodes=chunk_nodes,
        jax_kw=dict(group_size=group_size))
    assert got.dtype == torch.int64 and got.shape == join.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, join)
    assert wovf == 0
    assert (got >= 0).any() or name == "single_node"


@pytest.mark.parametrize("name,chunk_nodes", [("path_k17_padded", 256),
                                              ("random_reads_k11", 64)])
def test_links_ooc_self_heal_forced_cap_overflow(monkeypatch, caplog, name, chunk_nodes):
    """tests/test_dbg.py's forced overflow: a staging cap far below every
    partition's share in both packages; the overflowed partitions are
    re-extracted alone and the links still equal the join."""
    for module in (jooc, tooc):
        _force_plan(monkeypatch, module, tiny_cap=True)
    with caplog.at_level("WARNING"):
        want, wovf, got, join = _links_both(name, partitions=4, chunk_nodes=chunk_nodes)
    assert wovf == 0
    assert any("re-extracting alone" in r.message for r in caplog.records)
    assert np.array_equal(got.numpy(), want) and torch.equal(got, join)


def test_materialize_device_refuses_more_states_than_the_walk_sort_packs(monkeypatch):
    """The walk sort packs a state id and a rank into one int64: a graph
    past MAX_WALK_STATES is refused, not sorted into a wrong order."""
    (_, _, _), (kmer, tvalid), k = _keys("path_k17_padded")
    graph = tdbg.pointer_jump(tdbg.build_unitig_links_join(kmer, tvalid, k=k))
    assert tdbg.materialize_unitigs_device(kmer, tvalid, graph, k)[0]
    monkeypatch.setattr(tdbg, "MAX_WALK_STATES", graph.head.shape[0] - 1)
    with pytest.raises(ValueError, match="walk sort"):
        tdbg.materialize_unitigs_device(kmer, tvalid, graph, k)


def test_links_ooc_rejects_even_k():
    with pytest.raises(ValueError):
        tdbg.build_unitig_links_ooc(torch.zeros(4, dtype=torch.int64),
                                    torch.ones(4, dtype=torch.bool), k=10, partitions=2)


def _jump_inputs():
    """name -> next_state (int32 numpy): the link arrays of the tables and
    hand-built functional graphs (chains, cycles, isolated states)."""
    out = {}
    for name in LINK_TABLES:
        (hi, lo, valid), _, k = _keys(name)
        out[name] = np.asarray(jdbg.build_unitig_links_join(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k))
    out["hand_built"] = _hand_built_next_state((2, 3, 4, 7), (1, 2, 5, 16, 33), 3, seed=4)
    out["hand_built_acyclic"] = _hand_built_next_state((), (64, 1, 1, 3), 2, seed=4)
    return out


JUMP_INPUTS = _jump_inputs()


@pytest.mark.parametrize("name", sorted(JUMP_INPUTS))
@pytest.mark.parametrize("chunked", [False, True])
def test_pointer_jump_bulk_matches_jax_and_the_jump(name, chunked):
    """Two-lane rounds, the three-lane rerun when there are cycles, and
    chunked rounds with a chunk count that needs padding rows."""
    nxt = JUMP_INPUTS[name]
    lowmem_chunks = next(c for c in (3, 7, 11) if nxt.shape[0] % c) if chunked else 0
    want = jdbg.pointer_jump_bulk(jnp.asarray(nxt), lowmem_chunks=lowmem_chunks)
    ns = torch.from_numpy(nxt.astype(np.int64))
    got = tdbg.pointer_jump_bulk(ns, lowmem_chunks=lowmem_chunks)
    fused = tdbg.pointer_jump(ns)
    assert got.head.shape == ns.shape and got.head.dtype == torch.int64
    g = convert.graph_to_int32(got)
    for a, f in zip(g, ("next_state", "head", "rank", "is_cycle")):
        assert np.array_equal(a, np.asarray(getattr(want, f))), f
    assert all(torch.equal(a, b) for a, b in zip(got, fused))


def test_jump_inputs_hold_cycles_and_acyclic_graphs():
    cyc = {n: bool(tdbg.pointer_jump(torch.from_numpy(x.astype(np.int64))).is_cycle.any())
           for n, x in JUMP_INPUTS.items()}
    assert cyc["tandem_repeat_cycles_k7"] and cyc["hand_built"]
    assert not cyc["hand_built_acyclic"] and not cyc["path_k31_padded"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_materialize_device_matches_jax_and_the_host(name):
    """Linear chains, cycles, hairpins, a palindromic junction, padding rows;
    with and without node counts."""
    (hi, lo, valid), (kmer, tvalid), k = _keys(name)
    jgraph = jdbg.pointer_jump(jdbg.build_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k))
    tgraph = tdbg.pointer_jump(tdbg.build_unitig_links_join(kmer, tvalid, k=k))
    want, w_occ, w_n = jdbg.materialize_unitigs_device(hi, lo, valid, jgraph, k)
    got, g_occ, g_n = tdbg.materialize_unitigs_device(kmer, tvalid, tgraph, k)
    assert got == want == tdbg.materialize_unitigs(kmer, tvalid, tgraph, k)
    assert g_occ.size == g_n.size == 0 and g_occ.dtype == w_occ.dtype
    counts = np.random.default_rng(1).integers(1, 9, size=hi.shape[0]).astype(np.uint32)
    counts[~valid] = 0
    want = jdbg.materialize_unitigs_device(hi, lo, valid, jgraph, k, counts)
    got = tdbg.materialize_unitigs_device(
        kmer, tvalid, tgraph, k, torch.from_numpy(counts.astype(np.int64)))
    host = tdbg.materialize_unitigs_cov(
        kmer, tvalid, tgraph, k, torch.from_numpy(counts.astype(np.int64)))
    assert got[0] == want[0] == host[0]
    for g, w, h in zip(got[1:], want[1:], host[1:]):
        assert np.array_equal(g, w) and np.array_equal(g, h) and g.dtype == w.dtype


def test_materialize_cases_hold_cycles_and_a_palindromic_junction():
    _, (kmer, tvalid), k = _keys("tandem_repeat_cycles_k7")
    assert bool(tdbg.pointer_jump(tdbg.build_unitig_links_join(kmer, tvalid, k=k)).is_cycle.any())
    seq = CASES["palindrome_junction_k7"][0][0]
    assert "GGATCC" in seq and tdbg._rc_str("GGATCC") == "GGATCC"
