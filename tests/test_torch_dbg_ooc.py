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
from genome_assembly_tpu.utils import checkpoint as jckpt
from genome_assembly_tpu_torch import common as tcommon
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import dbg as tdbg
from genome_assembly_tpu_torch.ops import outofcore as tooc
from genome_assembly_tpu_torch.utils import checkpoint as ckpt

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


# -- the parked link builder -------------------------------------------------

PARKED_TABLES = ["random_reads_k11", "path_k31_padded", "tandem_repeat_cycles_k7"]


@pytest.mark.parametrize("name", PARKED_TABLES)
@pytest.mark.parametrize("park_keys,park_links", [(False, False), (True, False),
                                                  (False, True), (True, True)])
def test_links_parked_match_jax_ooc_and_join(name, park_keys, park_links):
    """Keys parked on the host (uploaded a chunk at a time), links parked
    (edges read back per partition), both or neither: the links equal the
    JAX package's parked builder, the out-of-core builder and the join;
    the events are the JAX package's, partition by partition."""
    (hi, lo, valid), (kmer, tvalid), k = _keys(name)
    jargs = (hi, lo, valid) if park_keys else tuple(map(jnp.asarray, (hi, lo, valid)))
    jev, tev = [], []
    want, wovf = jdbg.build_unitig_links_parked(
        *jargs, k=k, partitions=3, chunk_nodes=64, park_links=park_links,
        on_event=lambda kind, **kw: jev.append((kind, kw)))
    targs = (kmer.numpy(), tvalid.numpy()) if park_keys else (kmer, tvalid)
    got = tdbg.build_unitig_links_parked(
        *targs, k=k, partitions=3, chunk_nodes=64, park_links=park_links,
        on_event=lambda kind, **kw: tev.append((kind, kw)), device="cpu")
    assert isinstance(got, np.ndarray) == park_links and wovf == 0
    got = torch.as_tensor(got)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert torch.equal(got, tdbg.build_unitig_links_join(kmer, tvalid, k=k))
    assert torch.equal(got, tdbg.build_unitig_links_ooc(kmer, tvalid, k=k, partitions=3,
                                                        chunk_nodes=64))
    # the JAX package's fields, and the port's staging cap and overflow counts
    port_only = ("wall_s", "cap_bp", "overflowed_chunks")
    strip = [(kind, {f: v for f, v in kw.items() if f != "wall_s"}) for kind, kw in jev]
    assert [(kind, {f: v for f, v in kw.items() if f not in port_only})
            for kind, kw in tev] == strip
    assert {kind for kind, _ in tev} == {"link_pass", "link_partition"}
    passes = [kw for kind, kw in tev if kind == "link_pass"]
    assert all(kw["cap_bp"] > 0 and not any(kw["overflowed_chunks"]) for kw in passes)


def test_links_parked_self_heal_reports_the_reextraction(monkeypatch, caplog):
    """A staging cap far below every partition's share: each overflowed
    partition is re-extracted alone, reported as ``link_reextract``, and
    the parked links still equal the join."""
    _force_plan(monkeypatch, tooc, tiny_cap=True)
    _, (kmer, tvalid), k = _keys("random_reads_k11")
    events = []
    with caplog.at_level("WARNING"):
        got = tdbg.build_unitig_links_parked(
            kmer.numpy(), tvalid.numpy(), k=k, partitions=4, chunk_nodes=64, park_links=True,
            on_event=lambda kind, **kw: events.append((kind, kw)), device="cpu")
    assert torch.equal(torch.from_numpy(got), tdbg.build_unitig_links_join(kmer, tvalid, k=k))
    healed = [kw["p"] for kind, kw in events if kind == "link_reextract"]
    joined = [kw["p"] for kind, kw in events if kind == "link_partition"]
    assert healed and set(healed) <= set(joined) and sorted(joined) == [0, 1, 2, 3]
    # the pass reports each partition's overflowed chunks; a healed one has some
    over = {}
    for kind, kw in events:
        if kind == "link_pass":
            g, n = kw["g"], len(kw["overflowed_chunks"])
            over.update({g * n + r: c for r, c in enumerate(kw["overflowed_chunks"])})
    assert sorted(healed) == sorted(p for p, c in over.items() if c > 0 and p < 4)
    assert all(kw["overflowed_chunks"] == over[kw["p"]] > 0
               for kind, kw in events if kind == "link_reextract")


def test_compact_edges_matches_jax():
    rng = np.random.default_rng(7)
    src = np.where(rng.random(500) < 0.4, -1, rng.permutation(4000)[:500]).astype(np.int64)
    dst = rng.integers(0, 4000, 500).astype(np.int64)
    wkey, wdst, wn = jdbg._compact_edges(jnp.asarray(src.astype(np.int32)),
                                         jnp.asarray(dst.astype(np.int32)))
    key, gdst, n = tdbg._compact_edges(torch.from_numpy(src), torch.from_numpy(dst))
    n = int(n)
    assert n == int(wn) == int((src >= 0).sum())
    assert np.array_equal(key[:n].numpy(), np.asarray(wkey)[:n].astype(np.int64))
    assert np.array_equal(gdst[:n].numpy(), np.asarray(wdst)[:n].astype(np.int64))
    assert (key[n:] == tcommon.SENTINEL).all()


# -- jump frontier checkpoints -------------------------------------------------

class _Killed(Exception):
    pass


def _kill_after(n_rounds):
    """An on_round that stops the jump (as a kill would) after n_rounds."""
    seen = [0]

    def on_round(r, dt):
        seen[0] += 1
        if seen[0] == n_rounds:
            raise _Killed
    return on_round


@pytest.mark.parametrize("name", ["tandem_repeat_cycles_k7", "hand_built", "path_k31_padded",
                                  "hand_built_acyclic"])
@pytest.mark.parametrize("lowmem_kill,lowmem_resume", [(0, 0), (3, 3), (3, 0), (0, 5)])
def test_pointer_jump_bulk_killed_and_resumed(tmp_path, name, lowmem_kill, lowmem_resume):
    """Killed after round 2 with a frontier saved every round, then resumed
    (chunked or not, either way round): the graph equals an uninterrupted
    jump bit for bit, the three-lane rerun on cycles included; and a
    frontier of another link array is not resumed."""
    nxt = torch.from_numpy(JUMP_INPUTS[name].astype(np.int64))
    whole = tdbg.pointer_jump_bulk(nxt)
    ck = tmp_path / "jump"
    with pytest.raises(_Killed):
        tdbg.pointer_jump_bulk(nxt, checkpoint_dir=str(ck), checkpoint_every=1,
                               lowmem_chunks=lowmem_kill, on_round=_kill_after(2))
    saved = ckpt.load_jump_frontier(str(ck), 2, ckpt.jump_fingerprint(nxt))
    assert saved is not None and saved[2] >= 1
    rounds = []
    got = tdbg.pointer_jump_bulk(nxt, checkpoint_dir=str(ck), checkpoint_every=1,
                                 lowmem_chunks=lowmem_resume,
                                 on_round=lambda r, dt: rounds.append(r))
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert rounds[0] == saved[2]  # resumed at the saved round, not round 0
    other = nxt.clone()
    other[0] = -1 if int(other[0]) >= 0 else 1
    assert ckpt.load_jump_frontier(str(ck), 2, ckpt.jump_fingerprint(other)) is None


@pytest.mark.parametrize("name", ["tandem_repeat_cycles_k7", "path_k31_padded"])
def test_jump_frontiers_resume_across_packages(tmp_path, name):
    """A frontier the JAX package saved resumes in the port, and one the
    port saved resumes in the JAX package; both equal an uninterrupted jump."""
    nxt = JUMP_INPUTS[name]
    ns = torch.from_numpy(nxt.astype(np.int64))
    assert ckpt.jump_fingerprint(ns) == jckpt.jump_fingerprint(jnp.asarray(nxt))
    want = jdbg.pointer_jump_bulk(jnp.asarray(nxt))
    for writer in ("jax", "port"):
        ck = str(tmp_path / writer)
        with pytest.raises(_Killed):
            if writer == "jax":
                jdbg.pointer_jump_bulk(jnp.asarray(nxt), checkpoint_dir=ck, checkpoint_every=1,
                                       on_round=_kill_after(2))
            else:
                tdbg.pointer_jump_bulk(ns, checkpoint_dir=ck, checkpoint_every=1,
                                       on_round=_kill_after(2))
        saved = ckpt.load_jump_frontier(ck, 2, ckpt.jump_fingerprint(ns))
        assert saved is not None and saved[2] >= 1
        rounds = []
        if writer == "jax":
            got = convert.graph_to_int32(tdbg.pointer_jump_bulk(
                ns, checkpoint_dir=ck, on_round=lambda r, dt: rounds.append(r)))
        else:
            got = [np.asarray(x) for x in jdbg.pointer_jump_bulk(
                jnp.asarray(nxt), checkpoint_dir=ck, on_round=lambda r, dt: rounds.append(r))]
        assert rounds[0] == saved[2], writer
        for a, f in zip(got, ("next_state", "head", "rank", "is_cycle")):
            assert np.array_equal(np.asarray(a), np.asarray(getattr(want, f))), (writer, f)


# -- the bucketed host materializer --------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("partitions", [1, 3, 8])
def test_materialize_partitioned_matches_jax_and_the_set(name, partitions):
    """Equal to the JAX package's bucketed materializer IN ORDER, and to
    ``materialize_unitigs`` as a set (cycles, palindromes, padding)."""
    (hi, lo, valid), (kmer, tvalid), k = _keys(name)
    jgraph = jdbg.pointer_jump(jdbg.build_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k))
    tgraph = tdbg.pointer_jump(tdbg.build_unitig_links_join(kmer, tvalid, k=k))
    want = jdbg.materialize_unitigs_partitioned(hi, lo, valid, jgraph, k, partitions)
    got = tdbg.materialize_unitigs_partitioned(kmer, tvalid, tgraph, k, partitions)
    assert got == want
    assert sorted(got) == sorted(tdbg.materialize_unitigs(kmer, tvalid, tgraph, k))
    assert got == tdbg.materialize_unitigs_partitioned(kmer.numpy(), tvalid.numpy(),
                                                       tgraph, k, partitions)
