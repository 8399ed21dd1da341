"""The port's communication model (parallel/comm_model.py) against the JAX
package's, and against the traffic the port's own routers carry.

The matrices are exact functions of the input: each is held equal to the
JAX function's on the same numpy input (tolerance 0).  The pure models are
held equal to JAX's on the same matrices with the byte widths and rates
passed equal (tolerance 0: every operand is an integer-valued float64, so
both orders of the arithmetic round alike).  Then the assertions of
tests/test_comm_model.py on the port: row and column sums against
``sharded_count`` on an 8-shard CPU mesh, the jump matrices' peaks as the
jump's exact overflow threshold, and the parked-links model's pass plan
against ``build_unitig_links_parked``'s events.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import count as jcount
from genome_assembly_tpu.ops import dbg as jdbg
from genome_assembly_tpu.ops import minimizer as jmin
from genome_assembly_tpu.parallel import comm_model as jcm
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg, minimizer
from genome_assembly_tpu_torch.parallel import comm_model, part_dbg, shard_count
from genome_assembly_tpu_torch.parallel import mesh as mesh_lib

K, M = 21, 5


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    reads = 256
    codes = rng.integers(0, 4, size=(reads, 64), dtype=np.uint8)
    lengths = rng.integers(K - 3, 65, size=reads).astype(np.int32)
    return codes, lengths


@pytest.fixture(scope="module")
def kept(batch):
    """JAX's kept keys of the batch as lanes, and the port's int64 key."""
    codes, lengths = batch
    recs = jmin.fast_scan(jnp.asarray(codes), jnp.asarray(lengths), k=K, m=M)
    khi, klo, valid = jcount.kept_keys_sorted(jcount.count_keys(recs, cutoff=0))
    khi, klo, valid = np.asarray(khi), np.asarray(klo), np.asarray(valid)
    kmer, valid_t = convert.padded_keys_from_lanes(khi, klo, valid)
    return khi, klo, valid, kmer, valid_t


@pytest.fixture(scope="module")
def links(kept):
    khi, klo, valid, _, _ = kept
    return np.asarray(jdbg.build_unitig_links_join(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid), k=K)).astype(np.int64)


def _jax_hw():
    return jcm.Hardware(ici_links=1, ici_gbps_per_link=45e9, ici_utilization=1.0,
                        count_records_per_s=5e8, link_records_per_s=3e8,
                        jump_states_per_s=1.5e8, dcn_bytes_per_s=25e9)


def _port_hw():
    return comm_model.Hardware(link_bytes_per_s=45e9, network_bytes_per_s=25e9,
                               count_records_per_s=5e8, link_records_per_s=3e8,
                               jump_states_per_s=1.5e8)


def _jump_test_graph(n2=512):
    """Long cross-shard chain + a cycle + short chains (tests/test_comm_model.py's)."""
    next_state = np.full(n2, -1, dtype=np.int64)
    chain = np.arange(0, n2, 9)
    for a, b in zip(chain[:-1], chain[1:]):
        next_state[a] = b
    cyc = np.arange(100, 116)
    cyc = cyc[~np.isin(cyc, chain)]
    for a, b in zip(cyc, np.roll(cyc, -1)):
        next_state[a] = b
    for a in range(480, 500, 2):
        if next_state[a] < 0 and a + 1 not in chain:
            next_state[a] = a + 1
    return next_state


# ---------------------------------------------------------------------------
# the matrices == JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("parity", [False, True], ids=["fast", "parity"])
@pytest.mark.parametrize("route_by", ["mmer", "key"])
def test_count_matrix_equals_jax(batch, n_shards, parity, route_by):
    codes, lengths = batch
    want = jcm.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=n_shards,
                                     parity=parity, route_by=route_by)
    got = comm_model.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=n_shards,
                                           parity=parity, route_by=route_by)
    assert got.dtype == np.int64 and got.shape == (n_shards, n_shards)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_links_matrix_equals_jax(kept, n_shards):
    khi, klo, valid, kmer, valid_t = kept
    want = jcm.links_exchange_matrix(khi, klo, valid, k=K, n_shards=n_shards)
    got = comm_model.links_exchange_matrix(kmer, valid_t, k=K, n_shards=n_shards)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph", ["test_graph", "batch_links"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_jump_matrices_equal_jax(links, graph, n_shards):
    ns = _jump_test_graph() if graph == "test_graph" else links
    jp, jr, jf = jcm.jump_request_matrices(ns.astype(np.int32), n_shards=n_shards)
    pp, pr, pf = comm_model.jump_request_matrices(torch.from_numpy(ns), n_shards=n_shards)
    np.testing.assert_array_equal(pp, jp)
    assert len(pr) == len(jr) == part_dbg.jump_rounds(ns.shape[0])
    for a, b in zip(pr, jr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pf, jf)
    assert all(int(np.trace(x)) == 0 for x in [pp, pf, *pr])


@pytest.mark.parametrize("n, n_slices", [(8, 2), (8, 4), (16, 2)])
def test_two_level_split_equals_jax(n, n_slices):
    mat = np.random.default_rng(n + n_slices).integers(0, 1000, size=(n, n)).astype(np.int64)
    assert comm_model.two_level_split(mat, n_slices=n_slices) == \
        jcm.two_level_split(mat, n_slices=n_slices)


# ---------------------------------------------------------------------------
# the pure models == JAX's, byte widths and rates passed equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8])
def test_phase_and_pipeline_models_equal_jax(n):
    mat = np.random.default_rng(n).integers(100, 1000, size=(n, n)).astype(np.int64)
    kw = dict(bytes_per_record=20, records_per_s=5e8)
    assert comm_model.phase_model(mat, hw=_port_hw(), **kw) == \
        jcm.phase_model(mat, hw=_jax_hw(), **kw)
    for b in (1, 8):
        assert comm_model.pipeline_model(mat, n_batches=b, hw=_port_hw(), **kw) == \
            jcm.pipeline_model(mat, n_batches=b, hw=_jax_hw(), **kw)


@pytest.mark.parametrize("n_batches", [1, 8])
def test_two_level_phase_model_equals_jax(batch, n_batches):
    codes, lengths = batch
    mat = comm_model.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=8)
    kw = dict(n_slices=2, bytes_per_record=20, records_per_s=5e8, n_batches=n_batches)
    assert comm_model.two_level_phase_model(mat, hw=_port_hw(), **kw) == \
        jcm.two_level_phase_model(mat, hw=_jax_hw(), **kw)


@pytest.mark.parametrize("lanes", [(2, 1), (1, 3), (1, 6)])
def test_gather_phase_model_equals_jax(lanes):
    req, resp = lanes
    mat = np.random.default_rng(resp).integers(0, 500, size=(8, 8)).astype(np.int64)
    np.fill_diagonal(mat, 0)
    kw = dict(states_per_shard=1000, states_per_s=1.5e8)
    assert comm_model.gather_phase_model(mat, req_bytes=4 * req, resp_bytes=4 * resp,
                                         hw=_port_hw(), **kw) == \
        jcm.gather_phase_model(mat, req_lanes=req, resp_lanes=resp, hw=_jax_hw(), **kw)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_extension_phase_model_equals_jax_at_its_lane_widths(kept, links, wide):
    """JAX's narrow and wide pricing are the port's model with JAX's widths
    passed: link records 3 or 4 lanes, answers 3 or 6, the rest 1 or 2."""
    khi, klo, valid, kmer, valid_t = kept
    n = 8
    lmat = comm_model.links_exchange_matrix(kmer, valid_t, k=K, n_shards=n)
    want = jcm.extension_phase_model(lmat, links.astype(np.int32), n_shards=n, wide=wide,
                                     hw=_jax_hw())
    got = comm_model.extension_phase_model(
        lmat, links, n_shards=n, hw=_port_hw(), link_record_bytes=16 if wide else 12,
        pred_record_bytes=8, request_bytes=4, response_bytes=24 if wide else 12,
        final_response_bytes=4)
    assert got == want


# ---------------------------------------------------------------------------
# tests/test_comm_model.py's assertions, on the port's routers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route_by", ["mmer", "key"])
def test_count_matrix_matches_sharded_count(batch, route_by):
    """Column sums == the records each shard received in the padded
    ``sharded_count``; row sums == each shard's valid windows."""
    codes, lengths = batch
    n = 8
    mat = comm_model.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=n,
                                           route_by=route_by)
    mesh = mesh_lib.make_mesh(n, devices=["cpu"])
    sc = shard_count.sharded_count(codes, lengths, np.arange(codes.shape[0]), k=K, m=M,
                                   parity=False, cutoff=1, mesh=mesh, route_by=route_by)
    assert mesh.total(sc.overflow) == 0
    received = np.array([int(v.sum()) for v in sc.valid])
    np.testing.assert_array_equal(mat.sum(axis=0), received)
    windows = np.clip(lengths.astype(np.int64) - K + 1, 0, None).reshape(n, -1).sum(axis=1)
    np.testing.assert_array_equal(mat.sum(axis=1), windows)
    recs = minimizer.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=K, m=M)
    np.testing.assert_array_equal(windows, recs.valid.reshape(n, -1).sum(dim=1).numpy())


def test_links_matrix_row_sums(kept):
    """Every valid node sends exactly 4 boundary records from its home shard."""
    _, _, _, kmer, valid_t = kept
    n = 8
    mat = comm_model.links_exchange_matrix(kmer, valid_t, k=K, n_shards=n)
    per_shard = valid_t.reshape(n, -1).sum(dim=1).numpy()
    np.testing.assert_array_equal(mat.sum(axis=1), 4 * per_shard)
    assert mat.sum() == 4 * int(valid_t.sum())


def test_phase_model_bounds():
    n = 8
    mat = np.random.default_rng(0).integers(100, 1000, size=(n, n)).astype(np.int64)
    kw = dict(bytes_per_record=comm_model.COUNT_RECORD_BYTES, records_per_s=5e8, hw=_port_hw())
    out = comm_model.phase_model(mat, **kw)
    assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0 + 1e-9
    assert out["records_total"] == int(mat.sum())
    assert 0.0 <= out["offchip_fraction"] <= 1.0
    solo = comm_model.phase_model(mat[:1, :1], **kw)
    assert solo["t_comm_s"] == 0.0
    assert solo["eff_overlap"] == pytest.approx(1.0)
    assert solo["eff_serial"] == pytest.approx(1.0)


def test_two_level_split_counts(batch):
    codes, lengths = batch
    n, n_slices = 8, 2
    mat = comm_model.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=n)
    out = comm_model.two_level_split(mat, n_slices=n_slices)
    n_ici = n // n_slices
    src = np.arange(n)
    assert out["dcn_records"] == sum(int(mat[i, j]) for i in src for j in src
                                     if i // n_ici != j // n_ici)
    assert out["ici_records"] == sum(int(mat[i, j]) for i in src for j in src
                                     if i % n_ici != j % n_ici)
    assert out["dcn_messages_flat"] == n_ici * out["dcn_messages_two_level"]


def test_pipeline_model_band():
    n = 16
    mat = np.random.default_rng(3).integers(1000, 2000, (n, n)).astype(np.int64)
    kw = dict(bytes_per_record=comm_model.COUNT_RECORD_BYTES, records_per_s=5e8, hw=_port_hw())
    base = comm_model.phase_model(mat, **kw)
    p1 = comm_model.pipeline_model(mat, n_batches=1, **kw)
    assert abs(p1["eff_pipelined"] - base["eff_serial"]) < 1e-12
    prev = 0.0
    for b in (1, 2, 4, 16, 64, 1024):
        pb = comm_model.pipeline_model(mat, n_batches=b, **kw)
        assert pb["eff_pipelined"] >= prev - 1e-12
        prev = pb["eff_pipelined"]
    assert abs(prev - base["eff_overlap"]) < 0.05 * base["eff_overlap"]


def test_two_level_phase_model_consistency(batch):
    codes, lengths = batch
    n, n_slices = 8, 2
    hw = _port_hw()
    mat = comm_model.count_exchange_matrix(codes, lengths, k=K, m=M, n_shards=n)
    kw = dict(n_slices=n_slices, bytes_per_record=comm_model.COUNT_RECORD_BYTES,
              records_per_s=5e8, hw=hw)
    out = comm_model.two_level_phase_model(mat, **kw)
    assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0
    assert out["eff_serial"] <= out["eff_pipelined"] <= out["eff_overlap"]
    uni = np.full((n, n), 1000, dtype=np.int64)
    u = comm_model.two_level_phase_model(uni, n_slices=n_slices, bytes_per_record=1,
                                         records_per_s=1e9, hw=hw)
    usplit = comm_model.two_level_split(uni, n_slices=n_slices)
    assert abs(u["t_dcn_s"] - (usplit["dcn_records"] / n) / hw.network_bytes_per_s) < 1e-12
    assert abs(u["t_ici_s"] - (usplit["ici_records"] / n) / hw.link_bytes_per_s) < 1e-12
    b8 = comm_model.two_level_phase_model(mat, n_batches=8, **kw)
    assert b8["eff_pipelined"] >= out["eff_serial"] - 1e-12


def test_jump_matrices_pin_routing_caps():
    """The model's peak per-(src, dst) request count is exactly the jump's
    overflow threshold: a capacity equal to it runs clean, one below
    overflows."""
    n_shards = 8
    mesh = mesh_lib.make_mesh(n_shards, devices=["cpu"])
    next_state = _jump_test_graph()
    rows2 = next_state.shape[0] // n_shards
    pred_mat, round_mats, final_mat = comm_model.jump_request_matrices(
        next_state, n_shards=n_shards)
    R = max(int(m.max()) for m in [pred_mat, final_mat] + round_mats)
    assert R >= 2, "test graph too sparse to distinguish capacities"
    shards = mesh.shard_rows(torch.from_numpy(next_state))
    _, ovf_ok = part_dbg.partitioned_pointer_jump(shards, mesh=mesh,
                                                  slack=R * n_shards / rows2)
    assert mesh.total(ovf_ok) == 0
    _, ovf_low = part_dbg.partitioned_pointer_jump(shards, mesh=mesh,
                                                   slack=(R - 1) * n_shards / rows2)
    assert mesh.total(ovf_low) > 0


def test_extension_phase_model_bounds(kept, links):
    _, _, _, kmer, valid_t = kept
    n = 8
    lmat = comm_model.links_exchange_matrix(kmer, valid_t, k=K, n_shards=n)
    port = comm_model.extension_phase_model(lmat, links, n_shards=n, hw=_port_hw())
    wider = comm_model.extension_phase_model(lmat, links, n_shards=n, hw=_port_hw(),
                                             response_bytes=48)
    for out in (port, wider):
        assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0 + 1e-9
        assert out["t_serial_s"] >= out["t_overlap_s"] > 0
    assert wider["t_serial_s"] >= port["t_serial_s"]
    assert wider["requests_total"] == port["requests_total"]
    assert port["jump_rounds"] == part_dbg.jump_rounds(links.shape[0])


def test_parked_links_model_pins_the_link_build_pass_structure(kept, monkeypatch):
    """The model's plan (G, passes, chunks a sweep, partitions) is exactly
    what build_unitig_links_parked performs, read from its on_event
    stream; its group budget is patched small to force passes."""
    _, _, _, kmer, valid_t = kept
    want = dbg.build_unitig_links_join(kmer, valid_t, k=K)
    partitions, chunk_nodes = 5, 1 << 10
    monkeypatch.setattr(dbg, "LINK_GROUP_BUDGET_BYTES", 64 << 10)
    events = []
    got = dbg.build_unitig_links_parked(
        kmer.numpy(), valid_t.numpy(), k=K, partitions=partitions, chunk_nodes=chunk_nodes,
        park_links=True, on_event=lambda kind, **kw: events.append((kind, kw)), device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    model = comm_model.parked_links_model(int(kmer.shape[0]), partitions=partitions,
                                          chunk_nodes=chunk_nodes)
    passes = [kw for kind, kw in events if kind == "link_pass"]
    parts = [kw for kind, kw in events if kind == "link_partition"]
    assert model["n_passes"] > 1
    assert len(passes) == model["n_passes"]
    assert all(p["chunks"] == model["n_chunks"] for p in passes)
    assert all(p["cap_bp"] == model["cap_bp"] for p in passes)
    assert len(parts) == partitions and all(p["n_edges"] >= 0 for p in parts)
    assert model["t_total_s"] > 0
    slower = comm_model.parked_links_model(
        int(kmer.shape[0]), partitions=partitions, chunk_nodes=chunk_nodes,
        link=comm_model.HostLink()._replace(readback_bytes_per_s=1e6, upload_bytes_per_s=1e6))
    assert slower["t_total_s"] > model["t_total_s"]
    scattered = comm_model.parked_links_model(int(kmer.shape[0]), partitions=partitions,
                                              chunk_nodes=chunk_nodes, park_links=False)
    assert scattered["n_passes"] == model["n_passes"]


def test_bench_scaling_model_rows_and_serial_timing():
    """The tool's rows and keys (JAX's tool's), the two link bandwidths
    required, and --time's serial wall with no overlap gain."""
    from genome_assembly_tpu_torch.tools import bench_scaling_model

    with pytest.raises(SystemExit):
        bench_scaling_model.main(["--reads", "512"], emit=lambda e: None)
    lines = bench_scaling_model.main(
        ["--link-bytes-per-s", "450e9", "--network-bytes-per-s", "50e9", "--reads", "512",
         "--shards", "3", "8", "16", "--extension", "--time", "--cpu"], emit=lambda e: None)
    assert lines[0] == {"shards": 3, "skipped": "indivisible"}
    rows, timed = lines[1:3], lines[3:]
    assert [r["shards"] for r in rows] == [8, 16]
    for r in rows:
        assert set(r) == {"shards", "route_by", "count", "links", "extension", "extension_wide",
                          "extension_two_level", "count_2slice", "count_two_level_phase"}
        assert r["extension_wide"] == r["extension"]
        assert 0 < r["count"]["eff_serial"] <= r["count"]["eff_overlap"] <= 1.0 + 1e-9
    assert timed[0]["timed_shards"] == 1 and timed[0]["wall_s"] > 0
    assert timed[1]["serial"] > 0 and "overlap_gain" not in timed[1]
