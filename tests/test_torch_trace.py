"""PyTorch port, the flight recorder: per-level rows (BRANCH and SHIPPED
included) equal the JAX package's ``traced_bfs`` rows for every sync, the
recorder never perturbs the traversal, an untraced run computes no sync
statistics, the byte attribution reconciles exactly with the
Communicator's count, and the Chrome document follows the repo's schema."""

import json
import os

import numpy as np
import pytest
import torch

from repro.analytics import msbfs as ref_msbfs
from repro.core import bfs as ref_bfs
from repro.core import flightrec as ref_fl
from repro.core.tracing import validate_schema
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.analytics import msbfs
from repro_torch.core import bfs, collectives, flightrec
from repro_torch.core.flightrec import (
    BRANCH_DENSE,
    BRANCH_FALLBACK,
    COL_BRANCH,
    COL_LEVEL,
    COL_POP,
    COL_SHIPPED,
    COL_WORDS,
)
from repro_torch.graph import partition
from repro_torch.launch import bfs_run

INF32 = np.iinfo(np.int32).max
SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")
GRAPHS = {
    "kron10": lambda gen: gen.kronecker(10, 8, seed=1),
    "torus": lambda gen: gen.torus_2d(20),
    "path": lambda gen: gen.path_graph(200),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def partitions():
    out = {}
    for name, make in GRAPHS.items():
        rpg = ref_part.partition_1d(make(ref_gen), 8)
        out[name] = (rpg, partition.from_reference(
            {k: getattr(rpg, k) for k in partition.SCALARS}, rpg.arrays()))
    return out


def _schema():
    with open(SCHEMA_PATH) as f:
        return json.load(f)


def _check_invariants(trace, dist, levels):
    """The self-consistency contract of a single-source BFS trace."""
    data = trace.data
    assert trace.levels == levels
    assert data[:, COL_LEVEL].tolist() == list(range(1, levels + 1))
    assert int(data[:, COL_POP].sum()) == int(np.sum(dist < INF32)) - 1
    assert (data[:-1, COL_POP] > 0).all()
    assert ((data[:, COL_WORDS] >= 0) & (data[:, COL_WORDS] <= trace.n_words)).all()
    dense = data[:, COL_BRANCH] == BRANCH_DENSE
    assert (data[dense, COL_SHIPPED] == 0).all()
    assert (data[:, COL_SHIPPED] <= trace.capacity).all()
    assert (trace.level_bytes_per_node() > 0).all()
    if trace.sync in ("butterfly", "rabenseifner", "all_to_all", "xla"):
        assert dense.all()


@pytest.mark.parametrize("sync", bfs.SYNCS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_trace_rows_match_reference(mesh8, partitions, name, sync):
    rpg, tpg = partitions[name]
    rcfg = ref_bfs.BFSConfig(axes=("data",), sync=sync, fanout=4, sparse_capacity=8)
    want = ref_fl.traced_bfs(rpg, mesh8, 3, rcfg)
    cfg = bfs.BFSConfig(sync=sync, fanout=4, sparse_capacity=8)
    comm = collectives.Communicator(8, "cpu")
    got = flightrec.traced_bfs(tpg, 3, cfg, comm=comm, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    np.testing.assert_array_equal(got[3].data, want[3].data)
    plain = bfs.distributed_bfs(tpg, 3, cfg, device="cpu")  # the recorder never perturbs
    np.testing.assert_array_equal(plain[0], got[0])
    assert plain[1:] == got[1:3]
    _check_invariants(got[3], got[0], got[1])
    rec = flightrec.reconcile_bytes(got[3], comm.bytes_sent)
    assert rec["matches"], rec
    if sync in ("sparse", "adaptive"):
        assert (got[3].data[:, COL_BRANCH] != BRANCH_DENSE).any()


def test_overflow_guard_shows_as_fallback(partitions):
    """The sparse sync's overflow guard is the only way to the dense path,
    and the trace shows each such level as BRANCH_FALLBACK."""
    _, tpg = partitions["kron10"]
    cfg = bfs.BFSConfig(sync="sparse", fanout=4, sparse_capacity=1)
    comm = collectives.Communicator(8, "cpu")
    _, _, _, trace = flightrec.traced_bfs(tpg, 3, cfg, comm=comm, device="cpu")
    branch = trace.data[:, COL_BRANCH]
    assert (branch == BRANCH_FALLBACK).any() and set(branch) <= {1, 2}
    assert trace.summary()["fallback_levels"] == int((branch == BRANCH_FALLBACK).sum())
    assert flightrec.reconcile_bytes(trace, comm.bytes_sent)["matches"]


@pytest.mark.parametrize("sync", ["butterfly", "adaptive"])
def test_trace_false_computes_no_sync_stats(partitions, monkeypatch, sync):
    _, tpg = partitions["torus"]
    calls = []
    real = flightrec.or_sync_stats
    monkeypatch.setattr(flightrec, "or_sync_stats",
                        lambda *a: calls.append(1) or real(*a))
    cfg = bfs.BFSConfig(sync=sync, fanout=4)
    _, levels, _ = bfs.distributed_bfs(tpg, 3, cfg, device="cpu")
    assert calls == []
    flightrec.traced_bfs(tpg, 3, cfg, device="cpu")
    assert len(calls) == levels


def test_trace_levels_drop_not_wrap(mesh8, partitions):
    rpg, tpg = partitions["path"]
    rcfg = ref_bfs.BFSConfig(axes=("data",), sync="adaptive", fanout=4)
    want = ref_fl.traced_bfs(rpg, mesh8, 3, rcfg, trace_levels=5)[3]
    got = flightrec.traced_bfs(tpg, 3, bfs.BFSConfig(sync="adaptive", fanout=4),
                               trace_levels=5, device="cpu")[3]
    assert got.levels == 5
    np.testing.assert_array_equal(got.data, want.data)
    assert flightrec.resolve_trace_levels(None, 10_000) == flightrec.DEFAULT_TRACE_LEVELS
    with pytest.raises(ValueError):
        flightrec.resolve_trace_levels(0, 10)


def test_timed_bfs_levels_exact_and_timed(partitions):
    _, tpg = partitions["kron10"]
    cfg = bfs.BFSConfig(sync="adaptive", fanout=4)
    d_ref, lv_ref, _ = bfs.distributed_bfs(tpg, 3, cfg, device="cpu")
    dist, trace = flightrec.timed_bfs_levels(tpg, cfg, 3, device="cpu")
    np.testing.assert_array_equal(d_ref, dist)
    assert trace.levels == lv_ref
    assert trace.wall_ms.size == trace.levels and (trace.wall_ms > 0).all()
    assert trace.summary()["wall_ms_total"] == pytest.approx(float(trace.wall_ms.sum()))
    assert all(row["wall_ms"] > 0 for row in trace.level_table())
    doc = flightrec.trace_chrome_doc(trace)
    assert validate_schema(doc, _schema()) == []
    assert len([e for e in doc["traceEvents"] if e.get("ph") == "X"]) == trace.levels
    assert doc["otherData"]["schema"] == flightrec.TRACE_SCHEMA


def test_untimed_trace_renders_as_instants_like_reference(mesh8, partitions):
    rpg, tpg = partitions["torus"]
    want = ref_fl.trace_chrome_doc(ref_fl.traced_bfs(
        rpg, mesh8, 3, ref_bfs.BFSConfig(axes=("data",), fanout=4))[3])
    trace = flightrec.traced_bfs(tpg, 3, bfs.BFSConfig(fanout=4), device="cpu")[3]
    doc = flightrec.trace_chrome_doc(trace)
    assert validate_schema(doc, _schema()) == []
    assert not any(e.get("ph") == "X" for e in doc["traceEvents"])
    assert [(e["ph"], e["name"], e.get("ts")) for e in doc["traceEvents"]] == \
        [(e["ph"], e["name"], e.get("ts")) for e in want["traceEvents"]]
    assert doc["otherData"] == want["otherData"]


def test_trace_to_dict_matches_reference(mesh8, partitions):
    rpg, tpg = partitions["torus"]
    want = ref_fl.traced_bfs(rpg, mesh8, 3, ref_bfs.BFSConfig(
        axes=("data",), sync="adaptive", fanout=4))[3].to_dict()
    doc = json.loads(json.dumps(flightrec.traced_bfs(
        tpg, 3, bfs.BFSConfig(sync="adaptive", fanout=4), device="cpu")[3].to_dict()))
    assert doc == want
    assert doc["dense_levels"] + doc["sparse_levels"] + doc["fallback_levels"] == \
        doc["levels"] == len(doc["per_level"])


def test_msbfs_trace_matches_reference(mesh8, partitions):
    rpg, tpg = partitions["kron10"]
    roots = np.asarray([3, 5, 9, -1], dtype=np.int32)
    rcfg = ref_bfs.BFSConfig(axes=("data",), sync="adaptive", fanout=4)
    want = ref_msbfs.build_msbfs_fn(rpg, mesh8, rcfg, 4, trace=True)(
        ref_bfs.place_arrays(rpg, mesh8, rcfg.axes), roots)
    cfg = bfs.BFSConfig(sync="adaptive", fanout=4)
    arrays = bfs.place_arrays(tpg, device="cpu")
    base = msbfs.build_msbfs_fn(tpg, cfg, 4, device="cpu")(arrays, roots)
    traced = msbfs.build_msbfs_fn(tpg, cfg, 4, device="cpu", trace=True)(arrays, roots)
    assert torch.equal(base[0], traced[0]) and base[1:] == traced[1:3]
    np.testing.assert_array_equal(traced[0].numpy(), np.asarray(want[0]))
    n_words = msbfs.wave_rows(tpg) * msbfs.lane_words(4)
    trace = flightrec.TraversalTrace.from_buffer(
        traced[3], algo="msbfs", sync=cfg.sync, p=tpg.p, fanout=cfg.fanout,
        n_words=n_words, capacity=cfg.resolved_capacity(n_words))
    assert trace.levels == traced[1]
    np.testing.assert_array_equal(trace.data, np.asarray(want[3])[0][:trace.levels])


def test_cli_writes_trace_and_stats_json(tmp_path, capsys):
    trace_path, stats_path = tmp_path / "t.json", tmp_path / "s.json"
    assert bfs_run.main(["--scale", "8", "--ranks", "4", "--roots", "2", "--kernels",
                         "--sync", "sparse", "--sparse-capacity", "4", "--device", "cpu",
                         "--trace", str(trace_path), "--stats-json", str(stats_path)]) == 0
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(trace_path.read_text())
    assert validate_schema(doc, _schema()) == []
    stats = json.loads(stats_path.read_text())
    assert stats["schema"] == "bfs_run_stats/v1"
    es = stats["engine_stats"]
    assert es["queries"] == es["waves"] == 2 and es["scanned_edges"] > 0
    assert stats["config"]["sync"] == "sparse" and stats["config"]["sparse_capacity"] == 4
    assert stats["trace"]["levels"] == len(stats["trace"]["per_level"])


# --- monoid syncs: SSSP and the vertex programs ------------------------------


def _weighted_partitions(p=8):
    from repro.graph import partition as rp

    rg = ref_gen.kronecker(9, 8, seed=1, max_weight=16)
    rpg = rp.partition_1d(rg, p)
    return rpg, partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                         rpg.arrays())


@pytest.mark.parametrize("sync", ["butterfly", "sparse", "adaptive", "xla"])
def test_sssp_trace_rows_match_reference(mesh8, sync):
    """monoid_sync_stats rows (changed-vs-reference distance words, the
    branch and the shipped pairs) and the rest of each row equal the
    reference's traced SSSP; the byte attribution reconciles with what
    the ranks sent."""
    from repro.traversal import sssp as ref_sssp
    from repro_torch.traversal import sssp

    rpg, tpg = _weighted_partitions()
    kw = dict(sync=sync, fanout=4, sparse_capacity=64)
    rfn = ref_sssp.build_sssp_fn(rpg, mesh8, ref_sssp.SSSPConfig(axes=("data",), **kw),
                                 trace=True)
    want = rfn(ref_bfs.place_arrays(rpg, mesh8, ("data",)), np.int32(3))
    cfg = sssp.SSSPConfig(**kw)
    comm = collectives.Communicator(8, "cpu")
    arrays = bfs.place_arrays(tpg, device="cpu")
    got = sssp.build_sssp_fn(tpg, cfg, device="cpu", trace=True)(arrays, 3, comm)
    n_rows = sssp.dist_rows(tpg)
    tr = flightrec.TraversalTrace.from_buffer(got[3], algo="sssp", sync=sync, p=8,
                                              fanout=4, n_words=n_rows,
                                              capacity=cfg.resolved_capacity(n_rows))
    np.testing.assert_array_equal(tr.data, ref_fl.TraversalTrace.from_buffer(
        np.asarray(want[3]), algo="sssp", sync=sync, p=8, fanout=4, n_words=n_rows,
        capacity=cfg.resolved_capacity(n_rows)).data)
    assert tr.levels == got[1] == int(np.max(want[1]))
    assert flightrec.reconcile_bytes(tr, comm.bytes_sent)["matches"]
    if sync in ("sparse", "adaptive"):
        assert (tr.data[:, COL_BRANCH] != BRANCH_DENSE).any()
    untraced = sssp.build_sssp_fn(tpg, cfg, device="cpu")(arrays, 3)
    assert torch.equal(untraced[0], got[0]) and untraced[1:] == got[1:3]


@pytest.mark.parametrize("algo", ["pagerank", "cc", "kcore", "tri"])
@pytest.mark.parametrize("sync", ["butterfly", "sparse", "adaptive"])
def test_program_trace_rows_match_reference(mesh8, algo, sync):
    """A traced program's rows equal the reference's exactly: the monoid
    sync's columns (PageRank's delta mode against the identity) and each
    program's POP/DIR (PageRank's float32 residual in ppm, labels changed,
    vertices peeled and k, wedge hits); the bytes reconcile."""
    from repro import programs as ref_programs
    from repro.graph import partition as rp
    from repro_torch import programs

    rpg = rp.partition_1d(ref_gen.kronecker(8, 8, seed=3), 8)
    tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                   rpg.arrays())
    rprog, prog = ref_programs.by_name(algo), programs.by_name(algo)
    rcfg = ref_programs.ProgramConfig(sync=sync, fanout=4)
    want = ref_programs.build_program_fn(rpg, mesh8, rprog, rcfg, trace=True)(
        ref_bfs.place_arrays(rpg, mesh8, ("data",)), rprog.default_arg(rpg))
    cfg = programs.ProgramConfig(sync=sync, fanout=4)
    comm = collectives.Communicator(8, "cpu")
    got = programs.build_program_fn(tpg, prog, cfg, device="cpu", trace=True)(
        bfs.place_arrays(tpg, device="cpu"), prog.default_arg(tpg, device="cpu"), comm)
    n_words = programs.program_msg_words(tpg, prog)
    kw = dict(algo=algo, sync=sync, p=8, fanout=4, n_words=n_words,
              capacity=cfg.resolved_capacity(n_words))
    tr = flightrec.TraversalTrace.from_buffer(got[-1], **kw)
    ref = ref_fl.TraversalTrace.from_buffer(np.asarray(want[-1]), **kw).data
    assert tr.levels == got[-3] == int(np.max(want[-3]))
    np.testing.assert_array_equal(tr.data, ref)
    assert flightrec.reconcile_bytes(tr, comm.bytes_sent)["matches"]


def test_monoid_and_dense_sync_stats_dispatch():
    """The stats name the branch the sync takes: changed words against the
    capacity (sparse) and the density limit (adaptive)."""
    from types import SimpleNamespace

    prev = torch.full((2, 64), -1, dtype=torch.int32)
    new = prev.clone()
    new[0, :3] = 5
    new[1, :10] = 7
    for sync, want in (("butterfly", (10, 0, 0)), ("sparse", (10, 1, 10)),
                       ("adaptive", (10, 0, 0))):
        cfg = SimpleNamespace(sync=sync, density_threshold=0.1)
        got = flightrec.monoid_sync_stats(new, prev, cfg, capacity=16)
        assert tuple(int(x) for x in got) == want, sync
    cfg = SimpleNamespace(sync="sparse", density_threshold=0.1)
    assert int(flightrec.monoid_sync_stats(new, prev, cfg, capacity=8)[1]) == BRANCH_FALLBACK
    cfg = SimpleNamespace(sync="adaptive", density_threshold=0.5)
    assert int(flightrec.monoid_sync_stats(new, prev[0], cfg, capacity=16)[1]) == 1
    assert [int(x) for x in flightrec.dense_sync_stats(new)] == [64, 0, 0]
    with pytest.raises(ValueError, match="unknown sync"):
        flightrec.monoid_sync_stats(new, prev, SimpleNamespace(sync="carrier"), 16)


def test_bc_trace_reports_its_extra_dense_syncs(partitions):
    """A BC trace covers the forward OR sync; its ADD syncs (two a level)
    are counted in the summary and the trace refuses reconciliation."""
    from repro_torch.traversal import bc

    _, tpg = partitions["kron10"]
    cfg = bfs.BFSConfig(fanout=4)
    out = bc.build_bc_fn(tpg, cfg, 2, device="cpu", trace=True)(
        bfs.place_arrays(tpg, device="cpu"), [3, 5])
    n_flat = msbfs.wave_rows(tpg) * msbfs.lane_words(2)
    tr = flightrec.TraversalTrace.from_buffer(out[-1], algo="bc", sync="butterfly", p=8,
                                              fanout=4, n_words=n_flat,
                                              capacity=cfg.resolved_capacity(n_flat))
    assert tr.levels == out[1] and tr.summary()["extra_dense_syncs"] == 2 * out[1]
    with pytest.raises(ValueError, match="BC"):
        flightrec.reconcile_bytes(tr, np.zeros(8))
