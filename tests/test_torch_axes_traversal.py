"""The port's weighted traversals, vertex programs, waves, engine and
repair over a hierarchical mesh: on ``SimMesh((2, 4), ("pod", "data"))``
with ``axes=("pod", "data")``, SSSP and CC equal the JAX package's runs on
``mesh24`` exactly and PageRank (delta mode) within the reference's
``PR_SLACK``; an MS-BFS wave, a BC wave, triangles, k-core, the batched
engine (with its profile) and row repair equal the port's one-axis runs;
every traced run's bytes equal the byte model over the axes' sizes."""

import jax
import numpy as np
import pytest
import torch

from repro import programs as ref_programs
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.traversal import sssp as ref_sssp
from repro_torch import programs
from repro_torch.analytics import msbfs
from repro_torch.analytics.engine import BFSQueryEngine
from repro_torch.core import bfs, collectives, flightrec
from repro_torch.dist.sharding import SimMesh
from repro_torch.dynamic import delta, repair
from repro_torch.graph import generators, partition
from repro_torch.traversal import bc, sssp

MESH24 = SimMesh((2, 4), ("pod", "data"))
AXES = ("pod", "data")
PR_TOL = 1e-5
PR_SLACK = 2 * PR_TOL * 0.85 / 0.15
INF32 = np.iinfo(np.int32).max


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(rpg):
    return partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                    rpg.arrays())


@pytest.fixture(scope="module")
def weighted():
    g = ref_gen.kronecker(9, 8, seed=1, max_weight=64)
    rpg = ref_part.partition_1d(g, 8)
    root = int(ref_csr.largest_component_root(g, np.random.default_rng(0)))
    return g, rpg, _port(rpg), root


@pytest.fixture(scope="module")
def kron():
    g = generators.kronecker(9, 8, seed=2)
    pg = partition.partition_1d(g, 8)
    return g, pg


@pytest.mark.parametrize("sync,fanout", [("adaptive", 2), ("adaptive", 4), ("sparse", 2),
                                         ("xla", 2), ("butterfly", 4)])
def test_sssp_over_pod_data_matches_reference(mesh24, weighted, sync, fanout):
    g, rpg, tpg, root = weighted
    want = ref_sssp.distributed_sssp(rpg, mesh24, root, ref_sssp.SSSPConfig(
        axes=AXES, sync=sync, fanout=fanout))
    cfg = sssp.SSSPConfig(axes=AXES, sync=sync, fanout=fanout)
    got = sssp.distributed_sssp(tpg, root, cfg, device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(want[1:])
    np.testing.assert_array_equal(got[0], sssp.sssp_reference(g, root))
    # traced: the bytes are the model's over the axes' sizes, every rank
    comm = collectives.Communicator(MESH24, "cpu")
    out = sssp.build_sssp_fn(tpg, cfg, device="cpu", trace=True, mesh=MESH24)(
        bfs.place_arrays(tpg, device="cpu"), root, comm)
    n_rows = sssp.dist_rows(tpg)
    trace = flightrec.TraversalTrace.from_buffer(
        out[3], algo="sssp", sync=sync, p=8, fanout=fanout, n_words=n_rows,
        capacity=cfg.resolved_capacity(n_rows), density_threshold=cfg.density_threshold,
        axis_sizes=(2, 4))
    assert flightrec.reconcile_bytes(trace, comm.bytes_sent)["matches"]


@pytest.mark.parametrize("sync", ["sparse", "adaptive"])
@pytest.mark.parametrize("algo", ["pagerank", "cc"])
def test_programs_over_pod_data_match_reference(mesh24, algo, sync):
    """PageRank: the ADD monoid in delta mode (``ref=None``); CC: the MIN
    monoid remerged against the last sync's labels."""
    rg = ref_gen.kronecker(8, 8, seed=3)
    rpg = ref_part.partition_1d(rg, 8)
    want = ref_programs.run_program(rpg, mesh24, ref_programs.by_name(algo),
                                    ref_programs.ProgramConfig(axes=AXES, sync=sync,
                                                               tol=PR_TOL))
    got = programs.run_program(_port(rpg), programs.by_name(algo),
                               programs.ProgramConfig(axes=AXES, sync=sync, tol=PR_TOL),
                               device="cpu", mesh=MESH24)
    if algo == "pagerank":
        np.testing.assert_allclose(got[0], want[0], atol=PR_SLACK, rtol=0)
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0][: rg.n], ref_programs.cc_reference(rg))
        assert got[1:] == tuple(want[1:])


@pytest.mark.parametrize("algo", ["tri", "kcore"])
def test_exact_programs_over_axes_equal_one_axis(kron, algo):
    """Triangles (its wedge sum over every rank) and k-core."""
    _, pg = kron
    one = programs.run_program(pg, programs.by_name(algo),
                               programs.ProgramConfig(sync="adaptive"), device="cpu")
    got = programs.run_program(pg, programs.by_name(algo),
                               programs.ProgramConfig(axes=AXES, sync="adaptive"),
                               device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(got[0], one[0])
    assert got[1:] == one[1:]


def test_msbfs_wave_over_axes_equals_one_axis(kron):
    _, pg = kron
    roots = np.asarray([0, 5, 77, -1, 5, 300, 11, 2])
    one = msbfs.multi_source_bfs(pg, roots, bfs.BFSConfig(sync="adaptive", fanout=4),
                                 device="cpu")
    cfg = bfs.BFSConfig(axes=AXES, sync="adaptive", fanout=4)
    got = msbfs.multi_source_bfs(pg, roots, cfg, device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(got[0], one[0])
    assert got[1:] == one[1:]
    comm = collectives.Communicator(MESH24, "cpu")
    out = msbfs.build_msbfs_fn(pg, cfg, 8, device="cpu", trace=True, mesh=MESH24)(
        bfs.place_arrays(pg, device="cpu"), roots, comm)
    n_words = msbfs.wave_rows(pg) * msbfs.lane_words(8)
    trace = flightrec.TraversalTrace.from_buffer(
        out[3], algo="msbfs", sync="adaptive", p=8, fanout=4, n_words=n_words,
        capacity=cfg.resolved_capacity(n_words), axis_sizes=(2, 4))
    assert flightrec.reconcile_bytes(trace, comm.bytes_sent)["matches"]


@pytest.mark.parametrize("sync", ["butterfly", "rabenseifner"])
def test_bc_wave_over_axes_equals_one_axis(kron, sync):
    """Lane levels exact; the dependency sums within the reference's BC
    tolerance (the float32 ADD syncs run their rounds in another order)."""
    _, pg = kron
    sources = [0, 5, 77, 300]
    arrays = bfs.place_arrays(pg, device="cpu")
    runs = []
    for cfg, mesh in ((bfs.BFSConfig(sync=sync), None),
                      (bfs.BFSConfig(axes=AXES, sync=sync), MESH24)):
        lanes = {}
        out = bc.build_bc_fn(pg, cfg, 4, device="cpu", mesh=mesh)(
            arrays, np.asarray(sources), lanes=lanes)
        runs.append((out, lanes))
    (o1, l1), (o2, l2) = runs
    assert torch.equal(l1["levels"], l2["levels"]) and o1[1:] == o2[1:]
    np.testing.assert_allclose(o2[0].numpy(), o1[0].numpy(), rtol=1e-4, atol=1e-4)


def test_engine_over_axes_equals_one_axis(kron, weighted):
    _, pg = kron
    roots = [0, 5, 77, 300, 5, 11]
    one = BFSQueryEngine(pg, bfs.BFSConfig(sync="adaptive", fanout=4), lanes=4, device="cpu")
    eng = BFSQueryEngine(pg, bfs.BFSConfig(axes=AXES, sync="adaptive", fanout=4), lanes=4,
                         device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(eng.query(roots), one.query(roots))
    np.testing.assert_array_equal(eng.vertex_program("cc"), one.vertex_program("cc"))
    assert eng.stats == one.stats
    _, _, tpg, root = weighted
    wone = BFSQueryEngine(tpg, bfs.BFSConfig(sync="sparse"), lanes=4, device="cpu")
    weng = BFSQueryEngine(tpg, bfs.BFSConfig(axes=AXES, sync="sparse"), lanes=4,
                          device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(weng.sssp([root, 3]), wone.sssp([root, 3]))
    # the profile: the program and every cached program of this mesh reconcile
    prof = eng.profile(0, iters=1)
    assert prof["program"].reconciled
    assert all(e.reconciled for e in prof["cache"] if e.supported)
    assert any(e.supported for e in prof["cache"])


def test_repair_over_axes_equals_one_axis():
    g = generators.kronecker(9, 8, seed=2)
    ov = delta.DeltaOverlay(g)
    upd = ov.apply(ov.sample_batch(np.random.default_rng(1), 20, 10))
    pg = partition.partition_1d(g, 8)
    assert delta.apply_update_to_partition(pg, upd)
    roots = [0, 5, 77, 300]
    rows = [bfs.bfs_reference(g, r) for r in roots]
    one_cfg = sssp.SSSPConfig(sync="adaptive")
    cfg = sssp.SSSPConfig(axes=AXES, sync="adaptive")
    one = repair.repair_row(pg, rows[0], upd, one_cfg, unit_weight=True, device="cpu")
    got = repair.repair_row(pg, rows[0], upd, cfg, unit_weight=True, device="cpu",
                            mesh=MESH24)
    np.testing.assert_array_equal(got[0], one[0])
    assert got[1:] == one[1:]
    gm = ov.current_graph()
    np.testing.assert_array_equal(got[0], bfs.bfs_reference(gm, roots[0]))
    many = repair.repair_rows(pg, rows, upd, cfg, unit_weight=True, device="cpu",
                              mesh=MESH24)
    for r, o, w in zip(roots, many, repair.repair_rows(pg, rows, upd, one_cfg,
                                                      unit_weight=True, device="cpu")):
        np.testing.assert_array_equal(o[0], w[0])
        assert o[1:] == w[1:]
        np.testing.assert_array_equal(o[0], bfs.bfs_reference(gm, r))


@pytest.mark.parametrize("build", [
    lambda pg, cfg, mesh: sssp.build_sssp_fn(pg, sssp.SSSPConfig(axes=cfg), device="cpu",
                                             mesh=mesh),
    lambda pg, cfg, mesh: programs.build_program_fn(
        pg, programs.by_name("cc"), programs.ProgramConfig(axes=cfg), device="cpu",
        mesh=mesh),
    lambda pg, cfg, mesh: msbfs.build_msbfs_fn(pg, bfs.BFSConfig(axes=cfg), 4,
                                               device="cpu", mesh=mesh),
    lambda pg, cfg, mesh: bc.build_bc_fn(pg, bfs.BFSConfig(axes=cfg), 4, device="cpu",
                                         mesh=mesh),
    lambda pg, cfg, mesh: BFSQueryEngine(pg, bfs.BFSConfig(axes=cfg), device="cpu",
                                         mesh=mesh),
    lambda pg, cfg, mesh: repair.build_repair_fn(pg, sssp.SSSPConfig(axes=cfg),
                                                 unit_weight=True, device="cpu", mesh=mesh),
])
def test_config_guard_every_builder(weighted, build):
    _, _, tpg, _ = weighted
    with pytest.raises(ValueError):
        build(tpg, ("pod", "data"), None)  # the default mesh has no pod axis
    with pytest.raises(ValueError):
        build(tpg, ("data",), MESH24)  # 4 ranks for 8 partitions
    build(tpg, AXES, MESH24)
