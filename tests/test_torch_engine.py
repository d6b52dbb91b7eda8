"""PyTorch port, the batched query engine and its measures: ``query``,
``sssp``, ``betweenness`` (within 1e-4) and the vertex programs
(PageRank within ``PR_SLACK``) equal the JAX package's ``BFSQueryEngine``
with ``EngineStats`` equal field by field; the program cache's LRU and
identity rules; ``refresh_arrays`` after an in-place patch; the measures;
the CLI's ``--updates`` replay and engine-driven waves against the
reference's CLI; the per-device lock.  Kronecker scale 9-10 and torus
20 x 20 at P = 8, as ``tests/test_analytics.py``."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from repro import programs as ref_programs
from repro.analytics import engine as ref_engine
from repro.analytics import measures as ref_measures
from repro.core import bfs as ref_bfs
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.traversal import sssp as ref_sssp
from repro_torch import programs
from repro_torch.analytics import engine, measures
from repro_torch.core import bfs, devlock
from repro_torch.dynamic import delta
from repro_torch.graph import generators, partition
from repro_torch.traversal import sssp

INF32 = np.iinfo(np.int32).max
PR_TOL = 1e-5
PR_SLACK = 2 * PR_TOL * 0.85 / 0.15
GRAPHS = {
    "kron10": lambda: ref_gen.kronecker(10, 8, seed=1),
    "torus": lambda: ref_gen.torus_2d(20),
    "kron9w": lambda: ref_gen.kronecker(9, 8, seed=3, max_weight=8),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_parts = {}


def _graph(name):
    """``(g, reference partition, port partition)`` of a family at P = 8."""
    if name not in _parts:
        g = GRAPHS[name]()
        rpg = ref_part.partition_1d(g, 8)
        tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                       rpg.arrays())
        _parts[name] = (g, rpg, tpg)
    return _parts[name]


def _roots(g, b, seed=0):
    return np.random.default_rng(seed).integers(0, g.n_real, size=b).astype(np.int32)


def _engines(mesh, name, lanes=8, **kw):
    g, rpg, tpg = _graph(name)
    want = ref_engine.BFSQueryEngine(rpg, mesh, ref_bfs.BFSConfig(axes=("data",), fanout=4,
                                                                  **kw), lanes=lanes)
    got = engine.BFSQueryEngine(tpg, bfs.BFSConfig(fanout=4, **kw), lanes=lanes,
                                device="cpu")
    return g, want, got


def _same_stats(got, want):
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


# --- query -------------------------------------------------------------------


@pytest.mark.parametrize("name,sync,mode", [
    ("kron10", "butterfly", "top_down"),
    ("kron10", "adaptive", "direction_optimizing"),
    ("torus", "sparse", "top_down"),
    ("torus", "rabenseifner", "bottom_up"),
])
def test_query_matches_reference(mesh8, name, sync, mode):
    """20 roots in 8-lane waves: distances and ``EngineStats`` (waves,
    scanned edges as float32 sums, levels) equal the reference's."""
    g, want, got = _engines(mesh8, name, sync=sync, mode=mode)
    roots = _roots(g, 20, seed=3)
    dist = got.query(roots)
    np.testing.assert_array_equal(dist, want.query(roots))
    _same_stats(got, want)
    assert got.stats.waves == 3 and dist.shape == (20, got.pg.n)
    np.testing.assert_array_equal(got.query_one(int(roots[0])), dist[0])


def test_query_dedupes_duplicate_roots_as_reference(mesh8):
    """``query(r + r) == query(r)`` twice over in ONE 4-lane wave, and the
    interleaved duplicates resolve by position; stats equal the
    reference's."""
    g, want, got = _engines(mesh8, "kron10", lanes=4)
    r = _roots(g, 3, seed=5).tolist()
    doubled = got.query(r + r)
    np.testing.assert_array_equal(doubled, want.query(r + r))
    assert got.stats.waves == 1 and got.stats.deduped_roots == 3
    base = got.query(r)
    np.testing.assert_array_equal(doubled, np.concatenate([base, base]))
    mixed = got.query([r[1], r[0], r[1], r[2], r[0]])
    np.testing.assert_array_equal(mixed, base[[1, 0, 1, 2, 0]])
    want.query(r)
    want.query([r[1], r[0], r[1], r[2], r[0]])
    _same_stats(got, want)


# --- weighted traversals and vertex programs ---------------------------------


@pytest.mark.parametrize("sync", ["butterfly", "sparse", "adaptive"])
def test_sssp_matches_reference(mesh8, sync):
    g, want, got = _engines(mesh8, "kron9w", sync=sync)
    roots = _roots(g, 3, seed=2)
    np.testing.assert_array_equal(got.sssp(roots), want.sssp(roots))
    np.testing.assert_array_equal(got.sssp(roots[:1])[0],
                                  ref_sssp.sssp_reference(g, int(roots[0])))
    want.sssp(roots[:1])
    _same_stats(got, want)


def test_betweenness_matches_reference(mesh8):
    """Sources in 4-lane Brandes waves (two waves, the second padded):
    scores within 1e-4 of the reference's, the stats equal."""
    g, want, got = _engines(mesh8, "kron9w", lanes=4)
    sources = _roots(g, 6, seed=4)
    np.testing.assert_allclose(got.betweenness(sources), want.betweenness(sources),
                               rtol=1e-4, atol=1e-4)
    _same_stats(got, want)
    assert got.stats.bc_sources == 6 and got.stats.waves == 2


@pytest.mark.parametrize("algo", ["pagerank", "cc", "tri", "kcore"])
def test_vertex_programs_match_reference(mesh8, algo):
    """Each program through ``run_program``: the result (PageRank within
    ``PR_SLACK``), rounds and edges examined equal the reference's, and a
    warm start from the result converges at once."""
    g, want, got = _engines(mesh8, "kron10", sync="adaptive")
    rcfg = ref_programs.ProgramConfig(axes=("data",), fanout=4, sync="adaptive", tol=PR_TOL)
    cfg = programs.ProgramConfig(fanout=4, sync="adaptive", tol=PR_TOL)
    res, iters, work = got.run_program(algo, cfg)
    wres, witers, wwork = want.run_program(algo, rcfg)
    if algo == "pagerank":
        np.testing.assert_allclose(res, wres, atol=PR_SLACK, rtol=0)
        warm, it2, _ = got.run_program(algo, cfg, arg=programs.rank_arg(got.pg, res,
                                                                        device="cpu"))
        assert it2 < iters
        np.testing.assert_allclose(warm, res, atol=PR_SLACK, rtol=0)
    else:
        np.testing.assert_array_equal(res, wres)
        np.testing.assert_array_equal(got.vertex_program(algo, cfg), res)
    assert (iters, work) == (witers, wwork)


def test_default_program_and_sssp_configs_lift_the_engine_sync(mesh8):
    g, want, got = _engines(mesh8, "kron9w", sync="sparse")
    np.testing.assert_array_equal(got.vertex_program("cc"), want.vertex_program("cc"))
    assert got._sssp_cfg(None) == sssp.SSSPConfig(fanout=4, sync="sparse")
    assert got._program_cfg(None) == programs.ProgramConfig(fanout=4, sync="sparse")


def test_refusals_match_reference(mesh8):
    """Input refusals, and a sync with no SSSP or program counterpart
    refused rather than coerced, as the reference's engine."""
    g, want, got = _engines(mesh8, "kron9w", sync="rabenseifner")
    for eng in (got, want):
        with pytest.raises(ValueError, match="no SSSP equivalent"):
            eng.sssp([0])
        with pytest.raises(ValueError, match="no vertex-program equivalent"):
            eng.vertex_program("cc")
        with pytest.raises(ValueError):
            eng.query([-1])
        with pytest.raises(ValueError):
            eng.query([])
        with pytest.raises(ValueError):
            eng.query([eng.pg.n])
        with pytest.raises(ValueError):
            eng.betweenness([[0, 1]])
    got.sssp([0], sssp.SSSPConfig(fanout=4))  # an explicit config is taken
    with pytest.raises(ValueError):
        engine.BFSQueryEngine(got.pg, bfs.BFSConfig(), lanes=0, device="cpu")
    with pytest.raises(NotImplementedError):
        engine.BFSQueryEngine(got.pg, bfs.BFSConfig(use_kernels=True), device="cpu")
    with pytest.raises(ValueError, match="unknown vertex program"):
        got.vertex_program("sideways", programs.ProgramConfig())


# --- the program cache -------------------------------------------------------


def test_program_cache_lru_bound_and_strong_refs(monkeypatch):
    """The module-wide program cache is a bounded LRU (hits refresh
    recency), every resident entry keeps a STRONG reference to its graph,
    and an id-recycled key with a different graph rebuilds."""
    import gc
    import weakref
    from collections import OrderedDict

    monkeypatch.setattr(engine, "_PROGRAM_CACHE", OrderedDict())
    monkeypatch.setattr(engine, "_PROGRAM_CACHE_MAX", 4)

    class Obj:
        pass

    dev = torch.device("cpu")
    refs = []
    for i in range(10):
        pg = Obj()
        refs.append(weakref.ref(pg))
        fn = engine._cached(pg, dev, (id(pg), dev, "bfs", i), lambda i=i: f"prog{i}")
        assert fn == f"prog{i}"
        del pg
    gc.collect()
    assert len(engine._PROGRAM_CACHE) == 4
    assert sum(1 for r in refs if r() is not None) == 4
    keys = list(engine._PROGRAM_CACHE)
    coldest = engine._PROGRAM_CACHE[keys[0]]
    hit = engine._cached(coldest[1], coldest[2], keys[0], lambda: "MUST NOT REBUILD")
    assert hit == coldest[0]
    engine._cached(Obj(), dev, ("fresh",), lambda: "fresh")
    assert keys[0] in engine._PROGRAM_CACHE
    assert keys[1] not in engine._PROGRAM_CACHE
    impostor = Obj()
    assert engine._cached(impostor, dev, keys[0], lambda: "rebuilt") == "rebuilt"
    # the same graph on another device is another program
    other = engine._PROGRAM_CACHE[keys[0]][1]
    assert engine._cached(other, torch.device("meta"), keys[0],
                          lambda: "other device") == "other device"


def test_program_cache_reuse_and_counters():
    """Engines on the same ``(pg, device, cfg, lanes)`` share one program
    (a cache hit, no build); another lane count is another program."""
    _, _, tpg = _graph("kron10")
    cfg = bfs.BFSConfig(fanout=4, sync="sparse")
    a = engine.BFSQueryEngine(tpg, cfg, lanes=4, device="cpu")
    builds = engine._BUILDS.value(algo="bfs")
    hits = engine._CACHE_EVENTS.value(event="hit")
    b = engine.BFSQueryEngine(tpg, cfg, lanes=4, device="cpu")
    assert a._fn is b._fn
    assert engine._BUILDS.value(algo="bfs") == builds
    assert engine._CACHE_EVENTS.value(event="hit") == hits + 1
    c = engine.BFSQueryEngine(tpg, cfg, lanes=8, device="cpu")
    assert c._fn is not a._fn and engine._BUILDS.value(algo="bfs") == builds + 1
    waves = engine._WAVES.value(algo="bfs")
    a.query([1, 2])
    assert engine._WAVES.value(algo="bfs") == waves + 1
    text = engine._REG.expose_text()
    assert "engine_program_cache_total" in text and "engine_deduped_roots_total" in text


def test_refresh_arrays_after_in_place_patch(mesh8):
    """An engine placed before an in-place patch answers for the mutated
    graph once refreshed (the same program, no rebuild), as the
    reference's."""
    g = ref_gen.kronecker(9, 8, seed=2)
    rpg = ref_part.partition_1d(g, 8)
    tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                   rpg.arrays())
    want = ref_engine.BFSQueryEngine(rpg, mesh8, ref_bfs.BFSConfig(axes=("data",)), lanes=4)
    got = engine.BFSQueryEngine(tpg, bfs.BFSConfig(), lanes=4, device="cpu")
    roots = [int(r) for r in ref_csr.largest_component_roots(g, 4, np.random.default_rng(0))]
    before = got.query(roots)
    ov = delta.DeltaOverlay(generators.kronecker(9, 8, seed=2))
    upd = ov.apply(ov.sample_batch(np.random.default_rng(1), 20, 10))
    assert delta.apply_update_to_partition(tpg, upd)
    from repro.dynamic import delta as ref_delta

    rov = ref_delta.DeltaOverlay(g)
    assert ref_delta.apply_update_to_partition(
        rpg, rov.apply(rov.sample_batch(np.random.default_rng(1), 20, 10)))
    fn = got._fn
    got.refresh_arrays()
    want.refresh_arrays()
    after = got.query(roots)
    assert got._fn is fn
    np.testing.assert_array_equal(after, want.query(roots))
    gm = rov.current_graph()
    for r, row in zip(roots, after):
        np.testing.assert_array_equal(row, ref_bfs.bfs_reference(gm, r))
    assert not np.array_equal(after, before)


# --- measures -----------------------------------------------------------------


def test_reachability_and_closeness_match_reference(mesh8):
    g, want, got = _engines(mesh8, "torus")
    roots = _roots(g, 5, seed=1)
    dist = got.query(roots)
    np.testing.assert_array_equal(measures.reachability_counts(dist),
                                  ref_measures.reachability_counts(dist))
    for kw in (dict(n=g.n_real), dict(), dict(n=g.n_real, wf_improved=False)):
        np.testing.assert_array_equal(measures.closeness_centrality(dist, **kw),
                                      ref_measures.closeness_centrality(dist, **kw))
    path = ref_gen.path_graph(100)
    pdist = np.stack([ref_bfs.bfs_reference(path, r) for r in (0, 50, 120)])
    np.testing.assert_array_equal(measures.closeness_centrality(pdist, n=100),
                                  ref_measures.closeness_centrality(pdist, n=100))
    assert measures.closeness_centrality(pdist, n=100)[2] == 0.0


@pytest.mark.parametrize("lanes", [16, 32])
def test_connected_components_match_reference(mesh8, lanes):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 300, size=250), rng.integers(0, 300, size=250)
    g = ref_csr.from_edges(src, dst, 300)
    rpg = ref_part.partition_1d(g, 8)
    tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                   rpg.arrays())
    want = ref_measures.connected_components(rpg, mesh8, ref_bfs.BFSConfig(axes=("data",)),
                                             lanes=lanes)
    got = measures.connected_components(tpg, bfs.BFSConfig(), lanes=lanes, device="cpu")
    np.testing.assert_array_equal(got, want)
    eng = engine.BFSQueryEngine(tpg, bfs.BFSConfig(), lanes=lanes, device="cpu")
    np.testing.assert_array_equal(measures.connected_components(tpg, engine=eng), want)


# --- CLI ------------------------------------------------------------------------


def _replayed(out):
    line = next(x for x in out.splitlines() if x.startswith("replayed updates:"))
    return tuple(int(n.replace(",", "")) for n in re.findall(r"\d[\d,]*", line))


@pytest.mark.parametrize("weighted", [False, True])
def test_cli_updates_replay_matches_reference(tmp_path, capsys, weighted):
    """``--updates`` replays the same stream through both CLIs: the same
    insert, delete, compaction and edge counts (an unweighted stream onto
    a weighted graph takes unit weights; the second batch overflows a
    rank's slack and compacts)."""
    from repro.dynamic import delta as ref_delta
    from repro.launch import bfs_run as ref_cli
    from repro_torch.launch import bfs_run

    g = ref_gen.kronecker(8, 8, seed=0)
    ov = ref_delta.DeltaOverlay(g)
    rng = np.random.default_rng(3)
    batches = [ov.sample_batch(rng, 6, 4), ov.sample_batch(rng, 400, 2)]
    path = str(tmp_path / "u.jsonl")
    ref_delta.write_update_stream(path, batches)
    extra = ["--algo", "sssp", "--max-weight", "8"] if weighted else []
    assert ref_cli.main(["--scale", "8", "--devices", "2", "--roots", "2",
                         "--updates", path] + extra) == 0
    want = _replayed(capsys.readouterr().out)
    assert bfs_run.main(["--scale", "8", "--ranks", "2", "--roots", "2", "--device", "cpu",
                         "--updates", path] + extra) == 0
    got = _replayed(capsys.readouterr().out)
    assert got == want and want[2] >= 1 and want[1] > 0


@pytest.mark.parametrize("args", [["--num-sources", "4"],
                                  ["--algo", "bc", "--num-sources", "2"],
                                  ["--algo", "cc", "--sync", "adaptive"]])
def test_cli_engine_paths_write_the_engines_stats(tmp_path, capsys, args):
    """``--num-sources 4`` waves, BC and a program run through the engine:
    ``engine_stats`` is the engine's, equal to the reference CLI's."""
    from repro.launch import bfs_run as ref_cli
    from repro_torch.launch import bfs_run

    rpath, tpath = tmp_path / "r.json", tmp_path / "t.json"
    common = ["--scale", "8", "--roots", "6"] + args
    assert ref_cli.main(common + ["--devices", "2", "--stats-json", str(rpath)]) == 0
    assert bfs_run.main(common + ["--ranks", "2", "--device", "cpu",
                                  "--stats-json", str(tpath)]) == 0
    got = json.loads(tpath.read_text())["engine_stats"]
    want = json.loads(rpath.read_text())["engine_stats"]
    assert got is not None and got == want
    assert "GEdge/s" in capsys.readouterr().out or got["waves"] > 0


def test_cli_refuses_kernels_with_waves():
    from repro_torch.launch import bfs_run

    with pytest.raises(SystemExit):
        bfs_run.main(["--scale", "6", "--ranks", "2", "--device", "cpu", "--kernels",
                      "--num-sources", "4"])


# --- the device lock ----------------------------------------------------------


def test_device_lock_is_shared_per_device():
    cpu = devlock.device_lock("cpu")
    assert devlock.device_lock(torch.device("cpu")) is cpu
    assert devlock.device_lock("cpu:0") is cpu
    assert devlock.device_lock("meta") is not cpu
    with cpu:
        with devlock.device_lock("cpu"):  # re-entrant
            pass
