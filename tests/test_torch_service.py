"""PyTorch port, the async graph-query service (DESIGN.md §15/§16).

One seeded request stream of every algo goes through the reference's
``repro.service.GraphQueryService`` (P = 8 on the ``mesh8`` fixture) and
the port's (``device="cpu"``, the partition carried across with
``partition.from_reference``): each answer equal (``bfs``/``closeness``,
``sssp``, ``cc``/``tri``/``kcore`` exactly, ``bc`` within 1e-4, PageRank
within ``PR_SLACK``), and one ``apply_updates`` batch gives equal
``InvalidationStats`` and equal answers after it.  Then the reference's
own service cases, run against the port on the CPU: mixed-algo
correctness against host oracles, wave coalescing and duplicate-root
folding, epoch-keyed cache hits and invalidation (asserted by the engine's
wave counter), swaps, cancellation, deadline shedding, linger dispatch,
admission control, stop, validation and the telemetry schema.  Kronecker
scale 10 (``seed=1``, ``max_weight=16``), as the reference's file.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import bfs
from repro_torch.graph import generators, partition
from repro_torch.service import (
    ALGOS,
    AdmissionError,
    DeadlineExceeded,
    GraphQueryService,
    GraphVersion,
    ServiceStopped,
)
from repro_torch.service.cache import ResultCache, result_key
from repro_torch.service.telemetry import Telemetry, percentiles
from repro_torch.traversal import bc as bc_mod
from repro_torch.traversal import sssp as sssp_mod

INF32 = np.iinfo(np.int32).max
LANES = 8
RESULT_S = 120.0  # generous future timeout: programs are built on first touch
PR_TOL = 1e-5
PR_SLACK = 2 * PR_TOL * 0.85 / 0.15  # the PageRank programs' tolerance


def _norm(d):
    return np.where(np.asarray(d) >= INF32, -1, np.asarray(d))


@pytest.fixture(scope="module")
def graph():
    return generators.kronecker(10, 8, seed=1, max_weight=16)


@pytest.fixture(scope="module")
def pgraph(graph):
    return partition.partition_1d(graph, 8)


def _service(pgraph, graph, **kw):
    kw.setdefault("lanes", LANES)
    kw.setdefault("n_real", graph.n_real)
    kw.setdefault("max_linger_s", 0.01)
    return GraphQueryService(pgraph, "cpu", bfs.BFSConfig(fanout=4), **kw)


def _component_roots(graph, count):
    from repro_torch.graph import csr

    return csr.largest_component_roots(
        graph, count, np.random.default_rng(0)
    )


# --- parity with the reference service -------------------------------------


def _pair(mesh8, graph, **kw):
    """The reference's service and the port's on the same partition."""
    from repro.core import bfs as ref_bfs
    from repro.graph import partition as ref_part
    from repro.service import GraphQueryService as RefService

    rpg = ref_part.partition_1d(graph, 8)
    tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                   rpg.arrays())
    kw = dict(lanes=LANES, n_real=graph.n_real, max_linger_s=0.01, **kw)
    want = RefService(rpg, mesh8, ref_bfs.BFSConfig(axes=("data",), fanout=4), **kw)
    got = GraphQueryService(tpg, "cpu", bfs.BFSConfig(fanout=4), **kw)
    return want, got


def _stream(graph, rng, n=40):
    """A seeded stream of every algo, repeats included (``closeness`` on
    roots whose BFS row is asked too, a hot root)."""
    roots = [int(r) for r in _component_roots(graph, 12)]
    out = [("bfs", r) for r in roots[:8]] + [("closeness", r) for r in roots[4:10]]
    out += [("sssp", roots[0]), ("sssp", roots[9]), ("bc", roots[1])]
    out += [(a, 0) for a in ("pagerank", "cc", "tri", "kcore")]
    out += [(str(rng.choice(["bfs", "closeness", "sssp"])), int(rng.choice(roots)))
            for _ in range(n - len(out))]
    return out


def _same_answer(algo, got, want):
    if algo == "bc":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    elif algo == "pagerank":
        np.testing.assert_allclose(got, want, atol=PR_SLACK, rtol=0)
    elif algo == "closeness":
        assert got == pytest.approx(want, rel=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def _serve(svc, stream):
    futs = [svc.submit(algo, root) for algo, root in stream]
    return [f.result(RESULT_S) for f in futs]


def test_stream_and_mutation_match_the_reference(mesh8, graph, monkeypatch):
    from repro.dynamic import versioning as ref_versioning
    from repro_torch.dynamic import delta, versioning

    stats = {}
    for side, mod in (("ref", ref_versioning), ("port", versioning)):
        def capture(*a, _mod=mod, _side=side, _real=mod.migrate_cache, **kw):
            stats[_side] = _real(*a, **kw)
            return stats[_side]
        monkeypatch.setattr(mod, "migrate_cache", capture)
    stream = _stream(graph, np.random.default_rng(1))
    want, got = _pair(mesh8, graph, start=False)
    try:
        # the whole burst queued before the schedulers start: both drain it
        # at once, so the waves form alike
        futs = {side: [svc.submit(a, r) for a, r in stream]
                for side, svc in (("got", got), ("want", want))}
        got.start()
        want.start()
        for (algo, _), g, w in zip(stream, futs["got"], futs["want"]):
            _same_answer(algo, g.result(RESULT_S), w.result(RESULT_S))
        assert got.engine.stats.waves == want.engine.stats.waves
        snap_g, snap_w = got.snapshot(), want.snapshot()
        for key in ("submitted", "completed", "coalesced_roots", "dispatches"):
            assert snap_g[key] == snap_w[key], key
        assert snap_g["cache"]["hits"] == snap_w["cache"]["hits"]

        rb = want.overlay.sample_batch(np.random.default_rng(2), 6, 2, max_weight=16)
        batch = delta.EdgeBatch(insert_src=rb.insert_src, insert_dst=rb.insert_dst,
                                insert_weights=rb.insert_weights,
                                delete_src=rb.delete_src, delete_dst=rb.delete_dst)
        assert str(got.apply_updates(batch)) == str(want.apply_updates(rb))
        assert dataclasses.asdict(stats["port"]) == dataclasses.asdict(stats["ref"])
        assert stats["port"].repaired > 0 and stats["port"].rows_before > 0
        after = [(a, r) for a, r in stream if a != "bc"]
        for (algo, root), g, w in zip(after, _serve(got, after), _serve(want, after)):
            _same_answer(algo, g, w)
        assert got.snapshot()["mutations"] == want.snapshot()["mutations"]
    finally:
        got.stop()
        want.stop()


# --- request lifecycle ------------------------------------------------------


def test_mixed_algo_stream_matches_oracles(pgraph, graph):
    """One service, all four algos in flight together, each checked against
    its host oracle."""
    r1, r2, r3, r4 = (int(r) for r in _component_roots(graph, 4))
    svc = _service(pgraph, graph)
    try:
        futs = {
            "bfs": svc.submit("bfs", r1),
            "closeness": svc.submit("closeness", r2),
            "sssp": svc.submit("sssp", r3),
            "bc": svc.submit("bc", r4),
        }
        np.testing.assert_array_equal(
            _norm(futs["bfs"].result(RESULT_S)),
            _norm(bfs.bfs_reference(graph, r1)),
        )
        from repro_torch.analytics import measures

        ref_row = bfs.bfs_reference(graph, r2)[None, :]
        assert futs["closeness"].result(RESULT_S) == pytest.approx(
            float(measures.closeness_centrality(ref_row, n=graph.n_real)[0])
        )
        np.testing.assert_array_equal(
            futs["sssp"].result(RESULT_S), sssp_mod.sssp_reference(graph, r3)
        )
        np.testing.assert_allclose(
            futs["bc"].result(RESULT_S)[: graph.n_real],
            bc_mod.bc_reference(graph, [r4])[: graph.n_real],
            rtol=1e-5, atol=1e-6,  # engine sigma accumulates in float32
        )
    finally:
        svc.stop()


def test_wave_coalescing_folds_duplicates(pgraph, graph):
    """A queued burst with duplicate roots dispatches ceil(unique/lanes)
    waves; every future resolves positionally."""
    uniq = _component_roots(graph, LANES + 3)  # 11 distinct roots
    roots = np.concatenate([uniq, uniq[:5]])  # 16 requests, 11 distinct
    svc = _service(pgraph, graph, start=False, cache_capacity=0)
    try:
        w0 = svc.engine.stats.waves
        futs = [svc.submit("bfs", int(r)) for r in roots]
        svc.start()  # scheduler drains the whole burst at once
        results = [f.result(RESULT_S) for f in futs]
        assert svc.engine.stats.waves - w0 == 2  # ceil(11 / 8)
        for r, d in zip(roots, results):
            np.testing.assert_array_equal(
                _norm(d), _norm(bfs.bfs_reference(graph, int(r)))
            )
        snap = svc.snapshot()
        assert snap["coalesced_roots"] == 5  # the duplicate riders
        assert snap["completed"] == len(roots)
    finally:
        svc.stop()


# --- cache + epoch contract -------------------------------------------------


def test_same_epoch_repeat_hits_cache_and_skips_dispatch(pgraph, graph):
    root = int(_component_roots(graph, 1)[0])
    svc = _service(pgraph, graph)
    try:
        first = svc.query("bfs", root, timeout=RESULT_S)
        waves = svc.engine.stats.waves
        again = svc.query("bfs", root, timeout=RESULT_S)
        assert svc.engine.stats.waves == waves  # no engine dispatch
        np.testing.assert_array_equal(first, again)
        snap = svc.snapshot()
        assert snap["cache"]["hits"] >= 1
        # closeness for the same root derives from the cached BFS row —
        # still no wave
        svc.query("closeness", root, timeout=RESULT_S)
        assert svc.engine.stats.waves == waves
    finally:
        svc.stop()


def test_epoch_bump_after_graph_swap_misses_and_serves_new_graph():
    """The no-stale-results contract: after swap_graph the same root MUST
    recompute (cache miss) and the answer must match the NEW graph."""
    g1 = generators.path_graph(96)
    g2 = generators.torus_2d(10)  # 100 vertices, very different levels
    pg1 = partition.partition_1d(g1, 8)
    pg2 = partition.partition_1d(g2, 8)
    svc = GraphQueryService(
        pg1, "cpu", bfs.BFSConfig(), lanes=4,
        n_real=g1.n_real, max_linger_s=0.005,
    )
    try:
        root = 3
        d1 = svc.query("bfs", root, timeout=RESULT_S)
        np.testing.assert_array_equal(_norm(d1), _norm(bfs.bfs_reference(g1, root)))
        assert len(svc.cache) > 0

        epoch = svc.swap_graph(pg2, n_real=g2.n_real)
        assert epoch == GraphVersion(1, 0)
        assert len(svc.cache) == 0  # stale entries freed eagerly

        waves = svc.engine.stats.waves
        d2 = svc.query("bfs", root, timeout=RESULT_S)
        assert svc.engine.stats.waves > waves  # recomputed, not cached
        np.testing.assert_array_equal(_norm(d2), _norm(bfs.bfs_reference(g2, root)))
        assert not np.array_equal(_norm(d1)[: g2.n_real], _norm(d2)[: g2.n_real])

        # same epoch again -> hit
        waves = svc.engine.stats.waves
        svc.query("bfs", root, timeout=RESULT_S)
        assert svc.engine.stats.waves == waves

        # bump_epoch without a swap also invalidates
        svc.bump_epoch()
        svc.query("bfs", root, timeout=RESULT_S)
        assert svc.engine.stats.waves > waves
        assert svc.snapshot()["epoch_bumps"] == 2
    finally:
        svc.stop()


def test_cancelled_future_never_kills_the_scheduler(pgraph, graph):
    """A caller's cancel() must cost nothing: the cancelled lane is
    skipped, wave-mates are served, and the scheduler thread survives to
    serve later requests."""
    roots = _component_roots(graph, 3)
    svc = _service(pgraph, graph, start=False, cache_capacity=0)
    try:
        f0 = svc.submit("bfs", int(roots[0]))
        f1 = svc.submit("bfs", int(roots[1]))
        assert f0.cancel()
        svc.start()
        np.testing.assert_array_equal(
            _norm(f1.result(RESULT_S)),
            _norm(bfs.bfs_reference(graph, int(roots[1]))),
        )
        # scheduler still alive and serving
        d = svc.query("bfs", int(roots[2]), timeout=RESULT_S)
        np.testing.assert_array_equal(
            _norm(d), _norm(bfs.bfs_reference(graph, int(roots[2])))
        )
        assert svc.scheduler.running
    finally:
        svc.stop()


def test_swap_to_smaller_graph_fails_only_out_of_range_requests():
    """A swap can shrink n underneath pending requests; only the roots that
    no longer exist may fail — wave-mates with valid roots must be served
    (on the NEW graph)."""
    g_big = generators.torus_2d(10)  # n_real=100
    g_small = generators.path_graph(64)
    svc = GraphQueryService(
        partition.partition_1d(g_big, 8), "cpu",
        bfs.BFSConfig(), lanes=4, n_real=g_big.n_real,
        start=False, cache_capacity=0,
    )
    try:
        f_gone = svc.submit("bfs", 90)  # valid now, gone after the swap
        f_ok = svc.submit("bfs", 3)
        svc.swap_graph(partition.partition_1d(g_small, 8),
                       n_real=g_small.n_real)
        svc.start()
        np.testing.assert_array_equal(
            _norm(f_ok.result(RESULT_S)),
            _norm(bfs.bfs_reference(g_small, 3)),
        )
        with pytest.raises(ValueError, match="after graph swap"):
            f_gone.result(RESULT_S)
        assert svc.snapshot()["failed"] == 1
    finally:
        svc.stop()


# --- deadlines, linger, admission ------------------------------------------


def test_expired_deadline_is_shed_without_a_wave(pgraph, graph):
    root = int(_component_roots(graph, 1)[0])
    svc = _service(pgraph, graph, start=False, cache_capacity=0)
    try:
        fut = svc.submit("bfs", root, deadline_s=0.01)
        time.sleep(0.08)  # deadline passes while the scheduler is down
        w0 = svc.engine.stats.waves
        svc.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(RESULT_S)
        assert svc.engine.stats.waves == w0  # no lane burned
        assert svc.snapshot()["expired"] == 1
    finally:
        svc.stop()


def test_linger_dispatches_partial_wave(pgraph, graph):
    """A lone request must not wait for a full wave: the linger timer
    dispatches a partial one."""
    root = int(_component_roots(graph, 1)[0])
    svc = _service(pgraph, graph, max_linger_s=0.02, cache_capacity=0)
    try:
        d = svc.query("bfs", root, timeout=RESULT_S)
        np.testing.assert_array_equal(_norm(d), _norm(bfs.bfs_reference(graph, root)))
        snap = svc.snapshot()
        assert snap["dispatches"] == 1
        assert 0 < snap["wave_occupancy"] <= 1.0 / LANES + 1e-9
    finally:
        svc.stop()


def test_admission_control_bounds_queue_depth(pgraph, graph):
    roots = _component_roots(graph, 5)
    svc = _service(pgraph, graph, start=False, max_pending=4)
    try:
        futs = [svc.submit("bfs", int(r)) for r in roots[:4]]
        with pytest.raises(AdmissionError) as full:
            svc.submit("bfs", int(roots[4]))
        # structured rejection: the §17 router keys failover/shed policy off
        # these fields, so they are contract, not decoration
        assert full.value.occupancy == 4 and full.value.quota == 4
        assert full.value.retryable is True  # backpressure: retry later
        with pytest.raises(AdmissionError) as dead:  # unmeetable deadline
            svc.submit("bfs", int(roots[0]), deadline_s=-0.5)
        assert dead.value.retryable is False  # resubmitting is futile
        assert dead.value.quota == 4
        snap = svc.snapshot()
        assert snap["rejected"] == 2 and snap["pending"] == 4
    finally:
        svc.stop()  # never started: pending futures must fail, not hang
    for f in futs:
        with pytest.raises(ServiceStopped):
            f.result(1.0)
    with pytest.raises(ServiceStopped):
        svc.submit("bfs", int(roots[0]))


def test_stopped_scheduler_fails_pending_futures_promptly(
    pgraph, graph
):
    """Timeout-audit regression (§17): a scheduler that exits — crash-style
    ``stop(join=False)``, no drain — must fail every pending future within
    a bounded wait, and the service must refuse new work instead of
    queueing it forever."""
    roots = _component_roots(graph, 3)
    svc = _service(pgraph, graph, max_linger_s=5.0)  # park requests
    try:
        futs = [svc.submit("bfs", int(r)) for r in roots]
    finally:
        svc.stop(join=False)  # abandon the thread mid-linger, like a kill
    for f in futs:
        with pytest.raises(ServiceStopped):
            f.result(10.0)  # bounded: must NOT hang to the linger timer
    deadline = time.monotonic() + 10.0
    while not svc.scheduler.dead and time.monotonic() < deadline:
        time.sleep(0.01)
    assert svc.scheduler.dead
    with pytest.raises(ServiceStopped):
        svc.submit("bfs", int(roots[0]))


def test_submit_validation(pgraph, graph):
    svc = _service(pgraph, graph, start=False)
    try:
        with pytest.raises(ValueError, match="unknown algo"):
            svc.submit("eigentrust", 0)  # pagerank et al are servable now
        with pytest.raises(ValueError, match="out of range"):
            svc.submit("bfs", -1)
        with pytest.raises(ValueError, match="out of range"):
            svc.submit("bfs", pgraph.n)
        g_unweighted = generators.path_graph(96)
        svc_u = GraphQueryService(
            partition.partition_1d(g_unweighted, 8), "cpu",
            bfs.BFSConfig(), lanes=4, start=False,
        )
        try:
            with pytest.raises(ValueError, match="weighted"):
                svc_u.submit("sssp", 0)
        finally:
            svc_u.stop()
    finally:
        svc.stop()


# --- telemetry --------------------------------------------------------------


def test_snapshot_is_json_serializable(pgraph, graph):
    svc = _service(pgraph, graph)
    try:
        svc.query("bfs", int(_component_roots(graph, 1)[0]), timeout=RESULT_S)
        snap = svc.snapshot()
        roundtrip = json.loads(json.dumps(snap))
        for key in ("submitted", "completed", "qps", "latency_ms",
                    "wave_occupancy", "cache", "epoch", "pending"):
            assert key in roundtrip
        assert {"p50", "p95", "p99", "mean", "count"} <= set(
            roundtrip["latency_ms"]
        )
    finally:
        svc.stop()


def test_percentiles_interpolation():
    vals = list(range(1, 101))  # 1..100
    p = percentiles(vals)
    assert p["p50"] == pytest.approx(50.5)
    assert p["p95"] == pytest.approx(95.05)
    assert p["p99"] == pytest.approx(99.01)
    assert percentiles([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0}


def test_telemetry_counters_thread_safe():
    tele = Telemetry()
    def hammer():
        for _ in range(500):
            tele.record_submit()
            tele.record_completed(0.001, True)
    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = tele.snapshot()
    assert snap["submitted"] == snap["completed"] == 2000


# --- result cache unit tests ------------------------------------------------


def test_result_cache_lru_eviction_order():
    c = ResultCache(capacity=3)
    for i in range(3):
        c.put(result_key(0, "bfs", "cfg", i), i)
    c.get(result_key(0, "bfs", "cfg", 0))  # refresh 0: now LRU order 1,2,0
    c.put(result_key(0, "bfs", "cfg", 3), 3)  # evicts 1
    assert c.peek(result_key(0, "bfs", "cfg", 0))
    assert not c.peek(result_key(0, "bfs", "cfg", 1))
    assert c.evictions == 1 and len(c) == 3


def test_result_cache_epoch_keying_and_drop_stale():
    c = ResultCache(capacity=8)
    c.put(result_key(0, "bfs", "cfg", 7), "old")
    hit, _ = c.get(result_key(1, "bfs", "cfg", 7))  # new epoch: structural miss
    assert not hit
    assert c.drop_stale(1) == 1 and len(c) == 0


def test_result_cache_disabled_when_capacity_zero():
    c = ResultCache(capacity=0)
    c.put(result_key(0, "bfs", "cfg", 1), "x")
    hit, _ = c.get(result_key(0, "bfs", "cfg", 1))
    assert not hit and len(c) == 0
    with pytest.raises(ValueError):
        ResultCache(capacity=-1)


# --- launch stats-json ------------------------------------------------------


def test_bfs_run_stats_json_schema(tmp_path):
    from repro_torch.launch import bfs_run

    out = tmp_path / "stats.json"
    assert bfs_run.main([
        "--scale", "8", "--ranks", "2", "--device", "cpu", "--roots", "3",
        "--num-sources", "4", "--stats-json", str(out),
    ]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == bfs_run.STATS_SCHEMA
    assert doc["algo"] == "bfs" and doc["devices"] == 2
    for key in ("graph", "config", "timing_ms", "engine_stats"):
        assert key in doc
    assert doc["graph"]["name"] == "kronecker" and doc["graph"]["scale"] == 8
    stats = doc["engine_stats"]
    for key in ("queries", "waves", "deduped_roots", "scanned_edges",
                "max_levels", "sssp_queries", "relaxed_edges", "bc_sources"):
        assert key in stats
    assert stats["queries"] == 3 and stats["waves"] >= 1


def test_recorded_update_stream_replays_in_both_packages(tmp_path, capsys):
    """``serve_graph --record-updates`` writes the reference's JSONL stream:
    the reference's ``bfs_run --updates`` and the port's replay it to the
    same counts and edge total."""
    import re

    from repro.launch import bfs_run as ref_cli
    from repro_torch.launch import bfs_run, serve_graph

    path = str(tmp_path / "u.jsonl")
    assert serve_graph.main(["--scale", "8", "--ranks", "2", "--device", "cpu",
                             "--lanes", "4", "--qps", "40", "--duration", "0.5",
                             "--mutate-rate", "8", "--mutate-edges", "6",
                             "--record-updates", path]) == 0
    capsys.readouterr()

    def replayed(out):
        line = next(x for x in out.splitlines() if x.startswith("replayed updates:"))
        return tuple(int(v.replace(",", "")) for v in re.findall(r"\d[\d,]*", line))

    assert ref_cli.main(["--scale", "8", "--devices", "2", "--roots", "2",
                         "--updates", path]) == 0
    want = replayed(capsys.readouterr().out)
    assert bfs_run.main(["--scale", "8", "--ranks", "2", "--roots", "2", "--device", "cpu",
                         "--updates", path]) == 0
    got = replayed(capsys.readouterr().out)
    assert got == want and want[0] > 0


def test_a_stopped_service_is_freed_with_its_engine(pgraph, graph):
    """The metrics registry outlives every service, and its pull gauges
    hold the service weakly: once stopped and dropped, the service and its
    engine (whose placed arrays are gigabytes on the card) are freed, and
    the gauges read 0."""
    import gc
    import weakref

    from repro_torch.core import metrics

    svc = _service(pgraph, graph)
    try:
        svc.query("bfs", int(_component_roots(graph, 1)[0]), timeout=RESULT_S)
        name, engine = svc.telemetry.name, weakref.ref(svc.engine)
    finally:
        svc.stop()
    del svc
    gc.collect()
    assert engine() is None
    depth = metrics.default_registry().gauge("service_queue_depth", "", ("service",))
    assert depth.value(service=name) == 0
