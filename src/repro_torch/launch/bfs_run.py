"""Distributed ButterFly BFS launcher on PyTorch (the paper's workload, end
to end, on one device).

``python -m repro_torch.launch.bfs_run --scale 20 --ranks 16 --fanout 4 --kernels``

Generates a graph, 1D-partitions it over P simulated ranks, and runs BFS
from distinct roots in the largest component with the paper's protocol:
one warm-up run, then one run per root, the fastest and slowest quartiles
trimmed, GTEP/s = edges examined / BFS wall time.  Each run's clock stops
after ``torch.cuda.synchronize()``.

``--num-sources B`` (B > 1) packs the roots into B-lane multi-source
waves through the batched query engine (``analytics.engine``).  ``--algo``
also runs the weighted traversals and the vertex programs: ``sssp``
(weighted shortest paths, ``--delta`` buckets; weights default to
``--max-weight 64``), and through the engine ``bc`` (Brandes betweenness
in waves of ``--num-sources`` lanes) and ``pagerank``, ``cc``, ``tri``,
``kcore`` (each timed over a few repetitions, being root-free).

``--updates FILE`` replays a recorded JSONL edge-update stream (the
reference's ``serve_graph --record-updates`` format) through the delta
overlay and the in-place partition patch before measuring, compacting and
repartitioning where a patch is refused or the overlay asks for it.

``--sync`` picks any of the six frontier syncs (``--sparse-capacity`` and
``--density-threshold`` tune the sparse and adaptive ones).  ``--trace
FILE`` runs the first root once more with the flight recorder on and each
level timed, and writes the Perfetto/Chrome ``trace_event`` document;
``--stats-json PATH`` writes the run's identity and timing as JSON.
``--profile [FILE]`` runs the cost-model profiler
(:mod:`repro_torch.core.profiler`) on the single-source BFS program of the
first root, the kernel path with ``--kernels``: the byte model reconciled
against what the ranks shipped, achieved against modeled GTEP/s and the
per-level time × bytes table; FILE also receives the profile as JSON.
With ``--num-sources`` it is the engine's profile, which adds the
reconciliation of every program the engine cached.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

STATS_SCHEMA = "bfs_run_stats/v1"


def write_stats_json(path, *, algo, graph, devices, config, timing_ms,
                     engine_stats, **extra) -> None:
    """Persist one run's machine-readable stats in the reference's
    ``bfs_run_stats/v1`` schema (``engine_stats`` an ``EngineStats`` or a
    dict)."""
    if dataclasses.is_dataclass(engine_stats):
        engine_stats = dataclasses.asdict(engine_stats)
    doc = {"schema": STATS_SCHEMA, "algo": algo, "graph": graph,
           "devices": devices, "config": config, "timing_ms": timing_ms,
           "engine_stats": engine_stats}
    doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def time_roots(fn, arrays, roots, device):
    """The paper's timing protocol for one BFS function: a warm-up run from
    ``roots[0]``, then one run per root, each clock stopping after the
    device synchronises.  Returns the per-root ``(seconds, levels, scanned,
    d_owned)``, and the trimmed mean ms and GTEP/s over the runs left when
    the fastest and slowest quartiles are dropped (all runs under 8 roots);
    GTEP/s = edges examined / BFS wall time."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(arrays, roots[0])
    sync()
    runs = []
    for r in roots:
        t0 = time.perf_counter()
        d_owned, levels, scanned = fn(arrays, r)
        sync()
        runs.append((time.perf_counter() - t0, levels, scanned, d_owned))
    times = np.array([x[0] for x in runs])
    rates = np.array([x[2] / x[0] / 1e9 for x in runs])
    q = len(runs) // 4 if len(runs) >= 8 else 0
    keep = np.argsort(times)[q : len(runs) - q]
    return runs, float(times[keep].mean() * 1e3), float(rates[keep].mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="kronecker",
                    choices=["kronecker", "urand", "torus"])
    ap.add_argument("--scale", type=int, default=14,
                    help="log2 of the vertex count (torus: side 2^(scale/2))")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=16,
                    help="simulated ranks P (the leading tensor axis)")
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--sync", default="butterfly",
                    choices=["butterfly", "sparse", "adaptive", "rabenseifner",
                             "all_to_all", "xla"])
    ap.add_argument("--sparse-capacity", type=int, default=0,
                    help="first-round (word, idx)-pair capacity of the sparse "
                         "sync; 0 = auto (n_words // 64)")
    ap.add_argument("--density-threshold", type=float, default=0.02,
                    help="adaptive sync: go sparse while max popcount <= "
                         "threshold * bitmap bits")
    ap.add_argument("--mode", default="top_down",
                    choices=["top_down", "bottom_up", "direction_optimizing"])
    ap.add_argument("--algo", default="bfs",
                    choices=["bfs", "sssp", "bc", "pagerank", "cc", "tri", "kcore"],
                    help="traversal (bfs, sssp, bc) or vertex program (pagerank, "
                         "connected components, triangle counting, k-core)")
    ap.add_argument("--max-weight", type=int, default=0,
                    help="uint32 edge weights in [1, max-weight]; 0 = unweighted "
                         "(sssp defaults to 64)")
    ap.add_argument("--delta", type=int, default=0,
                    help="sssp bucket width (delta-stepping-style); 0 = "
                         "level-synchronous relaxation")
    ap.add_argument("--num-sources", type=int, default=1,
                    help="lanes per wave: bfs packs the roots into multi-source "
                         "waves when > 1; bc: sources per Brandes wave")
    ap.add_argument("--roots", type=int, default=16,
                    help="number of distinct roots (bc: sources) to time")
    ap.add_argument("--kernels", action="store_true",
                    help="phase 1 and the butterfly merge via the CUDA kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--updates", default=None, metavar="FILE",
                    help="replay a recorded JSONL edge-update stream through the "
                         "delta overlay and the partition patch before measuring")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write the per-level flight-recorder trace of the "
                         "first root, each level timed, as Perfetto/Chrome "
                         "trace_event JSON")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the run's identity and timing as JSON")
    ap.add_argument("--profile", default=None, metavar="FILE", nargs="?", const="-",
                    help="run the cost-model profiler on the single-source BFS "
                         "program (the kernel path with --kernels): reconcile the "
                         "model's sync bytes against what the ranks shipped, report "
                         "achieved against modeled GTEP/s and the per-level "
                         "time x bytes table; FILE (optional) also receives the "
                         "profile as JSON")
    args = ap.parse_args(argv)
    if args.profile and args.algo != "bfs":
        ap.error("--profile profiles the single-source BFS program; use --algo bfs")

    from repro_torch import programs
    from repro_torch.analytics.engine import EngineStats
    from repro_torch.core import bfs, flightrec
    from repro_torch.graph import csr, generators, partition
    from repro_torch.kernels import blocks
    from repro_torch.traversal import sssp

    # the reference's per-algorithm validation
    if args.algo == "sssp" and args.sync not in sssp.SYNCS:
        ap.error(f"--algo sssp supports --sync {sssp.SYNCS}, got {args.sync!r}")
    if args.algo in programs.PROGRAM_ALGOS and args.sync not in programs.SYNCS:
        ap.error(f"--algo {args.algo} supports --sync {programs.SYNCS}, "
                 f"got {args.sync!r}")
    if args.algo == "bc" and args.mode != "top_down":
        ap.error("--algo bc uses the push traversal; use --mode top_down")
    if args.kernels and (args.algo != "bfs" or args.num_sources > 1):
        ap.error("--kernels drives the single-source BFS; drop it for "
                 f"--algo {args.algo} --num-sources {args.num_sources}")

    dev = bfs.resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    max_weight = args.max_weight or (64 if args.algo == "sssp" else 0)
    if args.graph == "kronecker":
        g = generators.kronecker(args.scale, args.edge_factor, seed=args.seed,
                                 max_weight=max_weight)
    elif args.graph == "urand":
        g = generators.uniform_random(
            1 << args.scale, (1 << args.scale) * args.edge_factor, seed=args.seed,
            max_weight=max_weight)
    else:
        g = generators.torus_2d(1 << (args.scale // 2), max_weight=max_weight,
                                seed=args.seed)
    print(f"graph: {args.graph} n={g.n:,} m={g.n_edges:,} (directed, symmetrized"
          f"{', weighted' if g.weighted else ''})")
    pg = partition.partition_1d(g, args.ranks)
    if args.updates:
        g, pg = replay_updates(args.updates, g, pg, args.ranks)
    graph_doc = {"name": args.graph, "scale": args.scale,
                 "edge_factor": args.edge_factor, "n": g.n, "n_real": g.n_real,
                 "n_edges": g.n_edges, "weighted": bool(g.weighted)}
    if args.algo != "bfs":
        return run_algo(args, g, pg, dev, name, graph_doc, max_weight)
    if args.num_sources > 1:
        return run_waves(args, g, pg, dev, name, graph_doc)
    cfg = bfs.BFSConfig(fanout=args.fanout, sync=args.sync, mode=args.mode,
                        use_kernels=args.kernels, sparse_capacity=args.sparse_capacity,
                        density_threshold=args.density_threshold)
    layout = blocks.build_bfs_layout(pg) if args.kernels else None
    arrays = bfs.place_arrays(pg, layout, device=dev)
    fn = bfs.build_bfs_fn(pg, cfg, layout, device=dev)
    roots = csr.largest_component_roots(
        g, args.roots, np.random.default_rng(args.seed)).tolist()
    runs, ms, gteps = time_roots(fn, arrays, roots, dev)
    print(f"BFS {args.sync} fanout={args.fanout} mode={args.mode} "
          f"ranks={args.ranks} kernels={args.kernels} on {name}: "
          f"{len(roots)} roots, max {max(x[1] for x in runs)} levels, "
          f"time {ms:.3f} ms, GTEP/s {gteps:.4f}")
    trace_doc = None
    if args.trace:
        _, tr = flightrec.timed_bfs_levels(pg, cfg, roots[0], arrays=arrays,
                                           layout=layout, device=dev)
        trace_doc = write_trace(args.trace, tr)
    if args.profile:
        from repro_torch.core import profiler

        emit_profile(args.profile, {"program": profiler.profile_bfs(
            pg, cfg, roots[0], arrays=arrays, layout=layout, device=dev), "cache": []})
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo="bfs", graph=graph_doc, devices=args.ranks,
            config={"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
                    "lanes": 1, "use_kernels": bool(args.kernels),
                    "sparse_capacity": cfg.resolved_capacity(pg.n_words),
                    "density_threshold": args.density_threshold},
            timing_ms={"mean": ms, "total": float(sum(x[0] for x in runs) * 1e3)},
            engine_stats=EngineStats(
                queries=len(roots), waves=len(roots),
                scanned_edges=float(sum(x[2] for x in runs)),
                max_levels=max(x[1] for x in runs)),
            device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


def replay_updates(path, g, pg, ranks):
    """Replay the update stream at ``path`` through the delta overlay and
    the in-place partition patch; where a patch is refused (a rank's slack
    is full) or the overlay asks for compaction, compact and repartition.
    A weighted graph replaying an unweighted stream takes unit weights.
    Returns the current graph and partition."""
    from repro_torch.dynamic import delta
    from repro_torch.graph import partition

    overlay = delta.DeltaOverlay(g)
    n_ins = n_del = n_comp = 0
    for batch in delta.read_update_stream(path):
        if g.weighted and batch.insert_weights is None:
            batch = delta.EdgeBatch(
                insert_src=batch.insert_src, insert_dst=batch.insert_dst,
                insert_weights=np.ones(batch.insert_src.size, np.uint32),
                delete_src=batch.delete_src, delete_dst=batch.delete_dst)
        update = overlay.apply(batch)
        n_ins += update.ins_src.size
        n_del += update.del_src.size
        if (not delta.apply_update_to_partition(pg, update)
                or overlay.needs_compaction()):
            pg = partition.partition_1d(overlay.compact(), ranks)
            n_comp += 1
    g = overlay.current_graph()
    print(f"replayed updates: {n_ins} directed inserts, {n_del} deletes, "
          f"{n_comp} compactions -> m={g.n_edges:,}")
    return g, pg


def run_waves(args, g, pg, dev, name, graph_doc) -> int:
    """``--num-sources B > 1``: the roots packed into B-lane multi-source
    waves through the query engine, after a warm-up wave; the clock stops
    after the last wave's result is on the host."""
    from repro_torch.analytics import msbfs
    from repro_torch.analytics.engine import BFSQueryEngine, EngineStats
    from repro_torch.core import bfs, flightrec
    from repro_torch.graph import csr

    cfg = bfs.BFSConfig(fanout=args.fanout, sync=args.sync, mode=args.mode,
                        sparse_capacity=args.sparse_capacity,
                        density_threshold=args.density_threshold)
    lanes = args.num_sources
    roots = csr.largest_component_roots(
        g, args.roots, np.random.default_rng(args.seed)).tolist()
    eng = BFSQueryEngine(pg, cfg, lanes=lanes, device=dev)
    eng.query(roots[:lanes])  # warm-up
    eng.stats = EngineStats()
    t0 = time.perf_counter()
    eng.query(np.asarray(roots, np.int32))
    dt = time.perf_counter() - t0
    print(f"MS-BFS {args.sync} fanout={args.fanout} mode={args.mode} "
          f"ranks={args.ranks} lanes={lanes} on {name}: {len(roots)} searches in "
          f"{dt * 1e3:.3f} ms over {eng.stats.waves} waves ({len(roots) / dt:.1f} "
          f"searches/s, aggregate GTEP/s {eng.stats.scanned_edges / dt / 1e9:.4f})")
    trace_doc = None
    if args.trace:
        n_flat = msbfs.wave_rows(pg) * msbfs.lane_words(lanes)
        wave = (roots[:lanes] + [-1] * lanes)[:lanes]
        out = msbfs.build_msbfs_fn(pg, cfg, lanes, device=dev, trace=True)(
            eng._arrays, wave)
        trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
            out[-1], algo="msbfs", sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
            n_words=n_flat, capacity=cfg.resolved_capacity(n_flat),
            density_threshold=cfg.density_threshold))
    if args.profile:
        emit_profile(args.profile, eng.profile(roots[0]))
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo="bfs", graph=graph_doc, devices=args.ranks,
            config={"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
                    "lanes": lanes, "use_kernels": False,
                    "density_threshold": args.density_threshold},
            timing_ms={"mean": dt * 1e3 / max(len(roots), 1), "total": dt * 1e3},
            engine_stats=eng.stats, device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


def emit_profile(path: str, report: dict) -> None:
    """Print the profile table (and the cached programs' reconciliation);
    unless ``path`` is ``"-"``, also write the whole report there as JSON."""
    prof = report["program"]
    print()
    print(prof.table())
    for ent in report.get("cache", []):
        verdict = ("reconciled" if ent.reconciled else
                   "MISMATCH" if ent.supported else "unsupported")
        print(f"cached {ent.algo} sync={ent.sync} lanes={ent.lanes} "
              f"n_words={ent.n_words}: {verdict}")
    if path != "-":
        doc = {"schema": "bfs_profile/v1", "program": prof.to_dict(),
               "cache": [e.to_dict() for e in report.get("cache", [])]}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"profile -> {path}")


def write_trace(path, trace) -> dict:
    """Write one trace's Perfetto document, print its summary line and
    return the JSON table (for ``--stats-json``)."""
    from repro_torch.core import flightrec

    with open(path, "w") as f:
        json.dump(flightrec.trace_chrome_doc(trace), f, indent=1)
    t = trace.summary()
    print(f"trace: {t['levels']} levels ({t['dense_levels']} dense / "
          f"{t['sparse_levels']} sparse / {t['fallback_levels']} fallback), "
          f"{t['bytes_per_node_total']:.0f} sync B/rank -> {path}")
    return trace.to_dict()


def run_algo(args, g, pg, dev, name, graph_doc, max_weight) -> int:
    """``--algo sssp|bc|pagerank|cc|tri|kcore``: time SSSP from the same
    distinct largest-component roots as BFS (each clock stopping after the
    device synchronises), BC's waves and the root-free programs (three
    repetitions) through the query engine after a warm-up; print the
    result's summary, and write the trace and stats as for BFS."""
    from repro_torch import programs
    from repro_torch.analytics import msbfs
    from repro_torch.analytics.engine import BFSQueryEngine, EngineStats
    from repro_torch.core import bfs, flightrec
    from repro_torch.graph import csr
    from repro_torch.traversal import bc, sssp

    sync = bfs.device_sync(dev)
    roots = csr.largest_component_roots(
        g, args.roots, np.random.default_rng(args.seed)).tolist()
    config = {"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
              "lanes": args.num_sources, "delta": args.delta,
              "max_weight": max_weight, "use_kernels": False}
    bcfg = bfs.BFSConfig(fanout=args.fanout, sync=args.sync, mode=args.mode,
                         sparse_capacity=args.sparse_capacity,
                         density_threshold=args.density_threshold)

    def timed(fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    trace_doc = None
    if args.algo == "sssp":
        arrays = bfs.place_arrays(pg, device=dev)
        cfg = sssp.SSSPConfig(fanout=args.fanout, sync=args.sync, delta=args.delta,
                              sparse_capacity=args.sparse_capacity,
                              density_threshold=args.density_threshold)
        fn = sssp.build_sssp_fn(pg, cfg, device=dev)
        fn(arrays, roots[0])  # warm-up
        runs = [timed(fn, arrays, r) for r in roots]
        times = np.array([dt for _, dt in runs])
        relaxed = np.array([out[2] for out, _ in runs])
        stats = EngineStats(sssp_queries=len(roots), relaxed_edges=float(relaxed.sum()))
        timing = {"mean": float(times.mean() * 1e3), "total": float(times.sum() * 1e3)}
        print(f"SSSP {cfg.sync} fanout={args.fanout} delta={args.delta} "
              f"ranks={args.ranks} on {name}: {len(roots)} roots, time "
              f"{times.mean() * 1e3:.3f} ms, GRelax/s {np.mean(relaxed / times) / 1e9:.4f}")
        if args.trace:
            n_rows = sssp.dist_rows(pg)
            out = sssp.build_sssp_fn(pg, cfg, device=dev, trace=True)(arrays, roots[0])
            trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
                out[-1], algo="sssp", sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
                n_words=n_rows, capacity=cfg.resolved_capacity(n_rows),
                density_threshold=cfg.density_threshold))
    elif args.algo == "bc":
        lanes = max(args.num_sources, 1)
        eng = BFSQueryEngine(pg, bcfg, lanes=lanes, device=dev)
        eng.betweenness(roots[:lanes])  # warm-up
        scores, dt = timed(eng.betweenness, np.asarray(roots, np.int32))
        stats = eng.stats
        timing = {"mean": dt * 1e3 / max(len(roots), 1), "total": dt * 1e3}
        top = np.argsort(scores)[::-1][:5]
        print(f"BC {args.sync} fanout={args.fanout} ranks={args.ranks} lanes={lanes} "
              f"on {name}: {len(roots)} sources in {dt * 1e3:.3f} ms "
              f"({len(roots) / dt:.1f} sources/s)")
        print("top-5 central vertices:",
              ", ".join(f"{v}={scores[v]:.1f}" for v in top))
        if args.trace:
            n_flat = msbfs.wave_rows(pg) * msbfs.lane_words(lanes)
            wave = (roots[:lanes] + [-1] * lanes)[:lanes]
            out = bc.build_bc_fn(pg, bcfg, lanes, device=dev, trace=True)(eng._arrays, wave)
            trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
                out[-1], algo="bc", sync=bcfg.sync, p=pg.p, fanout=bcfg.fanout,
                n_words=n_flat, capacity=bcfg.resolved_capacity(n_flat),
                density_threshold=bcfg.density_threshold))
    else:
        prog = programs.by_name(args.algo)
        cfg = programs.ProgramConfig(fanout=args.fanout, sync=args.sync,
                                     sparse_capacity=args.sparse_capacity,
                                     density_threshold=args.density_threshold)
        eng = BFSQueryEngine(pg, bcfg, device=dev)
        eng.run_program(args.algo, cfg)  # warm-up
        eng.stats = EngineStats()
        runs = [timed(eng.run_program, args.algo, cfg) for _ in range(3)]
        times = np.array([dt for _, dt in runs])
        (res, iters, work), _ = runs[-1]
        stats = eng.stats
        timing = {"mean": float(times.mean() * 1e3), "total": float(times.sum() * 1e3)}
        print(f"{args.algo} {cfg.sync} fanout={args.fanout} ranks={args.ranks} on "
              f"{name}: {iters} rounds in {times.mean() * 1e3:.3f} ms, GEdge/s "
              f"{work / times.mean() / 1e9:.4f}")
        if args.algo == "pagerank":
            top = np.argsort(res)[::-1][:5]
            print("top-5 ranked vertices:", ", ".join(f"{v}={res[v]:.2e}" for v in top))
        elif args.algo == "cc":
            print(f"components: {np.unique(res[: g.n_real]).size}")
        elif args.algo == "tri":
            print(f"total triangles: {programs.total_triangles(res):,}")
        else:
            print(f"max core number: {int(res.max())} "
                  f"(degeneracy of the symmetrized graph)")
        if args.trace:
            n_words = programs.program_msg_words(pg, prog)
            out = programs.build_program_fn(pg, prog, cfg, device=dev, trace=True)(
                eng._arrays, prog.default_arg(pg, dev))
            trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
                out[-1], algo=args.algo, sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
                n_words=n_words, capacity=cfg.resolved_capacity(n_words),
                density_threshold=cfg.density_threshold))
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo=args.algo, graph=graph_doc, devices=args.ranks,
            config=config, timing_ms=timing, engine_stats=stats, device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
