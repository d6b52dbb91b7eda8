"""Distributed ButterFly BFS launcher on PyTorch (the paper's workload, end
to end, on one device).

``python -m repro_torch.launch.bfs_run --scale 20 --ranks 16 --fanout 4 --kernels``

Generates a graph, 1D-partitions it over P simulated ranks, and runs BFS
from distinct roots in the largest component with the paper's protocol:
one warm-up run, then one run per root, the fastest and slowest quartiles
trimmed, GTEP/s = edges examined / BFS wall time.  Each run's clock stops
after ``torch.cuda.synchronize()``.

``--algo`` also runs the weighted traversals and the vertex programs:
``sssp`` (weighted shortest paths, ``--delta`` buckets; weights default to
``--max-weight 64``), ``bc`` (Brandes betweenness in waves of
``--num-sources`` lanes) and ``pagerank``, ``cc``, ``tri``, ``kcore``
(called through ``programs.run_program`` until the query engine is
ported; each timed over a few repetitions, being root-free).

``--sync`` picks any of the six frontier syncs (``--sparse-capacity`` and
``--density-threshold`` tune the sparse and adaptive ones).  ``--trace
FILE`` runs the first root once more with the flight recorder on and each
level timed, and writes the Perfetto/Chrome ``trace_event`` document;
``--stats-json PATH`` writes the run's identity and timing as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

STATS_SCHEMA = "bfs_run_stats/v1"


def write_stats_json(path, *, algo, graph, devices, config, timing_ms,
                     engine_stats, **extra) -> None:
    """Persist one run's machine-readable stats in the reference's
    ``bfs_run_stats/v1`` schema (``engine_stats`` is null until the query
    engine is ported)."""
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
                         "connected components, triangle counting, k-core); the "
                         "programs run through programs.run_program until the "
                         "query engine is ported")
    ap.add_argument("--max-weight", type=int, default=0,
                    help="uint32 edge weights in [1, max-weight]; 0 = unweighted "
                         "(sssp defaults to 64)")
    ap.add_argument("--delta", type=int, default=0,
                    help="sssp bucket width (delta-stepping-style); 0 = "
                         "level-synchronous relaxation")
    ap.add_argument("--num-sources", type=int, default=1,
                    help="bc: sources (lanes) per Brandes wave")
    ap.add_argument("--roots", type=int, default=16,
                    help="number of distinct roots (bc: sources) to time")
    ap.add_argument("--kernels", action="store_true",
                    help="phase 1 and the butterfly merge via the CUDA kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write the per-level flight-recorder trace of the "
                         "first root, each level timed, as Perfetto/Chrome "
                         "trace_event JSON")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the run's identity and timing as JSON")
    args = ap.parse_args(argv)

    from repro_torch import programs
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
    if args.algo != "bfs" and args.kernels:
        ap.error("--kernels drives the single-source BFS; drop it for "
                 f"--algo {args.algo}")

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
    graph_doc = {"name": args.graph, "scale": args.scale,
                 "edge_factor": args.edge_factor, "n": g.n, "n_real": g.n_real,
                 "n_edges": g.n_edges, "weighted": bool(g.weighted)}
    if args.algo != "bfs":
        return run_algo(args, g, pg, dev, name, graph_doc, max_weight)
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
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo="bfs", graph=graph_doc, devices=args.ranks,
            config={"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
                    "lanes": 1, "use_kernels": bool(args.kernels),
                    "sparse_capacity": cfg.resolved_capacity(pg.n_words),
                    "density_threshold": args.density_threshold},
            timing_ms={"mean": ms, "total": float(sum(x[0] for x in runs) * 1e3)},
            engine_stats=None, device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


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
    """``--algo sssp|bc|pagerank|cc|tri|kcore``: time the traversal from
    the same distinct largest-component roots as BFS (each clock stopping
    after the device synchronises), or a root-free program over three
    repetitions after a warm-up; print the result's summary, and write the
    trace and stats as for BFS."""
    from repro_torch import programs
    from repro_torch.core import bfs, flightrec
    from repro_torch.graph import csr
    from repro_torch.traversal import bc, sssp

    sync = bfs.device_sync(dev)
    arrays = bfs.place_arrays(pg, device=dev)
    roots = csr.largest_component_roots(
        g, args.roots, np.random.default_rng(args.seed)).tolist()
    config = {"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
              "lanes": args.num_sources, "delta": args.delta,
              "max_weight": max_weight, "use_kernels": False}

    def timed(fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    trace_doc = None
    if args.algo == "sssp":
        cfg = sssp.SSSPConfig(fanout=args.fanout, sync=args.sync, delta=args.delta,
                              sparse_capacity=args.sparse_capacity,
                              density_threshold=args.density_threshold)
        fn = sssp.build_sssp_fn(pg, cfg, device=dev)
        fn(arrays, roots[0])  # warm-up
        runs = [timed(fn, arrays, r) for r in roots]
        times = np.array([dt for _, dt in runs])
        relaxed = np.array([out[2] for out, _ in runs])
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
        from repro_torch.analytics import msbfs

        cfg = bfs.BFSConfig(fanout=args.fanout, sync=args.sync, mode=args.mode,
                            sparse_capacity=args.sparse_capacity,
                            density_threshold=args.density_threshold)
        lanes = max(args.num_sources, 1)
        fn = bc.build_bc_fn(pg, cfg, lanes, device=dev)
        waves = [(roots[i : i + lanes] + [-1] * lanes)[:lanes]
                 for i in range(0, len(roots), lanes)]
        fn(arrays, waves[0])  # warm-up
        runs = [timed(fn, arrays, w) for w in waves]
        times = np.array([dt for _, dt in runs])
        scores = sum(bc.assemble_bc(pg, out[0]) for out, _ in runs)
        top = np.argsort(scores)[::-1][:5]
        print(f"BC {cfg.sync} fanout={args.fanout} ranks={args.ranks} lanes={lanes} "
              f"on {name}: {len(roots)} sources in {times.sum() * 1e3:.3f} ms "
              f"({len(roots) / times.sum():.1f} sources/s)")
        print("top-5 central vertices:",
              ", ".join(f"{v}={scores[v]:.1f}" for v in top))
        if args.trace:
            n_flat = msbfs.wave_rows(pg) * msbfs.lane_words(lanes)
            out = bc.build_bc_fn(pg, cfg, lanes, device=dev, trace=True)(arrays, waves[0])
            trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
                out[-1], algo="bc", sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
                n_words=n_flat, capacity=cfg.resolved_capacity(n_flat),
                density_threshold=cfg.density_threshold))
    else:
        prog = programs.by_name(args.algo)
        cfg = programs.ProgramConfig(fanout=args.fanout, sync=args.sync,
                                     sparse_capacity=args.sparse_capacity,
                                     density_threshold=args.density_threshold)
        fn = programs.build_program_fn(pg, prog, cfg, device=dev)
        arg = prog.default_arg(pg, dev)
        fn(arrays, arg)  # warm-up
        runs = [timed(fn, arrays, arg) for _ in range(3)]
        times = np.array([dt for _, dt in runs])
        out = runs[-1][0]
        res, iters, work = prog.assemble(pg, out[0]), out[-2], out[-1]
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
                arrays, arg)
            trace_doc = write_trace(args.trace, flightrec.TraversalTrace.from_buffer(
                out[-1], algo=args.algo, sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
                n_words=n_words, capacity=cfg.resolved_capacity(n_words),
                density_threshold=cfg.density_threshold))
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo=args.algo, graph=graph_doc, devices=args.ranks,
            config=config,
            timing_ms={"mean": float(times.mean() * 1e3),
                       "total": float(times.sum() * 1e3)},
            engine_stats=None, device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
