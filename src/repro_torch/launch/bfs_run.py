"""Distributed ButterFly BFS launcher on PyTorch (the paper's workload, end
to end, on one device).

``python -m repro_torch.launch.bfs_run --scale 20 --ranks 16 --fanout 4 --kernels``

Generates a graph, 1D-partitions it over P simulated ranks, and runs BFS
from distinct roots in the largest component with the paper's protocol:
one warm-up run, then one run per root, the fastest and slowest quartiles
trimmed, GTEP/s = edges examined / BFS wall time.  Each run's clock stops
after ``torch.cuda.synchronize()``.

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
    ap.add_argument("--roots", type=int, default=16,
                    help="number of distinct roots to time")
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

    from repro_torch.core import bfs, flightrec
    from repro_torch.graph import csr, generators, partition
    from repro_torch.kernels import blocks

    dev = bfs.resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    if args.graph == "kronecker":
        g = generators.kronecker(args.scale, args.edge_factor, seed=args.seed)
    elif args.graph == "urand":
        g = generators.uniform_random(
            1 << args.scale, (1 << args.scale) * args.edge_factor, seed=args.seed)
    else:
        g = generators.torus_2d(1 << (args.scale // 2))
    print(f"graph: {args.graph} n={g.n:,} m={g.n_edges:,} (directed, symmetrized)")
    pg = partition.partition_1d(g, args.ranks)
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
        with open(args.trace, "w") as f:
            json.dump(flightrec.trace_chrome_doc(tr), f, indent=1)
        t = tr.summary()
        print(f"trace: {t['levels']} levels ({t['dense_levels']} dense / "
              f"{t['sparse_levels']} sparse / {t['fallback_levels']} fallback), "
              f"{t['bytes_per_node_total']:.0f} sync B/rank -> {args.trace}")
        trace_doc = tr.to_dict()
    if args.stats_json:
        write_stats_json(
            args.stats_json, algo="bfs",
            graph={"name": args.graph, "scale": args.scale,
                   "edge_factor": args.edge_factor, "n": g.n,
                   "n_real": g.n_real, "n_edges": g.n_edges},
            devices=args.ranks,
            config={"sync": args.sync, "mode": args.mode, "fanout": args.fanout,
                    "lanes": 1, "use_kernels": bool(args.kernels),
                    "sparse_capacity": cfg.resolved_capacity(pg.n_words),
                    "density_threshold": args.density_threshold},
            timing_ms={"mean": ms, "total": float(sum(x[0] for x in runs) * 1e3)},
            engine_stats=None, device=name,
            **({"trace": trace_doc} if trace_doc else {}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
