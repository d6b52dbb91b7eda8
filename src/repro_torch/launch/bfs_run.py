"""Distributed ButterFly BFS launcher on PyTorch (the paper's workload, end
to end, on one device).

``python -m repro_torch.launch.bfs_run --scale 20 --ranks 16 --fanout 4 --kernels``

Generates a graph, 1D-partitions it over P simulated ranks, and runs BFS
from distinct roots in the largest component with the paper's protocol:
one warm-up run, then one run per root, the fastest and slowest quartiles
trimmed, GTEP/s = edges examined / BFS wall time.  Each run's clock stops
after ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


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
                    choices=["butterfly", "all_to_all"])
    ap.add_argument("--mode", default="top_down",
                    choices=["top_down", "bottom_up", "direction_optimizing"])
    ap.add_argument("--roots", type=int, default=16,
                    help="number of distinct roots to time")
    ap.add_argument("--kernels", action="store_true",
                    help="phase 1 and the butterfly merge via the CUDA kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core import bfs
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
                        use_kernels=args.kernels)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
