#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Kronecker scale 23, EF 8, P=16; torus 1024^2

Drives the port's main path, single-source ButterFly BFS, through the entry
points a user calls (``build_bfs_fn`` on ``place_arrays``), and holds it to
account:

1. card: name and power limit (nvidia-smi), torch, CUDA and numpy versions;
2. build: the four CUDA kernels, compiled from ``src/repro_torch/kernels/csrc``;
3. ETL: Kronecker graph, 1D partition over P simulated ranks, kernel layout,
   placement on the card; the 1024x1024 torus the same way;
4. kernel checks: each kernel against its plain PyTorch version on the card,
   at the shapes the layouts give it, exactly (integer kernels), with its
   time (CUDA events), the plain version's time and the memory bound;
5. Kronecker BFS, direction-optimizing, butterfly fanout 4, through the
   kernels: per-root time, trimmed GTEP/s, Graph500-style validation of
   every root, one root against the plain path bit for bit;
6. torus BFS, top-down (the windowed-gather path), the same way;
7. the launch count of every kernel over phases 5 and 6 (each must be > 0);
8. one root of each graph under ``torch.profiler`` (device time by kernel,
   the device's busy share), after every timed run; then the torus roots
   timed again, to show what a profiler session costs the runs after it;
9. ``{"ok": true, ...}`` as the last line.

Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing any result.  ``--out PATH`` also writes the results as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
REPLACES = {
    "frontier_gather_full": "src/repro/kernels/frontier_gather.py:77",
    "frontier_gather": "src/repro/kernels/frontier_gather.py:33",
    "frontier_scatter": "src/repro/kernels/frontier_scatter.py:62",
    "bitmap_or_reduce": "src/repro/kernels/bitmap_merge.py:27",
}
SOURCES = {
    "frontier_gather_full": "src/repro_torch/kernels/csrc/frontier_gather.cu",
    "frontier_gather": "src/repro_torch/kernels/csrc/frontier_gather.cu",
    "frontier_scatter": "src/repro_torch/kernels/csrc/frontier_scatter.cu",
    "bitmap_or_reduce": "src/repro_torch/kernels/csrc/bitmap_merge.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def random_words(shape, gen, dev):
    """int32 words with uniformly random bits."""
    import torch

    raw = torch.randint(0, 256, (*shape, 4), dtype=torch.uint8, generator=gen,
                        device=dev)
    return raw.view(torch.int32).reshape(shape)


def distinct_word_bytes(word_idx) -> int:
    """Bytes of the distinct bitmap words ``word_idx[P, ...]`` reads, each
    rank's words counted apart: what a gather must read at the least."""
    import torch

    p = word_idx.shape[0]
    rank = torch.arange(p, device=word_idx.device).view(p, *[1] * (word_idx.dim() - 1))
    keys = rank * (int(word_idx.max()) + 1) + word_idx.long()
    return 4 * torch.unique(keys).numel()


def check_kernel(name, kernel, plain, inputs, moved, reps=20):
    """Hold ``kernel()`` against ``plain()`` exactly and time both; ``moved``
    is the least number of bytes the function must move, the bound's
    numerator.  Returns the kernel's record for the JSON line."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, "
                             f"plain {want.dtype}{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, max(2, reps // 4))
    rec = dict(name=name, route="cuda", source=SOURCES[name],
               replaces=REPLACES[name], launches=0, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes", library_ms=None,
               shape=" ".join(f"{tuple(t.shape)}" for t in inputs))
    log(f"  {name}: exact; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms for {moved / 1e6:.1f} MB) at {rec['shape']}")
    return rec


def validate(g, labels, root, dist) -> None:
    """Graph500-style checks of one BFS tree, vectorised over the CSR."""
    import numpy as np

    from repro_torch.core.bfs import INF

    reached = dist < INF
    if dist[root] != 0:
        raise AssertionError(f"root {root}: d[root] = {dist[root]}")
    if not np.array_equal(reached, labels == labels[root]):
        raise AssertionError(f"root {root}: reached set != its component")
    du, dv = dist[g.src], dist[g.dst]
    both = reached[g.src] & reached[g.dst]
    if np.any(np.abs(du[both] - dv[both]) > 1):
        raise AssertionError(f"root {root}: an edge spans more than one level")
    has_parent = np.zeros(g.n, dtype=bool)
    has_parent[g.dst[both & (du == dv - 1)]] = True
    orphan = reached & ~has_parent
    orphan[root] = False
    if orphan.any():
        raise AssertionError(f"root {root}: {int(orphan.sum())} reached vertices "
                             f"have no neighbour one level up")


def etl(label, make_graph, ranks, dev):
    """Generate, partition, lay out and place one graph; returns its parts."""
    import torch

    from repro_torch.core import bfs
    from repro_torch.graph import csr, partition
    from repro_torch.kernels import blocks

    t = [time.perf_counter()]
    g = make_graph()
    t.append(time.perf_counter())
    pg = partition.partition_1d(g, ranks)
    t.append(time.perf_counter())
    layout = blocks.build_bfs_layout(pg)
    t.append(time.perf_counter())
    labels = csr.connected_components(g)
    t.append(time.perf_counter())
    arrays = bfs.place_arrays(pg, layout, device=dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    s = [b - a for a, b in zip(t, t[1:])]
    dev_bytes = nbytes(*arrays.values())
    log(f"  {label}: n={g.n:,} m={g.n_edges:,} directed, P={ranks}, "
        f"emax={pg.emax:,}, n_words={pg.n_words:,}; generate {s[0]:.1f} s, "
        f"partition {s[1]:.1f} s, layout {s[2]:.1f} s, components {s[3]:.1f} s, "
        f"place {s[4]:.1f} s; {dev_bytes / 1e9:.2f} GB on the card; "
        f"meta {layout.meta}")
    return dict(g=g, pg=pg, layout=layout, labels=labels, arrays=arrays,
                etl_s=s, device_bytes=dev_bytes)


def device_breakdown(label, run, wall_ms, top=8):
    """Where one BFS's time goes: device time by kernel name from
    ``torch.profiler`` over one run, and the device's busy share of
    ``wall_ms``, the same run's time unprofiled (the profiler slows the
    host, not the kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
            for e in kernels[:top]]
    if not rows:
        log(f"  {label} profile: the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_busy_ms=None, top=[])
    log(f"  {label} profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall ({busy_ms / wall_ms:.1%}); device time by kernel:")
    for name, ms, n in rows:
        log(f"    {ms:9.3f} ms  {n:6d}x  {name}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top=rows)


def run_bfs(label, parts, cfg, n_roots, seed, dev):
    """Time ``cfg`` over distinct largest-component roots with the CLI's
    protocol (``bfs_run.time_roots``), validate every root, and hold one
    root against the plain path bit for bit.  Returns the summary, the
    kernel launches of the timed and warm-up runs, a function that profiles
    one root, and one that repeats the timed runs."""
    import numpy as np
    import torch

    from repro_torch.core import bfs, butterfly, collectives
    from repro_torch.graph import csr
    from repro_torch.kernels import build
    from repro_torch.launch import bfs_run

    g, pg, layout, arrays = parts["g"], parts["pg"], parts["layout"], parts["arrays"]
    roots = csr.largest_component_roots(
        g, n_roots, np.random.default_rng(seed), labels=parts["labels"]).tolist()
    fn = bfs.build_bfs_fn(pg, cfg, layout, device=dev)
    build.reset_launches()
    runs, trimmed_ms, trimmed_gteps = bfs_run.time_roots(fn, arrays, roots, dev)
    launches = dict(build.LAUNCHES)
    n_runs = len(roots) + 1

    for r, (dt, levels, scanned, d_owned) in zip(roots, runs):
        validate(g, parts["labels"], r, bfs.assemble_distances(pg, d_owned))
        log(f"  root {r}: {dt * 1e3:.3f} ms, {levels} levels, {scanned:.0f} "
            f"edges examined, {scanned / dt / 1e9:.4f} GTEP/s; valid")

    # one root on the plain path, on the card, bit for bit; the kernel run
    # again with a communicator to read the merge's bytes per rank
    comm = collectives.Communicator(pg.p, dev)
    d_k, lv_k, sc_k = fn(arrays, roots[0], comm)
    plain = bfs.build_bfs_fn(pg, dataclasses.replace(cfg, use_kernels=False),
                             device=dev)
    d_p, lv_p, sc_p = plain(arrays, roots[0])
    if not (torch.equal(d_k, d_p) and lv_k == lv_p and sc_k == sc_p):
        raise AssertionError(f"{label}: kernel path != plain path at root "
                             f"{roots[0]}: levels {lv_k}/{lv_p}, scanned "
                             f"{sc_k}/{sc_p}")
    if cfg.sync == "butterfly":
        want = lv_k * butterfly.bytes_per_node_allreduce(pg.p, cfg.fanout,
                                                         pg.n_words * 4)
        if not np.all(comm.bytes_sent == want):
            raise AssertionError(f"{label}: merge bytes per rank "
                                 f"{comm.bytes_sent} != {want}")
    summary = dict(
        roots=len(roots), ms=[x[0] * 1e3 for x in runs],
        levels=[x[1] for x in runs], scanned=[x[2] for x in runs],
        trimmed_ms=trimmed_ms, trimmed_gteps=trimmed_gteps,
        merge_bytes_per_rank=int(comm.bytes_sent[0]),
        launches_per_bfs={k: v / n_runs for k, v in launches.items()},
    )
    log(f"  {label}: {len(roots)} roots valid; trimmed mean "
        f"{summary['trimmed_ms']:.3f} ms, {summary['trimmed_gteps']:.4f} GTEP/s "
        f"(first reading); kernel path == plain path at root {roots[0]} "
        f"({lv_k} levels, {sc_k:.0f} edges); merge sent "
        f"{summary['merge_bytes_per_rank']:,} B per rank in that BFS")
    return (summary, launches,
            lambda: device_breakdown(label, lambda: fn(arrays, roots[0]),
                                     runs[0][0] * 1e3),
            lambda: bfs_run.time_roots(fn, arrays, roots, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=23)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--torus-side", type=int, default=1024)
    ap.add_argument("--torus-roots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import bfs
    from repro_torch.graph import generators
    from repro_torch.kernels import bitmap_merge, build, frontier_gather
    from repro_torch.kernels import frontier_scatter, ref

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log("[1/9] card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    log("[2/9] build")
    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    log(f"  built {lib.relative_to(ROOT)} in {build_s:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "bytes stack frame" in line:
            log(f"  ptxas: {line.strip()}")

    log("[3/9] ETL")
    kron = etl(f"kronecker scale {args.scale} EF {args.edge_factor}",
               lambda: generators.kronecker(args.scale, args.edge_factor,
                                            seed=args.seed), args.ranks, dev)
    torus = etl(f"torus {args.torus_side}x{args.torus_side}",
                lambda: generators.torus_2d(args.torus_side), args.ranks, dev)

    log("[4/9] kernel checks (exact, at main-path shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ka, km = kron["arrays"], kron["layout"].meta
    ta, tm = torus["arrays"], torus["layout"].meta
    p = args.ranks
    if not km["gather_full"] or tm["gather_full"]:
        raise AssertionError(f"expected a full-gather Kronecker layout and a "
                             f"windowed torus layout, got {km} / {tm}")
    words = random_words((p, km["gather_words_pad"]), gen, dev)
    twords = random_words((p, tm["gather_words_pad"]), gen, dev)
    active = torch.rand(ka["tds_dst"].shape, generator=gen, device=dev) < 0.5
    stack = random_words((p, args.fanout, kron["pg"].n_words), gen, dev)
    tww = tm["gather_ww"]
    window_words = (ta["tdg_ws"].long() * tww)[..., None] + torch.arange(tww, device=dev)
    n_scatter_out = p * km["scatter_windows"] * km["scatter_ww"] * 4
    # the gathers read only the bitmap words their indices reach, every
    # other input whole, and write one bool per slot
    records = [
        check_kernel("frontier_gather_full",
                     lambda: frontier_gather.frontier_gather_full(words, ka["tdg_src"]),
                     lambda: ref.frontier_gather_full(words, ka["tdg_src"]),
                     (words, ka["tdg_src"]),
                     distinct_word_bytes(ka["tdg_src"] >> 5)
                     + nbytes(ka["tdg_src"]) + ka["tdg_src"].numel()),
        check_kernel("frontier_gather",
                     lambda: frontier_gather.frontier_gather(
                         twords, ta["tdg_ws"], ta["tdg_src"], ww=tww),
                     lambda: ref.frontier_gather(twords, ta["tdg_ws"], ta["tdg_src"], tww),
                     (twords, ta["tdg_ws"], ta["tdg_src"]),
                     distinct_word_bytes(window_words)
                     + nbytes(ta["tdg_ws"], ta["tdg_src"]) + ta["tdg_src"].numel()),
        check_kernel("frontier_scatter",
                     lambda: frontier_scatter.frontier_scatter(
                         active, ka["tds_win"], ka["tds_dst"],
                         n_windows=km["scatter_windows"], ww=km["scatter_ww"]),
                     lambda: ref.frontier_scatter(active, ka["tds_win"], ka["tds_dst"],
                                                  km["scatter_windows"], km["scatter_ww"]),
                     (active, ka["tds_win"], ka["tds_dst"]),
                     nbytes(active, ka["tds_win"], ka["tds_dst"]) + n_scatter_out),
        check_kernel("bitmap_or_reduce",
                     lambda: bitmap_merge.bitmap_or_reduce(stack),
                     lambda: ref.bitmap_or_reduce(stack), (stack,),
                     nbytes(stack) // args.fanout * (args.fanout + 1)),
    ]
    del words, twords, active, stack, window_words

    log(f"[5/9] Kronecker BFS: direction_optimizing, butterfly fanout "
        f"{args.fanout}, kernels, {args.roots} roots")
    kcfg = bfs.BFSConfig(fanout=args.fanout, sync="butterfly",
                         mode="direction_optimizing", use_kernels=True)
    kron_sum, kron_launch, kron_profile, _ = run_bfs(
        "kronecker", kron, kcfg, args.roots, args.seed, dev)

    log(f"[6/9] torus BFS: top_down, butterfly fanout {args.fanout}, kernels, "
        f"{args.torus_roots} roots")
    tcfg = bfs.BFSConfig(fanout=args.fanout, sync="butterfly", mode="top_down",
                         use_kernels=True)
    torus_sum, torus_launch, torus_profile, torus_again = run_bfs(
        "torus", torus, tcfg, args.torus_roots, args.seed, dev)

    log("[7/9] kernel launches on the main path (phases 5 and 6)")
    for rec in records:
        rec["launches"] = kron_launch[rec["name"]] + torus_launch[rec["name"]]
    idle = [r["name"] for r in records if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    log("  " + ", ".join(f"{r['name']} {r['launches']}" for r in records))

    log("[8/9] profiles (one root each), then the torus roots timed again")
    kron_sum["profile"] = kron_profile()
    torus_sum["profile"] = torus_profile()
    _, torus_sum["after_profiler_ms"], _ = torus_again()
    log(f"  torus trimmed mean after the profiler: "
        f"{torus_sum['after_profiler_ms']:.3f} ms (before it: "
        f"{torus_sum['trimmed_ms']:.3f} ms)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"total {time.perf_counter() - t_start:.0f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           kernels=records, kronecker=kron_sum, torus=torus_sum,
                           kronecker_launches=kron_launch,
                           torus_launches=torus_launch,
                           etl_s={"kronecker": kron["etl_s"], "torus": torus["etl_s"]},
                           device_bytes={"kronecker": kron["device_bytes"],
                                         "torus": torus["device_bytes"]},
                           args=vars(args)), f, indent=1)
    log("[9/9] result")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
