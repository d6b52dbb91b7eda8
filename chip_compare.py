#!/usr/bin/env python3
"""Time the kernels and the BFS of several trees of this repository on one
NVIDIA card, in one process, in turns.

    python3 chip_compare.py --trees build/parent,.,.,build/parent \\
        --out build/compare.json

``--trees`` lists repository roots, each holding ``src/repro_torch`` (for
example an older commit unpacked with ``git archive`` into the ignored
``build/``); a tree named twice is run twice.  The graphs are generated,
partitioned, laid out and placed once, by this tree's package, so every tree
must share this tree's layout (``kernels/blocks.py``).  Then, for each tree
in turn: its ``repro_torch`` is imported afresh and its kernels built into
its own ``build/``; its scatter and both gathers are held to the plain
versions on ``chip_smoke.edge_cases``; every kernel is timed at every call
site of the main path on the inputs of ``chip_smoke.site_cases`` (CUDA
events, L2 flushed, each output held exactly against this tree's plain
version; the full gather on each route the tree's wrapper has); and both
cells' BFS are timed with the CLI's protocol, the first root validated
(``chip_smoke.py`` validates every root).  After every tree's timed runs,
each tree profiles one root of each cell (device time by call site inside
the BFS, per-level directions against an unprofiled run), in the same
order.

Prints the card, one JSON line per tree run, and a table of site times,
in-BFS site times and trimmed BFS times by run.  Without a CUDA device it
exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import chip_smoke as cs


def load_tree(root: str):
    """Import ``root``'s ``repro_torch`` in place of the one imported now;
    returns its ``build``, ``bfs`` and ``bfs_run`` modules."""
    import importlib

    for name in [n for n in sys.modules if n.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    build = importlib.import_module("repro_torch.kernels.build")
    bfs = importlib.import_module("repro_torch.core.bfs")
    bfs_run = importlib.import_module("repro_torch.launch.bfs_run")
    return build, bfs, bfs_run


def bfs_fn(bfs, parts, args, dev):
    """The BFS of one cell through ``bfs``, the imported tree's module."""
    cfg = bfs.BFSConfig(fanout=args.fanout, sync="butterfly", mode=parts["mode"],
                        use_kernels=True)
    return bfs.build_bfs_fn(parts["pg"], cfg, parts["layout"], device=dev)


def profile_tree(root, cells, args, dev, wall_ms):
    """One root of each cell under the profiler, device time by call site
    (``chip_smoke.device_breakdown``), with ``root``'s package."""
    _, bfs, _ = load_tree(root)
    try:
        out = {}
        for label, (parts, roots) in cells.items():
            fn = bfs_fn(bfs, parts, args, dev)
            fn(parts["arrays"], roots[0])
            out[label] = cs.device_breakdown(
                label, lambda: fn(parts["arrays"], roots[0]),
                wall_ms[label], cs.call_sites(label, parts["layout"].meta,
                                              parts["arrays"]))
        return out
    finally:
        sys.path.pop(0)


def run_tree(root, cases, wants, cells, args, dev):
    """One tree's run: build, every site, both cells' BFS."""
    import torch

    build, bfs, bfs_run = load_tree(root)
    try:
        t0 = time.perf_counter()
        build.build()
        build.library()
        out = dict(tree=root, build_s=time.perf_counter() - t0, sites=[])
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        out["edge_cases"] = cs.edge_cases(gen, dev)
        for case, want in zip(cases, wants):
            fn = cs.wrapper(case["name"])
            route_ms = {}
            for label, extra in cs.case_routes(case, fn):
                call = (lambda: fn(*case["args"], **case["kwargs"], **extra))
                if not torch.equal(call(), want):
                    raise AssertionError(f"{root}: {case['name']} {cs.site_key(case)} "
                                         f"{label} differs from the plain version")
                route_ms[label] = cs.time_ms(call, args.reps)
            out["sites"].append(dict(name=case["name"], **cs.site_key(case),
                                     ms=next(iter(route_ms.values())), route_ms=route_ms,
                                     bound_ms=case["bytes"] / cs.HBM_BYTES_PER_S * 1e3))
        for label, (parts, roots) in cells.items():
            fn = bfs_fn(bfs, parts, args, dev)
            runs, trimmed_ms, gteps = bfs_run.time_roots(fn, parts["arrays"], roots, dev)
            cs.validate(parts, roots[0], runs[0][3])
            out[label] = dict(trimmed_ms=trimmed_ms, trimmed_gteps=gteps,
                              ms=[x[0] * 1e3 for x in runs])
        return out
    finally:
        sys.path.pop(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="build/parent,.,.,build/parent")
    ap.add_argument("--scale", type=int, default=23)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--torus-side", type=int, default=1024)
    ap.add_argument("--torus-roots", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.graph import csr, generators

    trees = args.trees.split(",")
    for root in set(trees):
        if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
            raise SystemExit(f"chip_compare: {root} holds no src/repro_torch")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)}")
    kron = cs.etl(f"kronecker scale {args.scale} EF {args.edge_factor}",
                  lambda: generators.kronecker(args.scale, args.edge_factor,
                                               seed=args.seed),
                  args.ranks, dev, "direction_optimizing")
    torus = cs.etl(f"torus {args.torus_side}x{args.torus_side}",
                   lambda: generators.torus_2d(args.torus_side), args.ranks, dev,
                   "top_down")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cells, cases = {}, []
    for label, parts, n_roots in (("kronecker", kron, args.roots),
                                  ("torus", torus, args.torus_roots)):
        roots = csr.largest_component_roots(
            parts["g"], n_roots, np.random.default_rng(args.seed),
            labels=parts["labels"]).tolist()
        cells[label] = (parts, roots)
        cases += cs.site_cases(label, parts, gen, dev, args.fanout)
    from repro_torch.kernels import ref

    wants = [getattr(ref, c["name"])(*c["args"], **c["kwargs"]) for c in cases]

    results = []
    for i, root in enumerate(trees):
        cs.log(f"[run {i + 1}/{len(trees)}] {root}")
        res = run_tree(root, cases, wants, cells, args, dev)
        res["run"] = i
        results.append(res)
        print(json.dumps(res), flush=True)

    # profiles last: a profiler session slows the host work timed after it
    for res in results:
        cs.log(f"[profile {res['run'] + 1}/{len(trees)}] {res['tree']}")
        res["profile"] = profile_tree(res["tree"], cells, args, dev,
                                      {k: res[k]["ms"][0] for k in cells})

    floor_ms = cs.event_floor_ms()
    cs.log(f"{card}; ms by run ({', '.join(trees)}); timing floor {floor_ms:.4f} ms")
    for j, case in enumerate(cases):
        site = results[0]["sites"][j]
        cs.log(f"  {case['name']}@{case['plane']} ({case['cell']}, "
               f"{case.get('activity', '-')}), bound {site['bound_ms']:.4f}: "
               + " ".join(f"{r['sites'][j]['ms']:.4f}" for r in results)
               + "; by route: " + " | ".join(
                   ", ".join(f"{k} {v:.4f}" for k, v in r["sites"][j]["route_ms"].items())
                   for r in results))
    sites = sorted({k for r in results for c in r["profile"].values() for k in c["sites"]})
    for site in sites:
        per = [next((c["sites"][site] for c in r["profile"].values() if site in c["sites"]),
                    None) for r in results]
        cs.log(f"  {site} in the BFS, ms per launch: " + " ".join(
            "not measured" if not (x and x["ms"]) else f"{x['ms'] / x['count']:.4f}"
            for x in per))
    for label in cells:
        cs.log(f"  {label} trimmed ms: "
               + " ".join(f"{r[label]['trimmed_ms']:.3f}" for r in results)
               + "; GTEP/s: "
               + " ".join(f"{r[label]['trimmed_gteps']:.4f}" for r in results))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, trees=trees,
                           timing_floor_ms=floor_ms,
                           runs=results, args=vars(args)), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
