"""Render the dry-run and roofline tables from the per-cell JSONs written
by :mod:`repro_torch.launch.dryrun` (the port of ``repro.launch.summary``).

    PYTHONPATH=src python -m repro_torch.launch.summary [--dir experiments/dryrun_torch]

A cell fits when its memory a device is within the H100's 80 GB.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.dryrun import DEFAULT_OUT

#: H100 SXM5 device memory, 80 GB (NVIDIA H100 Tensor Core GPU data sheet).
H100_HBM = 80e9

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str, mesh: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, mesh, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _key(r):
    try:
        si = SHAPE_ORDER.index(r["shape"])
    except ValueError:
        si = 99
    return (r["arch"], si)


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def roofline_table(recs: List[Dict]) -> str:
    hdr = (f"| {'arch':21s} | {'shape':11s} | {'t_comp ms':>9s} | "
           f"{'t_mem ms':>8s} | {'t_coll ms':>9s} | {'dom':10s} | "
           f"{'MF/flops':>8s} | {'roofline %':>10s} | note |")
    sep = "|" + "|".join("-" * (len(c) + 2) for c in hdr.split("|")[1:-1]) + "|"
    rows = [hdr, sep]
    for r in sorted(recs, key=_key):
        if r.get("kind") == "bfs":
            continue
        if r["status"] == "skip":
            rows.append(
                f"| {r['arch']:21s} | {r['shape']:11s} | {'—':>9s} | {'—':>8s} "
                f"| {'—':>9s} | {'skip':10s} | {'—':>8s} | {'—':>10s} | "
                f"{r['skip_reason'].split(':')[0]} |")
            continue
        if r["status"] != "ok":
            rows.append(
                f"| {r['arch']:21s} | {r['shape']:11s} | FAIL: "
                f"{r.get('error', '?')[:60]} |")
            continue
        note = ""
        if r["memory"]["peak_bytes_per_device"] > H100_HBM:
            note = f"OVER 80GB ({fmt_bytes(r['memory']['peak_bytes_per_device'])}GiB)"
        rows.append(
            f"| {r['arch']:21s} | {r['shape']:11s} "
            f"| {r['t_compute'] * 1e3:9.1f} | {r['t_memory'] * 1e3:8.1f} "
            f"| {r['t_collective'] * 1e3:9.2f} | {r['dominant']:10s} "
            f"| {r['useful_flops_ratio']:8.2f} "
            f"| {r['roofline_fraction'] * 100:10.1f} | {note} |")
    return "\n".join(rows)


def dryrun_table(recs: List[Dict]) -> str:
    hdr = (f"| {'arch':21s} | {'shape':11s} | {'status':6s} | "
           f"{'mem/dev GiB':>11s} | {'fits H100':9s} | {'measure s':>9s} | "
           f"{'coll ops (ar/ag/rs/a2a/cp)':26s} |")
    sep = "|" + "|".join("-" * (len(c) + 2) for c in hdr.split("|")[1:-1]) + "|"
    rows = [hdr, sep]
    for r in sorted(recs, key=_key):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']:21s} | {r['shape']:11s} | skip   "
                        f"| {'—':>11s} | {'—':9s} | {'—':>9s} | {'—':26s} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']:21s} | {r['shape']:11s} | FAIL |")
            continue
        mem = r["memory"]["peak_bytes_per_device"]
        c = r.get("collectives", {})
        ops = "/".join(
            str(int(c.get(k, {}).get("count", 0)))
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute")
        )
        comp = r.get("compile_s", 0) + r.get("compile_runtime_cfg_s", 0)
        rows.append(
            f"| {r['arch']:21s} | {r['shape']:11s} | ok     "
            f"| {fmt_bytes(mem):>11s} | {'YES' if mem <= H100_HBM else 'NO':9s} "
            f"| {comp:9.0f} | {ops:26s} |")
    return "\n".join(rows)


def bfs_table(recs: List[Dict]) -> str:
    rows = ["| run | chips | mem/dev GiB | t_comp ms | t_mem ms | t_coll ms |"
            " dom | permutes/level |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["mesh"], str(r.get("fanout")))):
        if r.get("kind") != "bfs" or r["status"] != "ok":
            continue
        c = r.get("collectives", {})
        rows.append(
            f"| {r['shape'].split('_')[0]} {r.get('sync')} f={r.get('fanout')} "
            f"({r['mesh']}) "
            f"| {r['chips']} | {fmt_bytes(r['memory']['peak_bytes_per_device'])} "
            f"| {r['t_compute'] * 1e3:.2f} | {r['t_memory'] * 1e3:.2f} "
            f"| {r['t_collective'] * 1e3:.2f} | {r['dominant']} "
            f"| {int(c.get('collective-permute', {}).get('count', 0))} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    for mesh in ("single", "multi"):
        recs = load(args.dir, mesh)
        if not recs:
            continue
        lm = [r for r in recs if r.get("kind") != "bfs"]
        bfs = [r for r in recs if r.get("kind") == "bfs"]
        n_ok = sum(r["status"] == "ok" for r in recs)
        n_skip = sum(r["status"] == "skip" for r in recs)
        n_fail = sum(r["status"] == "fail" for r in recs)
        print(f"\n##### mesh={mesh}: {n_ok} ok, {n_skip} skip, {n_fail} fail\n")
        print("### Dry-run\n")
        print(dryrun_table(lm))
        if mesh == "single":
            print("\n### Roofline\n")
            print(roofline_table(lm))
        if bfs:
            print("\n### BFS cells (per-level terms)\n")
            print(bfs_table(bfs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
