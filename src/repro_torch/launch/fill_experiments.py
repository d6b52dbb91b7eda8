"""Inject the dry run's generated tables into a Markdown file (the port of
``repro.launch.fill_experiments``).

    PYTHONPATH=src python -m repro_torch.launch.fill_experiments --file NOTES.md

Replaces the ``<!-- DRYRUN_TABLES -->`` and ``<!-- ROOFLINE_TABLES -->``
markers; idempotent: the generated blocks are fenced with BEGIN/END
comments, and a second run replaces them in place.
"""

from __future__ import annotations

import argparse
import re

from repro_torch.launch import summary
from repro_torch.launch.dryrun import DEFAULT_OUT


def _block(name: str, content: str) -> str:
    return (f"<!-- BEGIN {name} (generated by launch.fill_experiments) -->\n"
            f"{content}\n<!-- END {name} -->")


def build_dryrun_block(dir_: str) -> str:
    parts = []
    for mesh in ("single", "multi"):
        recs = summary.load(dir_, mesh)
        if not recs:
            continue
        lm = [r for r in recs if r.get("kind") != "bfs" and not r.get("tag")]
        bfs = [r for r in recs if r.get("kind") == "bfs"]
        n_ok = sum(r["status"] == "ok" for r in lm)
        n_skip = sum(r["status"] == "skip" for r in lm)
        n_fail = sum(r["status"] == "fail" for r in lm)
        label = "(16,16) single pod" if mesh == "single" else "(2,16,16) multi-pod"
        parts.append(f"\n#### mesh={mesh} {label}: {n_ok} ok / {n_skip} skip "
                     f"/ {n_fail} fail\n")
        parts.append(summary.dryrun_table(lm))
        if bfs:
            parts.append("\n**BFS cells (Kronecker, one dense level's terms):**\n")
            parts.append(summary.bfs_table(bfs))
    return _block("DRYRUN", "\n".join(parts))


def build_roofline_block(dir_: str) -> str:
    recs = [r for r in summary.load(dir_, "single")
            if r.get("kind") != "bfs" and not r.get("tag")]
    return _block("ROOFLINE", summary.roofline_table(recs))


def fill(text: str, dir_: str) -> str:
    """``text`` with its markers (or its earlier generated blocks) replaced by
    the tables of ``dir_``."""

    def replace(marker: str, name: str, block: str, text: str) -> str:
        fenced = re.compile(rf"<!-- BEGIN {name} .*?<!-- END {name} -->", re.S)
        if fenced.search(text):
            return fenced.sub(lambda _: block, text)
        return text.replace(marker, block)

    text = replace("<!-- DRYRUN_TABLES -->", "DRYRUN", build_dryrun_block(dir_), text)
    return replace("<!-- ROOFLINE_TABLES -->", "ROOFLINE", build_roofline_block(dir_), text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--file", required=True,
                    help="the Markdown file holding the markers")
    args = ap.parse_args(argv)
    with open(args.file) as f:
        text = f.read()
    text = fill(text, args.dir)
    with open(args.file, "w") as f:
        f.write(text)
    print(f"updated {args.file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
