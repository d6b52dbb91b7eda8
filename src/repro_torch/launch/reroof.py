"""Re-derive the roofline fields of the dry run's rows from their SAVED
tables, measuring nothing again (the port of ``repro.launch.reroof``).

Every LM cell of :mod:`repro_torch.launch.dryrun` saves what its terms
are derived from (flops by op, collectives by kind, memory parts) under
``<dir>/<mesh>/tables/<tag>.json``; when the byte model or the formulas
change, this re-derives every derived field of the rows in seconds.  BFS
rows are left alone, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.reroof [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT, derive


def reroof_cell(json_path: str, tables_path: str) -> bool:
    """Re-derive one row from its tables in place; False for a row that is
    not an ``ok`` LM row."""
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok" or rec.get("kind") == "bfs":
        return False
    with open(tables_path) as f:
        tables = json.load(f)
    derive(rec, tables)
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n = 0
    for mesh in ("single", "multi"):
        for jp in sorted(glob.glob(os.path.join(args.dir, mesh, "*.json"))):
            tag = os.path.splitext(os.path.basename(jp))[0]
            tp = os.path.join(args.dir, mesh, "tables", f"{tag}.json")
            if os.path.exists(tp) and reroof_cell(jp, tp):
                n += 1
    print(f"re-derived roofline fields for {n} cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
