"""Read the check's readings on several seeds at a cell's own size: the
port's mismatched depths over the sampled searches (the lower reading) and
the control's, the port under its own level limit set one level short of
each sampled search's deepest depth (the upper reading).

    python3 bench/control.py --workload kron23.bfs --seeds 11,12,13 --seconds 5

One process, one JSON line a seed; each seed pays the cell's whole
set-up.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, args.device,
                               control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": run.correct,
                          "compared": run.compared, "port": run.checks["mismatched_depths"][0],
                          "control": run.control, "units": len(run.units),
                          "setup_s": run.setup_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
