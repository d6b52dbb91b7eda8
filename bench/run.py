"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload kron23.bfs --seed 7 --seconds 10 --trace 0

From the root of a checkout: it draws the cell's inputs from ``--seed``,
sets the port up, warms it up, measures for ``--seconds``, checks a sample
of the window's answers against the plain reference, and prints one JSON
line last on standard output (``--trace 1``: the per-layer metrics, from a
traced segment after the window).  The numbers compared, each beside its
limit, are the last lines on standard error.  It exits with another code
than 0 and prints no result where there is no card, too few cards, or a
module of JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # PyTorch's own runtime-compiled kernels cache inside the checkout, at a
    # fixed path (the port builds its kernel library under build/ itself)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "torch_kernels")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    run = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start=T_START, spec=spec)
    line = harness.result(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process after the window: {bad}", file=sys.stderr)
        return 3
    harness.log(f"set-up {run.setup_s:.2f} s (inputs {run.inputs_s:.2f} s; ETL "
                + ", ".join(f"{k} {v:.2f} s" for k, v in run.etl.items())
                + f"); window {run.window_s:.3f} s, {len(run.units)} units, "
                f"{run.attempted} requests")
    if run.trace:
        harness.log(f"traced: kernel s {run.traced.kernel_s}, calls traced "
                    f"{run.traced.kernel_calls}, counted {run.traced.calls}, "
                    f"least bytes {run.traced.kernel_bytes}, replay {run.counters}, "
                    f"{len(run.traced_units)} units, {run.traced_untraced_s():.4f} s untraced, "
                    f"{run.traced.window_s:.4f} s traced")
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        harness.log(f"{name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
