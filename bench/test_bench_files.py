"""``BENCHMARK.json`` and the files it names: each loads by its name, names
and units keep to their characters, and a configuration, a traffic mix, a
generator and a metric are added as new files alone."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from bench.fixtures import BENCH, ROOT, one_thread, small_copy, small_root  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_spec_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    for entry in SPEC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
        assert entry["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_load_by_name(w):
    cell = harness.resolve(ROOT, w["name"])
    assert cell.config["name"] == w["config"]
    assert callable(cell.driver.inputs) and hasattr(cell.driver, "Driver")
    assert callable(cell.loop.window)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(m):
    assert callable(harness.load_module(BENCH / "metrics" / f"{m['name']}.py").read)
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "generators", "drivers",
                                  "loops"])
def test_every_file_is_named_for_what_it_holds(kind):
    files = sorted((BENCH / kind).iterdir())
    assert files
    for f in files:
        if f.name == "__pycache__":
            continue
        assert NAME.match(f.stem), f
        if f.suffix == ".json":
            data = json.loads(f.read_text())
            assert data.get("name", f.stem) == f.stem
        else:
            harness.load_module(f)


def test_a_cell_is_added_as_new_files_alone(tmp_path):
    """A throwaway configuration (on a generator of its own), traffic mix
    and metric, added as files and entries, run without another edit."""
    root = small_copy(tmp_path)
    b = root / "bench"
    (b / "generators" / "ring.py").write_text(
        "import torch\n\n\ndef edges(config, gen, device):\n"
        "    n = int(config['n'])\n    src = torch.arange(n, device=device)\n"
        "    return n, src, (src + 1) % n\n")
    (b / "configs" / "ring-64.json").write_text(json.dumps(
        {"name": "ring-64", "generator": "ring", "graph_seed": 0, "n": 64, "ranks": 4, "fanout": 2,
         "sync": "butterfly"}))
    (b / "traffic" / "pairs.json").write_text(json.dumps(
        {"driver": "bfs", "mode": "top_down", "use_kernels": True, "sample_units": 2,
         "warmup_units": 1, "trace_units": 1}))
    (b / "metrics" / "units_done.py").write_text("def read(run):\n    return len(run.units)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ring-64", "source": "a cycle", "file":
                            "bench/configs/ring-64.json", "reduced": [], "why": "throwaway"})
    spec["workloads"].append({"name": "ring.pairs", "config": "ring-64", "traffic": "pairs",
                              "chips": 1, "why": "throwaway"})
    spec["end_to_end"].append({"name": "units_done", "unit": "units", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["ring.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = harness.result(harness.run_cell(root, "ring.pairs", 5, 0.02, False, "cpu"))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "units_done"}
    assert line["metrics"]["units_done"]["value"] >= 1


ROWSUM_DRIVER = """
import numpy as np
import torch

from bench import harness


class inputs:
    def __init__(self, config, traffic, seed, device):
        gen = harness.seeded(seed, device)
        self.x = torch.rand((int(config["rows"]), int(config["width"])), generator=gen,
                            device=device, dtype=torch.float64)
        self.order = torch.randperm(self.x.shape[0], generator=gen, device=device).cpu().numpy()
        self.batch, self.taken = int(traffic["batch"]), 0

    def next_unit(self):
        i = self.taken % (self.order.size - self.batch)
        self.taken += self.batch
        return self.order[i:i + self.batch]


class Driver:
    def __init__(self, config, traffic, inputs, device, stages):
        with stages("upload"):
            self.x = inputs.x.clone()
        self.inputs = inputs

    def step(self, rows):
        return self.x[torch.as_tensor(rows)].sum(dim=1).cpu()

    def close(self):
        del self.x

    def memory_peak_bytes(self):
        return 3 * self.inputs.x.nbytes

    def check(self, units, samples, controls):
        x = self.inputs.x.cpu().numpy()
        gap = max(float(np.abs(out.numpy() - x[u.requests].sum(axis=1)).max())
                  for u, out in samples)
        return harness.Verdict(checks={"sum_gap": (gap, 1e-9)}, compared=len(samples),
                               failed=0, counts={"rows": np.array([u.size for u in units])})
"""


def test_a_cell_of_another_kind_is_added_as_new_files_alone(tmp_path):
    """A cell that is no traversal: its own driver (inputs from the seed,
    the plain reference and the comparison), an open loop at a fixed
    rate with Poisson arrivals, and a metric of its own, as files and
    entries alone."""
    root = small_copy(tmp_path)
    b = root / "bench"
    (b / "drivers" / "rowsum.py").write_text(ROWSUM_DRIVER)
    (b / "configs" / "rows-4k.json").write_text(json.dumps({"name": "rows-4k", "rows": 4096,
                                                           "width": 64}))
    (b / "traffic" / "open200.json").write_text(json.dumps(
        {"driver": "rowsum", "loop": "open", "rate_per_s": 200, "arrivals": "poisson",
         "batch": 32, "sample_units": 3, "warmup_units": 1, "trace_units": 1}))
    (b / "metrics" / "rows_per_s.py").write_text(
        "def read(run):\n    return run.counts['rows'].sum() / run.window_s\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rows-4k", "source": "a table", "file":
                            "bench/configs/rows-4k.json", "reduced": [], "why": "throwaway"})
    spec["workloads"].append({"name": "rows.open", "config": "rows-4k", "traffic": "open200",
                              "chips": 1, "why": "throwaway"})
    spec["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["rows.open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    run = harness.run_cell(root, "rows.open", 2**31 + 5, 0.2, False, "cpu")
    line = harness.result(run)
    assert line["correct"] is True and set(line["metrics"]) == {"setup_s", "rows_per_s"}
    assert line["checks"]["sum_gap"]["value"] <= 1e-9
    assert line["device"]["memory_peak_bytes"] == 3 * 4096 * 64 * 8
    dues = np.array([u.due for u in run.units])
    assert np.all(np.diff(dues) > 0) and dues[-1] - dues[0] < 0.2
    assert all(u.t0 >= u.due and u.t1 >= u.t0 for u in run.units)
    # about 200 a second for 0.2 s
    assert 10 <= len(run.units) <= 90


def test_traced_run_reports_per_layer_metrics_and_breakdown(tmp_path):
    root = small_copy(tmp_path)
    mix = root / "bench" / "traffic" / "bfs.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "trace_units": 2}))
    line = harness.result(harness.run_cell(root, "urand22.bfs", 3, 0.02, True, "cpu"))
    assert line["correct"] is True
    assert {"etl_s", "search_ms_p50", "sync_mb_per_search"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    """Run from a directory that holds only the benchmark: no card here (or
    no port there), so it exits with another code than 0 and prints nothing."""
    root = small_copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "bench/run.py", "--workload", "kron23.bfs",
                           "--seed", "1", "--seconds", "1"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert Path(ROOT / SPEC["command"][1]).is_file()


def test_idle_is_read_against_the_units_untraced_time():
    """The traced units' busy time is set beside their own untraced time in
    the window, not beside the traced segment, which the tracer slows."""
    from bench import trace

    cell = harness.resolve(ROOT, "kron23.bfs")
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=True, device=None)
    run.units = [harness.Unit(np.array([v]), t, t, t + 0.025) for v, t in enumerate((0.0, 1.0,
                                                                                      2.0, 3.0))]
    run.traced_units = run.units[1:3]
    run.traced = trace.Summary(busy_s=0.02, window_s=0.08, kernel_s={}, kernel_calls={},
                               device_ops=[], idle_gaps=[])
    run.counters = {"levels": 6, "sync_bytes": 10**8}

    def read(name):
        return harness.load_module(BENCH / "metrics" / f"{name}.py").read(run)

    assert read("device_idle_pct") == pytest.approx(60.0)
    assert read("idle_ms_per_level") == pytest.approx(5.0)
    assert read("device_ms_per_search") == pytest.approx(10.0)
    assert read("sync_mb_per_search") == pytest.approx(50.0)
