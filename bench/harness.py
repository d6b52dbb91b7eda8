"""One run of one cell: the driver's inputs from the seed, its set-up and
warm-up, the measured window, the traced segment, the driver's check, and
the result line.

The harness only runs set-up, times units and collects readings.  What a
cell does sits in files found by the names in ``BENCHMARK.json``:

- ``drivers/<traffic's "driver">.py``: ``inputs(config, traffic, seed,
  device)`` makes the cell's inputs from the seed and hands out the
  window's units (``inputs.next_unit()``, a sequence of requests);
  ``Driver(config, traffic, inputs, device, stages)`` sets the port up,
  ``step(unit)`` sends one unit through the timed path and waits for the
  device, ``replay(units)`` (optional) runs units again untraced and
  returns the port's counters, ``close()`` frees the port's state, and
  ``check(units, samples, controls)`` builds the plain reference from the
  inputs, judges the sampled outputs and counts each unit's work
  (a :class:`Verdict`); a driver that runs ranks in processes of its own
  reports the fullest card's peak by ``memory_peak_bytes()``;
- ``loops/<traffic's "loop", "closed" by default>.py``: ``window(...)``
  dispatches the units and times each from when it was due.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    """The Python file ``path``, loaded by its path (a name may hold ``.``
    or ``-``)."""
    name = "bench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    driver: Any
    loop: Any
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(root: Path, workload: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``: its
    configuration and traffic files, its driver and loop modules, and the
    metrics it reports."""
    root = Path(root)
    spec = load_spec(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    bench = root / spec["paths"][0]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                driver=load_module(bench / "drivers" / f"{traffic['driver']}.py"),
                loop=load_module(bench / "loops" / f"{traffic.get('loop', 'closed')}.py"),
                end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]),
                bench=bench)


def device_sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stages(dict):
    """Seconds of each named set-up stage, by the host's clock, each ended
    by a device synchronise: ``with stages("name"): ...``."""

    def __init__(self, dev: torch.device):
        super().__init__()
        self.dev = dev

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        yield
        device_sync(self.dev)
        self[name] = self.get(name, 0.0) + time.perf_counter() - t


def seeded(seed: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


@dataclasses.dataclass
class Unit:
    """One unit of the window: its requests, and the host clock when it was
    due, when it was sent and after the device finished."""

    requests: Sequence
    due: float
    t0: float
    t1: float

    @property
    def size(self) -> int:
        return len(self.requests)


@dataclasses.dataclass
class Verdict:
    """A driver's check: each number compared with its limit, the requests
    compared and those found wrong, each unit's work by name (an array a
    unit), and the control's reading where it ran."""

    checks: Dict[str, tuple]
    compared: int
    failed: int
    counts: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    control: Optional[int] = None


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    device_kind: str = ""
    inputs_s: float = 0.0
    etl: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    units: List[Unit] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    traced: Optional[object] = None  # bench.trace.Summary of the traced segment
    traced_units: List[Unit] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)  # the replay's
    verdict: Optional[Verdict] = None

    @property
    def window_s(self) -> float:
        """From when the first unit was due to when the last finished."""
        return self.units[-1].t1 - self.units[0].due

    def request_ms(self) -> np.ndarray:
        """Every request's time in ms: its unit's, from when it was due to
        the synchronise that ends it."""
        return np.array([(u.t1 - u.due) * 1e3 for u in self.units for _ in range(u.size)])

    def traced_untraced_s(self) -> float:
        """The window's own time (untraced) of the units the traced segment
        ran again."""
        return sum(u.t1 - u.t0 for u in self.traced_units)

    @property
    def traced_requests(self) -> int:
        return sum(u.size for u in self.traced_units)

    @property
    def attempted(self) -> int:
        return sum(u.size for u in self.units)

    @property
    def checks(self) -> Dict[str, tuple]:
        return self.verdict.checks

    @property
    def counts(self) -> Dict[str, np.ndarray]:
        return self.verdict.counts

    @property
    def compared(self) -> int:
        return self.verdict.compared

    @property
    def failed(self) -> int:
        return self.verdict.failed

    @property
    def control(self) -> Optional[int]:
        return self.verdict.control

    @property
    def correct(self) -> bool:
        return (self.compared > 0 and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", *, t_start: Optional[float] = None, control: bool = False,
             spec: Optional[dict] = None) -> Run:
    """Run ``workload`` once and return what it measured.  ``t_start`` is
    the host clock at process start (set-up is timed from it);
    ``control`` also runs the driver's control on the sampled units and
    judges it."""
    from bench import trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(root, workload, spec)
    dev = torch.device(device)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=dev,
              device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    t = time.perf_counter()
    inputs = cell.driver.inputs(cell.config, cell.traffic, seed, dev)
    device_sync(dev)
    run.inputs_s = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    stages = Stages(dev)
    driver = cell.driver.Driver(cell.config, cell.traffic, inputs, dev, stages)
    run.etl = dict(stages)
    for _ in range(int(cell.traffic.get("warmup_units", 1))):
        driver.step(inputs.next_unit())
    device_sync(dev)
    run.setup_s = time.perf_counter() - t_start

    samples = Reservoir(int(cell.traffic["sample_units"]), np.random.default_rng(seed))
    run.units = cell.loop.window(driver.step, inputs.next_unit, seconds,
                                 lambda unit, out: samples.offer((unit, out)), cell.traffic,
                                 np.random.default_rng([seed, 1]))

    if trace:
        # units of the window run again under the profiler, so that the
        # device's busy time is set beside their own untraced time
        k = min(int(cell.traffic["trace_units"]), len(run.units))
        pick = np.random.default_rng([seed, 2]).choice(len(run.units), size=k, replace=False)
        run.traced_units = [run.units[i] for i in sorted(pick)]
        requests = [u.requests for u in run.traced_units]
        run.traced = trace_mod.profile(lambda: [driver.step(r) for r in requests])
        if hasattr(driver, "replay"):
            with trace_mod.counting_bytes() as tally:
                run.counters = driver.replay(requests)
            run.traced.add_bytes(tally)
    controls = [driver.control(u.requests, out) for u, out in samples.items] if control else None
    if hasattr(driver, "memory_peak_bytes"):  # a driver that runs ranks in other processes
        run.memory_peak_bytes = int(driver.memory_peak_bytes())
    elif dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    driver.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    run.verdict = driver.check(run.units, samples.items, controls)
    log(f"check: {run.compared} requests of {run.attempted} compared with the reference "
        f"in {time.perf_counter() - t:.1f} s")
    return run


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics(run: Run) -> Dict[str, dict]:
    """Each metric of the run's kind that the cell reports and whose reader
    finds something to read."""
    out = {}
    for m in run.cell.metrics(run.trace):
        value = load_module(run.cell.bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run) -> dict:
    """The result line's object; ``checks`` comes last."""
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": run.device_kind,
              "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics(run), "device": device}
    if run.trace:
        device.update(busy_s=run.traced.busy_s, window_s=run.traced.window_s)
        line["breakdown"] = run.traced.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line
