"""The traced segment: ``torch.profiler`` over a sample of the window's
units, run again after the window closed, and what the per-layer metrics
read from it.

Inside the segment each call of the port's four kernel entry points runs in
a profiler range of its own (``bench.kernel:<name>``), so that every device
operation it launched, the scatter's zero-fill included, is put to its
kernel by the launch's correlation id.  The same units are then replayed
untraced, with each kernel call's least bytes counted
(:class:`bench.roofline.Tally`).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from bench import roofline

WINDOW = "bench.traced_window"
KERNEL = "bench.kernel:"
#: The port's kernel entry points, where the layers above call them.
ENTRIES = (("repro_torch.kernels.ops", "frontier_gather_full"),
           ("repro_torch.kernels.ops", "frontier_gather"),
           ("repro_torch.kernels.ops", "frontier_scatter"),
           ("repro_torch.kernels.bitmap_merge", "bitmap_or_reduce"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def wrapped(make):
    """Inside the block each kernel entry point ``fn`` of :data:`ENTRIES` is
    ``make(name, fn)``."""
    saved = []
    try:
        for mod_name, attr in ENTRIES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, make(attr, fn))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _ranged(name, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(KERNEL + name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def counting_bytes():
    """Yields a :class:`bench.roofline.Tally` of every kernel call made
    inside the block."""
    tally = roofline.Tally()

    def make(name, fn):
        def call(*args, **kwargs):
            tally.add(name, args, kwargs)
            return fn(*args, **kwargs)
        return call

    with wrapped(make):
        yield tally


@dataclasses.dataclass
class Summary:
    """The traced segment, read from the profiler's trace (times in s)."""

    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    kernel_calls: Dict[str, int]
    device_ops: List[list]
    idle_gaps: List[list]
    kernel_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_bytes(self, tally: roofline.Tally) -> None:
        self.kernel_bytes, self.calls = dict(tally.bytes), dict(tally.calls)

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def profile(work) -> Summary:
    """Run ``work()`` (which ends in a device synchronise) under
    ``torch.profiler`` with the kernel ranges on, and read the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with wrapped(_ranged):
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                work()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        t = time.perf_counter()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    summary = summarize(events)
    print(f"trace: {len(events)} events read in {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)
    return summary


def _union(intervals):
    """Sorted disjoint union of ``(start, end)`` pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(totals: Dict[str, float]) -> List[list]:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], us / 1e6] for name, us in ranked]


def summarize(events: List[dict]) -> Summary:
    """Busy and idle time, each kernel's device time and calls, the top
    device operations and the idle gaps by what the host was doing, over
    the :data:`WINDOW` range of a Chrome trace's events (times in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    busy = _union([(a, b) for a, b in clipped if b > a])
    busy_us = sum(b - a for a, b in busy)

    # each device operation's kernel, by the range its launch sat in
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(KERNEL):])
                    for e in xs if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(KERNEL))
    starts = [r[0] for r in ranges]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernel_s: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"])
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
            name = ranges[i][2]
            kernel_s[name] = kernel_s.get(name, 0.0) + float(e["dur"]) / 1e6
    kernel_calls: Dict[str, int] = {}
    for _, _, name in ranges:
        kernel_calls[name] = kernel_calls.get(name, 0) + 1

    # idle gaps, each put to the innermost host event of the window's
    # thread open at its midpoint
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
                  and e.get("pid") == win.get("pid"))
    idle: Dict[str, float] = {}
    stack: List[tuple] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        # the window's own range: the host ran Python outside any traced op
        name = stack[-1][2] if stack and stack[-1][2] != WINDOW else "(Python, no op)"
        idle[name] = idle.get(name, 0.0) + (b - a)
    return Summary(busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6, kernel_s=kernel_s,
                   kernel_calls=kernel_calls, device_ops=_top(ops), idle_gaps=_top(idle))

