"""The port's spans inside its search and ETL (``repro_torch.core.tracing``):
their names and nesting on a scale-10 Kronecker graph through
``build_bfs_fn`` with ``use_kernels=True`` on the kernels' plain route, one
``loop.level`` a level, the host's blocking reads as ``.readback`` spans
and its copies to the device as ``frontier.upload`` spans,
``level_ms`` read from the ``loop.level`` span's clock points, and, with the
tracer off, nothing recorded and the same operations launched."""

import collections
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import bfs, collectives, flightrec, loop, tracing
from repro_torch.core import frontier as fr
from repro_torch.graph import csr, generators, partition
from repro_torch.kernels import bitmap_merge, blocks
from repro_torch.kernels import ops as kops

P = 4
ROOT = 5  # in the giant component of kron10's graph
PHASES = ("bfs.expand", "bfs.edge_counts", "bfs.sync", "bfs.update", "bfs.readback")
ETL = ("etl.from_edges", "etl.partition_1d", "etl.build_bfs_layout", "etl.place_arrays")


@pytest.fixture(scope="module")
def kron10():
    """The scale-10 graph's ETL, recorded: the partition, layout, placed
    arrays and the ETL's events."""
    g = generators.kronecker(10, 8, seed=1)
    tr = tracing.Tracer()
    with tracing.recording(tr):
        pg = partition.partition_1d(csr.from_edges(g.src, g.dst, g.n_real), P)
        layout = blocks.build_bfs_layout(pg)
        arrays = bfs.place_arrays(pg, layout, device="cpu")
    return pg, layout, arrays, tr.events()


def _search(kron10, recorded, **knobs):
    pg, layout, arrays, _ = kron10
    cfg = bfs.BFSConfig(use_kernels=True, fanout=2, **knobs)
    fn = bfs.build_bfs_fn(pg, cfg, layout, device="cpu")
    tr = tracing.Tracer()
    with tracing.recording(tr) if recorded else contextlib.nullcontext():
        out = fn(arrays, ROOT)
    return out, tr.events()


def _parent_names(events):
    by_id = {ev["span_id"]: ev for ev in events}
    return {ev["span_id"]: by_id[ev["parent_id"]]["name"] if ev.get("parent_id") else None
            for ev in events}


def test_etl_spans_and_their_rank_loops(kron10):
    events = kron10[3]
    parents = _parent_names(events)
    names = collections.Counter(ev["name"] for ev in events)
    assert all(names[n] == 1 for n in ETL)
    # one span a loop over the ranks, not one a rank
    assert names["etl.partition_1d.ranks"] == 2 and names["etl.build_bfs_layout.ranks"] == 6
    for ev in events:
        want = ev["name"][:-len(".ranks")] if ev["name"].endswith(".ranks") else None
        assert parents[ev["span_id"]] == want


@pytest.mark.parametrize("mode,sync", [("direction_optimizing", "butterfly"),
                                       ("top_down", "butterfly"),
                                       ("direction_optimizing", "adaptive")])
def test_search_spans_nest_by_layer(kron10, mode, sync):
    (d_owned, levels, _), events = _search(kron10, True, mode=mode, sync=sync)
    parents = _parent_names(events)
    (search,) = [ev for ev in events if ev["name"] == "bfs.search"]
    assert search["args"] == {"root": ROOT, "levels": levels} and levels > 3
    lvls = [ev for ev in events if ev["name"] == "loop.level"]
    assert [ev["args"]["index"] for ev in lvls] == list(range(levels))
    expected = {"loop.level": "bfs.search", "kernels.gather": "bfs.expand",
                "kernels.permute": "bfs.expand", "kernels.scatter": "bfs.expand",
                "sync.readback": "bfs.sync", "kernels.or_reduce": "bfs.sync",
                **{ph: "loop.level" for ph in PHASES[:-1]}}
    names = collections.Counter(ev["name"] for ev in events)
    for ev in events:
        if ev["name"] == "bfs.readback":
            assert parents[ev["span_id"]] in ("loop.level", "bfs.search")
        elif ev["name"] == "frontier.upload":
            assert parents[ev["span_id"]] in ("bfs.edge_counts", "bfs.update",
                                              "kernels.scatter")
        else:
            assert parents[ev["span_id"]] == expected.get(ev["name"]), ev["name"]
    assert all(names[ph] == levels for ph in PHASES[:-1])
    pulls = [ev["args"]["pull"] for ev in events if ev["name"] == "bfs.expand"]
    assert names["kernels.permute"] == names["kernels.scatter"] == levels
    assert names["kernels.gather"] == levels + sum(pulls)  # a pull gathers twice
    assert (mode == "top_down") == (not any(pulls))
    # the host's blocking reads: one a level and the last count, and under
    # the adaptive sync the density's read a level
    readbacks = sum(n for name, n in names.items() if name.endswith(".readback"))
    assert names["bfs.readback"] == levels + 1
    assert readbacks == levels + 1 + (levels if sync == "adaptive" else 0)
    # own()'s unpacks copy their shift table to the device: twice in the
    # edge counts, once in the update, every level
    uploads = collections.Counter(parents[ev["span_id"]] for ev in events
                                  if ev["name"] == "frontier.upload")
    assert uploads["bfs.edge_counts"] == 2 * levels and uploads["bfs.update"] == levels
    assert names["kernels.or_reduce"] > 0


@pytest.mark.parametrize("mode", ["direction_optimizing", "bottom_up"])
def test_distances_equal_with_the_tracer_off_and_on(kron10, mode):
    off, none = _search(kron10, False, mode=mode)
    on, events = _search(kron10, True, mode=mode)
    assert none == [] and events
    assert torch.equal(off[0], on[0]) and off[1:] == on[1:]


def _aten_ops(kron10, spans):
    """The ``aten::`` operations, in order, of a search under a CPU
    profiler, with the port's span sites live or replaced by no context."""
    mods = (bfs, kops, collectives, fr, bitmap_merge)
    saved = [(m, m.span) for m in mods] + [(tracing, tracing.span)]
    try:
        if not spans:
            for m, _ in saved:
                m.span = lambda *a, **k: contextlib.nullcontext()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _search(kron10, False, mode="direction_optimizing")
    finally:
        for m, fn in saved:
            m.span = fn
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    return [e.name for e in events if e.name.startswith("aten::")], \
        [e.name for e in events if e.name.startswith(("bfs.", "loop.", "kernels."))]


def test_tracer_off_launches_the_same_operations(kron10):
    assert tracing._current is tracing.NULL_TRACER
    with_spans, ranges = _aten_ops(kron10, True)
    without, none = _aten_ops(kron10, False)
    assert with_spans == without and len(with_spans) > 100
    # the profiler saw the spans as ranges of their names, the tracer off
    assert none == [] and {"bfs.search", "loop.level", "kernels.permute"} <= set(ranges)
    assert len(tracing.NULL_TRACER) == 0


def test_level_ms_comes_from_the_level_spans_clock_points(kron10):
    pg, layout, arrays, _ = kron10
    fn = bfs.build_bfs_fn(pg, bfs.BFSConfig(use_kernels=True, mode="direction_optimizing"),
                          layout, device="cpu")
    walls, tr = [], tracing.Tracer()
    with tracing.recording(tr):
        _, levels, _ = fn(arrays, ROOT, level_ms=walls)
    lvls = [ev["dur_us"] for ev in tr.events() if ev["name"] == "loop.level"]
    assert len(walls) == len(lvls) == levels
    assert np.allclose(np.array(walls) * 1e3, lvls, atol=1.0)
    # and with the tracer off, from the same span's clock
    walls = []
    fn(arrays, ROOT, level_ms=walls)
    assert len(walls) == levels and all(w > 0 for w in walls)


def test_host_while_syncs_inside_the_level_span():
    calls = []
    state = loop.host_while(lambda s: s < 3, lambda s: (calls.append(("step", s)) or s + 1, None),
                            0, level_ms=[], sync=lambda: calls.append(("sync",)))
    assert state == 3 and calls == [("step", 0), ("sync",), ("step", 1), ("sync",),
                                    ("step", 2), ("sync",)]
    tr = tracing.Tracer()
    with tracing.recording(tr):
        loop.host_while(lambda s: s < 2, lambda s: (s + 1, None), 0)
    assert [ev["args"] for ev in tr.events()] == [{"index": 0}, {"index": 1}]


def test_timed_levels_keep_their_walls(kron10):
    pg, layout, arrays, _ = kron10
    cfg = bfs.BFSConfig(use_kernels=True, mode="direction_optimizing")
    dist, trace = flightrec.timed_bfs_levels(pg, cfg, ROOT, arrays=arrays, layout=layout,
                                             device="cpu")
    assert trace.wall_ms is not None and len(trace.wall_ms) == trace.levels
