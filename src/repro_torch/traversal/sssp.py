"""Distributed single-source shortest paths on the butterfly MIN-monoid.

The port of ``repro.traversal.sssp``: the BFS recipe (paper Alg. 2)
generalized from reachability to weighted distances, over P ranks
simulated as the leading axis of ``[P, ...]`` tensors:

* **Phase 1 — relaxation** (per rank): every owned out-edge ``(u, v, w)``
  whose source is in the active frontier proposes ``dist[u] + w`` for
  ``v``; proposals land with a scatter-MIN (the idempotent analogue of the
  BFS scatter-OR).
* **Phase 2 — distance synchronization**: the per-rank tentative distance
  buffer (uint32 words held as int32, ``n_rows`` of them) is merged across
  ranks with the ``MIN_U32`` monoid — the dense butterfly, the sparse
  changed-word exchange (``(vertex, dist)`` pairs against the post-last-sync
  distances, padded with the ``0xFFFFFFFF`` identity), density-adaptive
  dispatch between the two, the all-to-all baseline or the all-gather
  that stands for the JAX package's ``pmin``.

The frontier of CHANGED vertices is a packed bitmap; with ``delta > 0``
only changed vertices with ``dist < (bucket + 1) * delta`` are expanded
per iteration (delta-stepping-style buckets; improved vertices re-enter
the frontier, so convergence is Bellman-Ford's).  Every distance compare
is unsigned (:func:`repro_torch.core.monoid.ult`): the unreached sentinel
is ``-1`` as an int32.

The iteration loop runs on the host and reads one value per iteration (the
changed-vertex count its condition needs); the sparse and adaptive syncs
read one more, the count their branch depends on.  The MIN merges are
plain PyTorch, as the reference's are XLA ops: no kernel is on this path.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core import monoid as mono
from repro_torch.core.bfs import (device_sync, mesh_comm, place_arrays, resolve_device,
                                  resolve_mesh)
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph

#: Unreached sentinel == the MIN monoid identity (uint32 max).
UNREACHED = 0xFFFFFFFF

SYNCS = ("butterfly", "sparse", "adaptive", "all_to_all", "xla")


# ---------------------------------------------------------------------------
# Host oracle (Dijkstra)
# ---------------------------------------------------------------------------


def sssp_reference(g: Graph, root: int) -> np.ndarray:
    """Host Dijkstra — ground truth for every SSSP test.  Returns
    ``int64[n]`` distances with :data:`UNREACHED` for unreachable."""
    if g.weights is None:
        raise ValueError("sssp_reference requires a weighted graph")
    d = np.full(g.n, UNREACHED, dtype=np.int64)
    d[root] = 0
    heap = [(0, int(root))]
    offs, dst, w = g.row_offsets, g.dst, g.weights
    while heap:
        du, u = heapq.heappop(heap)
        if du > d[u]:
            continue
        for v, wv in zip(dst[offs[u] : offs[u + 1]], w[offs[u] : offs[u + 1]]):
            nd = du + int(wv)
            if nd < d[v]:
                d[v] = nd
                heapq.heappush(heap, (nd, int(v)))
    return d


# ---------------------------------------------------------------------------
# Distributed SSSP
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSSPConfig:
    """Algorithm knobs, mirroring :class:`repro_torch.core.bfs.BFSConfig`."""

    axes: Tuple[str, ...] = ("data",)  # mesh axes the syncs run over
    fanout: int = 2
    # butterfly | sparse | adaptive | all_to_all | xla
    sync: str = "butterfly"
    # bucket width of the delta-stepping-style frontier; 0 = plain
    # level-synchronous relaxation (every changed vertex expands each round)
    delta: int = 0
    max_iters: Optional[int] = None
    # --- sparse/adaptive sync knobs (shared semantics with BFSConfig) -----
    sparse_capacity: int = 0  # 0 -> auto-size to n_rows // 64 (>= 64)
    density_threshold: float = 0.02

    def __post_init__(self):
        if self.sync not in SYNCS:
            raise ValueError(f"unknown distance sync {self.sync!r}; expected one of {SYNCS}")
        if self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")

    def resolved_capacity(self, n_rows: int) -> int:
        cap = self.sparse_capacity or max(64, n_rows // 64)
        return min(cap, n_rows)


def dist_rows(pg: PartitionedGraph, *, lane_pad: int = 128) -> int:
    """Length of the exchanged distance buffer: the whole graph plus one
    rank window of slack (every rank reads its owned ``[v_start, v_start +
    vmax)`` rows without clamping), lane-padded."""
    rows = pg.n + pg.vmax
    return (rows + lane_pad - 1) // lane_pad * lane_pad


def owned_rows(pg: PartitionedGraph, device) -> torch.Tensor:
    """int64[P, vmax]: the rows of each rank's owned window."""
    return (torch.as_tensor(pg.v_start, dtype=torch.int64, device=device)[:, None]
            + torch.arange(pg.vmax, device=device))


def _sync_dist(new: torch.Tensor, prev: torch.Tensor, cfg: SSSPConfig, capacity: int,
               comm: collectives.Communicator) -> torch.Tensor:
    """Phase-2 MIN-merge of tentative distances ``new[P, n_rows]``;
    ``prev`` is the replicated-consistent post-last-sync buffer (the sparse
    reference)."""
    m, axes = mono.MIN_U32, cfg.axes
    if cfg.sync == "butterfly":
        return collectives.butterfly_reduce(new, comm, m, fanout=cfg.fanout, axes=axes)
    if cfg.sync == "sparse":
        return collectives.butterfly_reduce_sparse(new, comm, m, fanout=cfg.fanout,
                                                   capacity=capacity, ref=prev, axes=axes)
    if cfg.sync == "adaptive":
        return collectives.butterfly_reduce_adaptive(
            new, comm, m, fanout=cfg.fanout, capacity=capacity,
            density_threshold=cfg.density_threshold, ref=prev, axes=axes)
    if cfg.sync == "all_to_all":
        return collectives.all_to_all_merge(new, comm, op=m.combine, axes=axes)
    return collectives.xla_allreduce(new, comm, op="min", axes=axes)


def relax(arrays, dist: torch.Tensor, active: torch.Tensor, *, unit_weight: bool = False):
    """Phase 1: every owned out-edge of an active source proposes ``dist[u]
    + w`` for its destination, saturating to :data:`UNREACHED` where the
    uint32 sum would wrap (added in int64: ``nd < 2**32``); the proposals
    are scatter-MINed into ``dist``.  ``unit_weight`` takes every weight
    as 1 (BFS levels; the partition may be unweighted).  Returns
    ``(relaxed [P, n_rows], src_active bool[P, emax])``."""
    src, dst = arrays["edge_src"], arrays["edge_dst"]
    emask = torch.arange(src.shape[1], device=src.device) < arrays["edge_count"][:, None]
    src_active = fr.get_bits(active, src) & emask
    ds = torch.gather(dist, 1, src.long())
    w = 1 if unit_weight else arrays["edge_weight"].long() & 0xFFFFFFFF
    nd = (ds.long() & 0xFFFFFFFF) + w
    ok = src_active & (ds != mono.MIN_U32.identity_like(ds)) & (nd < 1 << 32)
    cand = torch.where(ok, nd, UNREACHED).to(torch.int32)  # the uint32 pattern
    return mono.MIN_U32.scatter_into(dist, dst, cand), src_active


def build_sssp_fn(pg: PartitionedGraph, cfg: SSSPConfig, *, device="cuda",
                  trace: bool = False, trace_levels: Optional[int] = None,
                  mesh: Optional[SimMesh] = None):
    """Distributed SSSP over ``pg``'s P simulated ranks on ``mesh``
    (:func:`~repro_torch.core.bfs.resolve_mesh`), syncing over ``cfg.axes``.

    Returns ``run(arrays, root, comm=None, *, level_ms=None)`` where
    ``arrays`` is the placed WEIGHTED partition (:func:`place_arrays`).
    Output: per-rank owned distances ``int32[P, vmax]`` (the uint32
    patterns, :data:`UNREACHED` as ``-1``), iterations executed, and edges
    relaxed (float32, as the reference counts them: the honest-TEPS
    analogue).  ``comm`` collects the sync's bytes per rank; a list
    ``level_ms`` takes each iteration's wall time.

    ``trace=True`` appends the flight-recorder buffer ``int32[trace_levels,
    TRACE_COLS]``: WORDS/SHIPPED are changed-vs-reference distance words,
    POP counts distances improved per iteration, DIR is always 0.
    """
    if not pg.weighted:
        raise ValueError(
            "SSSP requires a weighted partition — generate the graph with "
            "max_weight > 0 (graph.generators) or pass weights to from_edges")
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    p, n_rows = pg.p, dist_rows(pg)
    capacity = cfg.resolved_capacity(n_rows)
    # bucket advances consume iterations without relaxing; bound generously
    max_iters = cfg.max_iters if cfg.max_iters is not None else 1 << 30
    own = owned_rows(pg, dev)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_iters)

    def run(arrays, root: int, comm: Optional[collectives.Communicator] = None, *,
            level_ms: Optional[list] = None):
        root = int(root)
        if not 0 <= root < pg.n:
            raise ValueError(f"root {root} outside [0, {pg.n})")
        comm = mesh_comm(comm, mesh, dev)
        dist = torch.full((p, n_rows), -1, dtype=torch.int32, device=dev)
        dist[:, root] = 0
        changed = fr.set_bit(torch.zeros((p, n_rows // fr.WORD_BITS), dtype=torch.int32,
                                         device=dev), root)
        bucket = torch.zeros((), dtype=torch.int64, device=dev)

        def cond(s):
            return s[5] > 0 and s[3] < max_iters

        def step(s):
            dist, changed, bucket, it, relaxed, _ = s
            # -- bucket frontier selection (delta-stepping-style)
            if cfg.delta:
                limit = (bucket + 1) * cfg.delta
                below = (dist.long() & 0xFFFFFFFF) < limit
                active = fr.pack(fr.unpack(changed) & below)
                # nothing below the bucket limit: advance the bucket and run
                # an (empty) round — dist/changed are untouched
                bucket = torch.where(fr.popcount(active[0]) > 0, bucket, bucket + 1)
            else:
                active = changed
            # -- Phase 1: relax owned out-edges of active sources
            relaxed_local, src_active = relax(arrays, dist, active)
            # -- Phase 2: MIN synchronization
            if trace:
                stats = flightrec.monoid_sync_stats(relaxed_local, dist, cfg, capacity)
            synced = _sync_dist(relaxed_local, dist, cfg, capacity, comm)
            # -- changed-vertex frontier update
            improved = fr.pack(mono.ult(synced, dist))
            changed = (changed & ~active) | improved
            relaxed = relaxed + src_active.sum(1, dtype=torch.float32)
            n_changed = int(fr.popcount(changed[0]))
            out = (synced, changed, bucket, it + 1, relaxed, n_changed)
            if not trace:
                return out, None
            row = flightrec.trace_row(it, stats[0], fr.popcount(improved[0]), 0, stats[1],
                                      stats[2], fr.changed_count(synced[0], dist[0]))
            return out, (it, row)

        init = (dist, changed, bucket, 0, torch.zeros(p, dtype=torch.float32, device=dev), 1)
        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        s = loop.host_while(cond, step, init, trace_buffer=tbuf, level_ms=level_ms,
                            sync=device_sync(dev))
        out = (torch.gather(s[0], 1, own), s[3], float(s[4].sum()))
        return out + (tbuf,) if trace else out

    return run


def assemble_distances(pg: PartitionedGraph, d_owned: torch.Tensor) -> np.ndarray:
    """``d_owned [P, vmax]`` -> global ``int64[n]`` (:data:`UNREACHED`
    sentinel preserved)."""
    d_owned = d_owned.cpu().numpy().view(np.uint32)
    dist = np.full(pg.n, UNREACHED, dtype=np.int64)
    for i in range(pg.p):
        s, c = int(pg.v_start[i]), int(pg.v_count[i])
        dist[s : s + c] = d_owned[i, :c]
    return dist


def distributed_sssp(pg: PartitionedGraph, root: int, cfg: SSSPConfig = SSSPConfig(),
                     *, device="cuda", mesh: Optional[SimMesh] = None
                     ) -> Tuple[np.ndarray, int, float]:
    """End-to-end helper: place arrays, run, assemble global distances."""
    dev = resolve_device(device)
    d_owned, iters, relaxed = build_sssp_fn(pg, cfg, device=dev, mesh=mesh)(
        place_arrays(pg, device=dev), root)
    return assemble_distances(pg, d_owned), iters, relaxed
