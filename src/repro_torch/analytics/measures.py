"""Whole-graph analytics on MS-BFS wave outputs (DESIGN.md §13).

The port of ``repro.analytics.measures``: the measures are host NumPy as
in the reference; ``connected_components`` drives the port's query engine
on ``device`` (where the reference takes a mesh).

Distributed BFS is the building block for graph analytics (Buluç &
Madduri); every measure here consumes the ``int64[B, n]`` distance matrices
produced by :mod:`repro_torch.analytics.msbfs` / the query engine — the traversal
stays on-device and bit-parallel, the reductions are cheap host-side numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.bfs import BFSConfig
from repro_torch.graph.partition import PartitionedGraph

INF32 = np.iinfo(np.int32).max


def reachability_counts(dist: np.ndarray) -> np.ndarray:
    """Vertices reached per search lane (root included): ``int64[B]``."""
    dist = np.asarray(dist)
    return (dist < INF32).sum(axis=1)


def closeness_centrality(
    dist: np.ndarray, *, n: Optional[int] = None, wf_improved: bool = True
) -> np.ndarray:
    """Closeness of each wave root from its distance row: ``float64[B]``.

    ``c(u) = (r - 1) / sum_d`` over the ``r`` reached vertices; with
    ``wf_improved`` the Wasserman–Faust factor ``(r - 1)/(n - 1)`` scales by
    the reachable fraction so scores compare across components (``n``
    defaults to the row width — pass the un-padded vertex count to exclude
    bitmap padding).  Roots reaching nothing score 0.
    """
    dist = np.asarray(dist)
    if n is None:
        n = dist.shape[1]
    finite = dist < INF32
    r = finite.sum(axis=1)
    sum_d = np.where(finite, dist, 0).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(sum_d > 0, (r - 1) / np.maximum(sum_d, 1), 0.0)
        if wf_improved and n > 1:
            c = c * (r - 1) / (n - 1)
    return c.astype(np.float64)


def connected_components(
    pg: PartitionedGraph,
    cfg: BFSConfig = BFSConfig(),
    *,
    lanes: int = 32,
    engine=None,
    device="cuda",
) -> np.ndarray:
    """Component labels via lane-seeded wave propagation: ``int64[n]``.

    Each round seeds one MS-BFS wave with up to ``lanes`` still-unlabeled
    vertices; every vertex a lane reaches joins that seed's component (label
    = seed vertex id, smallest seed winning ties — on the undirected graphs
    the ETL produces, reachability IS the component relation, and the
    butterfly OR of the wave is the label-propagation step).  Rounds repeat
    until no vertex is unlabeled: ``ceil(#components / lanes)`` waves total,
    so B lanes cut the sync rounds per graph by ~B over one-seed flooding.
    """
    if engine is None:
        from repro_torch.analytics.engine import BFSQueryEngine

        engine = BFSQueryEngine(pg, cfg, lanes=lanes, device=device)
    labels = np.full(pg.n, -1, dtype=np.int64)
    while True:
        unlabeled = np.flatnonzero(labels < 0)
        if unlabeled.size == 0:
            return labels
        seeds = unlabeled[: engine.lanes]
        dist = engine.query(seeds)
        for b, s in enumerate(seeds):  # ascending seeds: smallest wins
            reached = (dist[b] < INF32) & (labels < 0)
            labels[reached] = s
