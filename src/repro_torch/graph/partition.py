"""1D edge-balanced partitioning (paper Sec. 4 "Graph Partitioning").

A copy of ``repro.graph.partition``, in NumPy.
Vertices are split into contiguous ranges of near-equal edge counts, with
boundaries rounded to multiples of 32 so each rank's owned range is a
whole number of bitmap words; per-rank edge arrays are padded to a common
shape and stacked into ``[P, emax]``, the simulated-rank axis the torch
traversal runs over.

Out-edges are kept sorted by (src, dst) and in-edges by (dst, src).  A
weighted graph's ``uint32`` weights are partitioned alongside (``edge_weight``
with the out-edges, ``in_weight`` with the in-edges).

:func:`synthetic_shapes` sizes a partition from ``(n, m, P)`` alone, with
no graph built: an upper bound of what :func:`partition_1d` gives a
Kronecker graph of that size, for planning memory and shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.tracing import span
from repro_torch.graph import csr
from repro_torch.graph.csr import WORD_BITS

#: The scalar fields of :class:`PartitionedGraph`; the rest are arrays.
SCALARS = ("p", "n", "n_words", "n_edges", "vmax", "emax", "wmax")
#: The weight planes, present together on weighted partitions only.
WEIGHT_KEYS = ("edge_weight", "in_weight")


@dataclasses.dataclass
class PartitionedGraph:
    """Static-shape, rank-stacked view of a 1D-partitioned graph."""

    p: int
    n: int  # global vertex count (multiple of 32)
    n_words: int  # bitmap words EXCHANGED (includes slack, multiple of 128)
    n_edges: int  # global directed edge count
    vmax: int  # max owned vertices per rank
    emax: int  # max owned edges per rank (same pad for out and in)
    v_start: np.ndarray  # int32[P]
    v_count: np.ndarray  # int32[P]
    word_start: np.ndarray  # int32[P] == v_start // 32
    wmax: int  # max owned bitmap words per rank
    edge_src: np.ndarray  # int32[P, emax]   out-edges, sorted by (src, dst)
    edge_dst: np.ndarray  # int32[P, emax]
    edge_count: np.ndarray  # int32[P]
    in_src: np.ndarray  # int32[P, emax]   in-edges, sorted by (dst, src)
    in_dst: np.ndarray  # int32[P, emax]
    in_count: np.ndarray  # int32[P]
    deg_out: np.ndarray  # int32[P, vmax]  out-degree of owned vertices
    # uint32[P, emax] edge weights, partitioned alongside dst (out view) and
    # src (in view); None for unweighted graphs
    edge_weight: Optional[np.ndarray] = None
    in_weight: Optional[np.ndarray] = None

    @property
    def weighted(self) -> bool:
        return self.edge_weight is not None

    def owner_of(self, v: int) -> int:
        return int(np.searchsorted(self.v_start, v, side="right") - 1)

    def scalars(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in SCALARS}

    def arrays(self) -> Dict[str, np.ndarray]:
        """The ``[P, ...]`` planes handed to the traversal.  Weighted
        partitions add ``edge_weight``/``in_weight``."""
        out = dict(
            v_start=self.v_start,
            v_count=self.v_count,
            word_start=self.word_start,
            edge_src=self.edge_src,
            edge_dst=self.edge_dst,
            edge_count=self.edge_count,
            in_src=self.in_src,
            in_dst=self.in_dst,
            in_count=self.in_count,
            deg_out=self.deg_out,
        )
        if self.edge_weight is not None:
            out["edge_weight"] = self.edge_weight
            out["in_weight"] = self.in_weight
        return out


def from_reference(scalars: dict, arrays: Dict[str, np.ndarray]) -> PartitionedGraph:
    """Build the port's :class:`PartitionedGraph` from the JAX package's
    state: its scalars (``p``, ``n``, ...) and its ``pg.arrays()``.

    Carries one partition across the two packages so that both traverse
    identical state; a weighted partition's ``edge_weight``/``in_weight``
    stay ``uint32``.
    """
    if set(scalars) != set(SCALARS):
        raise ValueError(f"scalars must have exactly the keys {SCALARS}, "
                         f"got {sorted(scalars)}")
    keys = {f.name for f in dataclasses.fields(PartitionedGraph)} - set(SCALARS)
    if set(arrays) not in (keys - set(WEIGHT_KEYS), keys):
        raise ValueError(f"arrays must have exactly the keys {sorted(keys)} "
                         f"(the weights optional, together), got {sorted(arrays)}")
    return PartitionedGraph(
        **{k: int(v) for k, v in scalars.items()},
        **{k: np.array(v, dtype=np.uint32 if k in WEIGHT_KEYS else np.int32)
           for k, v in arrays.items()},
    )


def _round32(x: int) -> int:
    return (x + WORD_BITS - 1) // WORD_BITS * WORD_BITS


@dataclasses.dataclass(frozen=True)
class SyntheticShapes:
    """Shape-only stand-in for :class:`PartitionedGraph`: the sizes a 1D
    partition of a graph of ``n`` vertices and ``n_edges`` directed edges
    over ``p`` ranks takes, with no graph built.

    Sizing rules (the reference's): edges are 1D-balanced with 15 % slack;
    a Kronecker partition can own up to ~4x the mean vertex count (degree
    skew pushes edge-balanced cuts off the uniform grid), hence ``vmax = 4
    * n / p``; vertex counts round to 32 (bitmap words), edge and word
    counts to 128 lanes.
    """

    p: int
    n: int
    n_edges: int
    n_words: int
    vmax: int
    emax: int
    wmax: int

    def array_shapes(self) -> dict:
        """The shape of each plane of :meth:`PartitionedGraph.arrays`."""
        p, emax, vmax = self.p, self.emax, self.vmax
        return dict(
            v_start=(p,),
            v_count=(p,),
            word_start=(p,),
            edge_src=(p, emax),
            edge_dst=(p, emax),
            edge_count=(p,),
            in_src=(p, emax),
            in_dst=(p, emax),
            in_count=(p,),
            deg_out=(p, vmax),
        )


def synthetic_shapes(n: int, m_directed: int, p: int, *, lane_pad: int = 128,
                     slack: float = 1.15, vskew: float = 4.0) -> SyntheticShapes:
    """:class:`SyntheticShapes` of ``n`` vertices and ``m_directed`` edges
    over ``p`` ranks."""
    n_pad = _round32(n)
    emax = int(m_directed / p * slack)
    emax = (emax + lane_pad - 1) // lane_pad * lane_pad
    vmax = _round32(int(n_pad / p * vskew))
    wmax = vmax // WORD_BITS
    n_words = n_pad // WORD_BITS + wmax
    n_words = (n_words + lane_pad - 1) // lane_pad * lane_pad
    return SyntheticShapes(p=p, n=n_pad, n_edges=m_directed, n_words=n_words,
                           vmax=vmax, emax=emax, wmax=wmax)


def partition_1d(g: csr.Graph, p: int, *, lane_pad: int = 128) -> PartitionedGraph:
    """Split vertices into ``p`` contiguous ranges with near-equal edges (an
    ``etl.partition_1d`` span; its loops over the ranks each an
    ``etl.partition_1d.ranks`` span)."""
    with span("etl.partition_1d"):
        if not g._validated:  # corrupt inputs fail here, not as wrong traversals
            g.validate()
        cum = g.row_offsets  # int64[n+1], cumulative out-degree
        bounds: List[int] = [0]
        with span("etl.partition_1d.ranks"):
            for i in range(1, p):
                target = g.n_edges * i // p
                b = int(np.searchsorted(cum, target, side="left"))
                b = min(max(_round32(b), bounds[-1]), g.n)
                bounds.append(b)
        bounds.append(g.n)
        v_start = np.array(bounds[:-1], dtype=np.int32)
        v_end = np.array(bounds[1:], dtype=np.int32)
        v_count = v_end - v_start

        # --- out-edges per rank (already sorted by (src, dst) globally)
        e_lo = cum[v_start]
        e_hi = cum[v_end]
        edge_count = (e_hi - e_lo).astype(np.int32)

        # --- in-edges per rank (CSC view, grouped by destination)
        in_offsets, in_src_all, in_dst_all, in_w_all = csr.in_csr(g)
        ie_lo = in_offsets[v_start]
        ie_hi = in_offsets[v_end]
        in_count = (ie_hi - ie_lo).astype(np.int32)

        emax = int(max(1, max(edge_count.max(initial=0), in_count.max(initial=0))))
        emax = (emax + lane_pad - 1) // lane_pad * lane_pad
        vmax = int(max(WORD_BITS, v_count.max(initial=0)))
        vmax = _round32(vmax)
        wmax = vmax // WORD_BITS

        edge_src = np.zeros((p, emax), dtype=np.int32)
        edge_dst = np.zeros((p, emax), dtype=np.int32)
        in_src = np.zeros((p, emax), dtype=np.int32)
        in_dst = np.zeros((p, emax), dtype=np.int32)
        deg_out = np.zeros((p, vmax), dtype=np.int32)
        edge_weight = np.zeros((p, emax), dtype=np.uint32) if g.weighted else None
        in_weight = np.zeros((p, emax), dtype=np.uint32) if g.weighted else None
        degrees = g.out_degree
        with span("etl.partition_1d.ranks"):
            for i in range(p):
                s, e = int(e_lo[i]), int(e_hi[i])
                edge_src[i, : e - s] = g.src[s:e]
                edge_dst[i, : e - s] = g.dst[s:e]
                if g.weighted:
                    edge_weight[i, : e - s] = g.weights[s:e]
                s, e = int(ie_lo[i]), int(ie_hi[i])
                in_src[i, : e - s] = in_src_all[s:e]
                in_dst[i, : e - s] = in_dst_all[s:e]
                if g.weighted:
                    in_weight[i, : e - s] = in_w_all[s:e]
                deg_out[i, : v_count[i]] = degrees[v_start[i] : v_end[i]]

        # Exchanged bitmap length: whole graph + one rank window of slack so
        # every rank can slice its aligned [word_start, word_start+wmax)
        # window without clamping; padded to the 128-word boundary.
        n_words = g.n // WORD_BITS + wmax
        n_words = (n_words + lane_pad - 1) // lane_pad * lane_pad

        return PartitionedGraph(
            p=p,
            n=g.n,
            n_words=n_words,
            n_edges=g.n_edges,
            vmax=vmax,
            emax=emax,
            v_start=v_start,
            v_count=v_count,
            word_start=(v_start // WORD_BITS).astype(np.int32),
            wmax=wmax,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_count=edge_count,
            in_src=in_src,
            in_dst=in_dst,
            in_count=in_count,
            deg_out=deg_out,
            edge_weight=edge_weight,
            in_weight=in_weight,
        )
