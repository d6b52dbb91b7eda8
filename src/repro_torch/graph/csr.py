"""Host-side graph container + ETL (paper Sec. 4 "Inputs"), in NumPy.

A copy of ``repro.graph.csr``: directed inputs are symmetrized, duplicate
edges and self-loops removed, and vertex counts padded to a multiple of 32
so frontier bitmaps pack into whole words and 1D partition boundaries can
sit on word boundaries.

Edges optionally carry ``uint32`` weights: symmetrization mirrors the
weight to both directions and deduplication keeps the MINIMUM over
duplicates (the shortest-path-preserving choice), so a weighted symmetric
graph always satisfies ``w(u, v) == w(v, u)``.

:func:`connected_components` returns the reference's labels but is
vectorised: the reference's per-edge Python union-find takes minutes at
Kronecker scale 23 (130 M directed edges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.tracing import span

# Bits per bitmap word, the port's one definition (the reference keeps its
# own in repro/core/frontier.py).
WORD_BITS = np.iinfo(np.uint32).bits


def _pad32(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS * WORD_BITS


class GraphValidationError(ValueError):
    """A :class:`Graph` violated a structural invariant."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise GraphValidationError(msg)


@dataclasses.dataclass
class Graph:
    """CSR graph.  ``src``/``dst`` are the COO view sorted by (src, dst);
    ``row_offsets`` indexes it as CSR.  Always deduplicated, no self-loops.
    ``weights`` (optional) is ``uint32[E]`` aligned with ``src``/``dst``."""

    n: int  # padded to a multiple of 32; trailing vertices are isolated
    n_real: int
    src: np.ndarray  # int32[E]
    dst: np.ndarray  # int32[E]
    row_offsets: np.ndarray  # int64[n + 1]
    symmetric: bool = True
    weights: Optional[np.ndarray] = None  # uint32[E] or None (unweighted)
    # set by a successful validate(); lets the partitioner skip re-checking
    _validated: bool = dataclasses.field(
        default=False, init=False, repr=False, compare=False
    )

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int32)

    @property
    def n_words(self) -> int:
        return self.n // WORD_BITS

    def neighbors(self, v: int) -> np.ndarray:
        return self.dst[self.row_offsets[v] : self.row_offsets[v + 1]]

    def neighbor_weights(self, v: int) -> np.ndarray:
        if self.weights is None:
            raise ValueError("graph is unweighted")
        return self.weights[self.row_offsets[v] : self.row_offsets[v + 1]]

    def validate(self) -> None:
        """Raise :class:`GraphValidationError` on any broken invariant."""
        _check(self.n % WORD_BITS == 0,
               f"n={self.n} is not a multiple of {WORD_BITS}")
        _check(self.n_real <= self.n,
               f"n_real={self.n_real} exceeds padded n={self.n}")
        _check(self.row_offsets.shape == (self.n + 1,),
               f"row_offsets shape {self.row_offsets.shape} != ({self.n + 1},)")
        _check(int(self.row_offsets[0]) == 0, "row_offsets must start at 0")
        _check(int(self.row_offsets[-1]) == self.n_edges,
               "row_offsets[-1] must equal the edge count")
        _check(bool(np.all(np.diff(self.row_offsets) >= 0)),
               "row_offsets must be nondecreasing")
        if self.n_edges:
            _check(self.src.min() >= 0 and self.src.max() < self.n,
                   "src vertex id out of range")
            _check(self.dst.min() >= 0 and self.dst.max() < self.n,
                   "dst vertex id out of range")
            _check(bool(np.all(self.src != self.dst)),
                   "self-loops survived ETL")
            key = (self.src.astype(np.int64) << 32) | self.dst.astype(np.int64)
            _check(bool(np.all(np.diff(key) > 0)),
                   "COO must be strictly (src, dst)-sorted and deduplicated")
        if self.weights is not None:
            _check(self.weights.shape == self.src.shape,
                   f"weights shape {self.weights.shape} != edge count "
                   f"({self.src.shape})")
            _check(self.weights.dtype == np.uint32,
                   f"weights must be uint32, got {self.weights.dtype}")
        if self.symmetric and self.n_edges:
            # the (src, dst) keys were checked sorted above, so only the
            # reversed keys need a sort
            rev = (self.dst.astype(np.int64) << 32) | self.src.astype(np.int64)
            if self.weights is None:
                _check(np.array_equal(key, np.sort(rev)), "not symmetric")
            else:
                # w(u,v) == w(v,u): each reversed edge's weight, looked up
                order = np.argsort(rev)
                _check(np.array_equal(key, rev[order]), "not symmetric")
                _check(np.array_equal(self.weights, self.weights[order]),
                       "weights are not symmetric: w(u,v) != w(v,u)")
        self._validated = True


def unique_keys(key: np.ndarray, weights: Optional[np.ndarray] = None):
    """Sorted distinct int64 edge keys, and with ``weights`` the minimum
    weight over each key's repeats (shortest-path-preserving dedup).  Sort
    and drop repeats: ``np.unique`` took 100 s at 34 M keys under numpy
    2.3, against under 1 s to sort."""
    if weights is None:
        key = np.sort(key)
    else:
        order = np.argsort(key, kind="stable")
        key, weights = key[order], weights[order]
    first = np.ones(key.size, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    if weights is not None:
        starts = np.flatnonzero(first)
        weights = np.minimum.reduceat(weights, starts) if key.size else weights[:0]
    return key[first], weights


def from_edges(
    src: np.ndarray, dst: np.ndarray, n: int, *, symmetrize: bool = True,
    weights: Optional[np.ndarray] = None,
) -> Graph:
    """ETL: (optionally) symmetrize, drop self-loops, dedup, sort, build CSR
    (an ``etl.from_edges`` span).

    ``weights`` (any integer dtype, cast to uint32) ride along: symmetrize
    mirrors them, dedup keeps the minimum over duplicate edges.
    """
    with span("etl.from_edges"):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.uint32)
            if weights.shape != src.shape:
                raise ValueError(
                    f"weights shape {weights.shape} != edges shape {src.shape}")
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if weights is not None:
                weights = np.concatenate([weights, weights])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = weights[keep]
        n_pad = max(_pad32(n), WORD_BITS)
        key, weights = unique_keys((src << 32) | dst, weights)
        src = (key >> 32).astype(np.int32)
        dst = (key & 0xFFFFFFFF).astype(np.int32)
        row_offsets = np.zeros(n_pad + 1, dtype=np.int64)
        counts = np.bincount(src, minlength=n_pad)
        row_offsets[1:] = np.cumsum(counts)
        g = Graph(
            n=n_pad, n_real=n, src=src, dst=dst, row_offsets=row_offsets,
            symmetric=symmetrize, weights=weights,
        )
        g.validate()
        return g


def with_weights(g: Graph, weights: np.ndarray) -> Graph:
    """``g`` with ``weights`` (``uint32[E]``, aligned with ``g.src``)
    attached, validated.  The generators weight their deduplicated edges
    this way: their weights are a function of the canonical endpoint pair,
    so every duplicate and both directions of an edge share one weight,
    and :func:`from_edges`'s min-dedup of the weighted input would give
    the same graph after a stable sort of every raw edge."""
    out = dataclasses.replace(g, weights=np.asarray(weights, dtype=np.uint32))
    out.validate()
    return out


def in_csr(g: Graph):
    """(in_offsets, in_src, in_dst, in_weights) — the CSC view (edges
    grouped by destination).  For symmetric graphs this equals the CSR
    with endpoints swapped.  ``in_weights`` is None for unweighted
    graphs."""
    order = np.lexsort((g.src, g.dst))
    in_src = g.src[order]
    by_dst = g.dst[order]
    in_w = g.weights[order] if g.weights is not None else None
    counts = np.bincount(by_dst, minlength=g.n)
    in_offsets = np.zeros(g.n + 1, dtype=np.int64)
    in_offsets[1:] = np.cumsum(counts)
    return in_offsets, in_src, by_dst, in_w


def largest_component_root(g: Graph, rng: np.random.Generator) -> int:
    """Pick a random root inside the largest connected component (paper
    Sec. 4 picks roots whose traversal covers the big component)."""
    return int(largest_component_roots(g, 1, rng)[0])


def largest_component_roots(
    g: Graph, count: int, rng: np.random.Generator, labels=None
) -> np.ndarray:
    """``count`` DISTINCT largest-component roots (clamped to the component
    size), so that no repeated root under-counts the work behind a rate.
    ``labels``: ``connected_components(g)`` where the caller has it."""
    comp = connected_components(g) if labels is None else labels
    largest = np.bincount(comp[: g.n_real]).argmax()
    candidates = np.flatnonzero(comp[: g.n_real] == largest)
    return rng.choice(
        candidates, size=min(count, candidates.size), replace=False
    ).astype(np.int64)


def connected_components(g: Graph) -> np.ndarray:
    """Component label of every vertex, numbered in order of each
    component's smallest vertex id (the reference's labelling).

    Vectorised union-find: every round hooks the larger of the two roots
    of each edge onto the smaller (``np.minimum.at``), then shortcuts
    every vertex to its root.  Parents only decrease, so each component
    ends rooted at its smallest vertex; a round takes O(E) NumPy work and
    few rounds are needed (4 on a scale-17 Kronecker graph).
    """
    parent = np.arange(g.n, dtype=np.int64)
    src = g.src.astype(np.int64)
    dst = g.dst.astype(np.int64)
    while True:
        pu, pv = parent[src], parent[dst]
        split = pu != pv
        if not split.any():
            break
        pu, pv = pu[split], pv[split]
        np.minimum.at(parent, np.maximum(pu, pv), np.minimum(pu, pv))
        while True:  # shortcut: point every vertex at its root
            grand = parent[parent]
            if np.array_equal(grand, parent):
                break
            parent = grand
    # every parent is now a root (parent[r] == r); number the roots in
    # increasing order
    is_root = parent == np.arange(g.n)
    return (np.cumsum(is_root) - 1)[parent]
