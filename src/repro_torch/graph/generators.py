"""Graph generators for the paper's input families (Sec. 4, Table 1).

A copy of ``repro.graph.generators``; the same seed gives the same graph
as the reference.

* ``kronecker``  — Graph500 RMAT generator (the paper's scale-29/EF-8 claim
  uses this family; GAP_kron is the same generator at scale 27).
* ``uniform_random`` — Erdos–Renyi-ish (GAP_urand analogue).
* ``torus_2d`` / ``path_graph`` — large-diameter graphs reproducing the
  Webbase-2001 "no parallelism, synchronization dominates" regime.
* ``star_graph`` — worst-case hub for load-balance tests.

Every family accepts ``max_weight`` (0 = unweighted, the default): weights
are uniform ``uint32`` in ``[1, max_weight]`` drawn from a splitmix64 hash
of the CANONICAL endpoint pair, so ``w(u, v) == w(v, u)`` by construction
and the assignment is stable under the ETL's symmetrize/dedup (GAP
benchmark convention for weighted SSSP inputs).  A weighted graph has the
unweighted graph's edge set.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph import csr

# Graph500 RMAT probabilities.
_A, _B, _C = 0.57, 0.19, 0.19


def edge_weights(
    src: np.ndarray, dst: np.ndarray, max_weight: int, seed: int = 0
) -> np.ndarray:
    """Symmetric per-edge weights in ``[1, max_weight]`` (uint32).

    splitmix64 over the canonical (min, max) endpoint pair mixed with the
    seed — deterministic, order-independent, and identical for both
    directions of an undirected edge.
    """
    if max_weight < 1:
        raise ValueError(f"max_weight must be >= 1, got {max_weight}")
    a = np.minimum(src, dst).astype(np.uint64)
    b = np.maximum(src, dst).astype(np.uint64)
    x = (a << np.uint64(32)) | b
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15) * np.uint64(seed + 1)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(max_weight) + np.uint64(1)).astype(np.uint32)


def _etl(src, dst, n, max_weight: int, seed: int, *, symmetrize: bool = True):
    """``csr.from_edges`` on the generated edges, weighted when
    ``max_weight`` is set.  The weights are hashed from the deduplicated
    edges (``csr.with_weights``): a weight is a function of the canonical
    pair, so this is the graph ``from_edges(..., weights=edge_weights(src,
    dst))`` builds, without its argsort of every raw edge."""
    g = csr.from_edges(src, dst, n, symmetrize=symmetrize)
    if not max_weight:
        return g
    return csr.with_weights(g, edge_weights(g.src, g.dst, max_weight, seed))


def kronecker(
    scale: int, edge_factor: int = 8, seed: int = 0, *, symmetrize: bool = True,
    max_weight: int = 0,
) -> csr.Graph:
    """RMAT/Kronecker generator, vectorized over all edges at once."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = r >= (_A + _B)
        dst_bit = ((r >= _A) & (r < _A + _B)) | (r >= (_A + _B + _C))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # Graph500 permutes vertex labels to break degree-locality correlation.
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    return _etl(src, dst, n, max_weight, seed, symmetrize=symmetrize)


def uniform_random(n: int, m: int, seed: int = 0, *, max_weight: int = 0) -> csr.Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return _etl(src, dst, n, max_weight, seed)


def torus_2d(side: int, *, max_weight: int = 0, seed: int = 0) -> csr.Graph:
    """side x side wrap-around grid: diameter ~ side (high-diameter regime)."""
    ids = np.arange(side * side, dtype=np.int64).reshape(side, side)
    right = np.roll(ids, -1, axis=1)
    down = np.roll(ids, -1, axis=0)
    src = np.concatenate([ids.ravel(), ids.ravel()])
    dst = np.concatenate([right.ravel(), down.ravel()])
    return _etl(src, dst, side * side, max_weight, seed)


def path_graph(n: int, *, max_weight: int = 0, seed: int = 0) -> csr.Graph:
    """Path: the paper's Webbase 'hundred-vertex tail' pathology, distilled."""
    src = np.arange(n - 1, dtype=np.int64)
    return _etl(src, src + 1, n, max_weight, seed)


def star_graph(n: int, *, max_weight: int = 0, seed: int = 0) -> csr.Graph:
    """One hub connected to n-1 leaves (extreme degree skew)."""
    dst = np.arange(1, n, dtype=np.int64)
    src = np.zeros(n - 1, dtype=np.int64)
    return _etl(src, dst, n, max_weight, seed)
