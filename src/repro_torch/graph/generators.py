"""Graph generators for the paper's input families (Sec. 4, Table 1).

A copy of ``repro.graph.generators`` for unweighted graphs; the same seed
gives the same graph as the reference.

* ``kronecker``  — Graph500 RMAT generator (the paper's scale-29/EF-8 claim
  uses this family; GAP_kron is the same generator at scale 27).
* ``uniform_random`` — Erdos–Renyi-ish (GAP_urand analogue).
* ``torus_2d`` / ``path_graph`` — large-diameter graphs reproducing the
  Webbase-2001 "no parallelism, synchronization dominates" regime.
* ``star_graph`` — worst-case hub for load-balance tests.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph import csr

# Graph500 RMAT probabilities.
_A, _B, _C = 0.57, 0.19, 0.19


def kronecker(
    scale: int, edge_factor: int = 8, seed: int = 0, *, symmetrize: bool = True
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
    return csr.from_edges(src, dst, n, symmetrize=symmetrize)


def uniform_random(n: int, m: int, seed: int = 0) -> csr.Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return csr.from_edges(src, dst, n)


def torus_2d(side: int) -> csr.Graph:
    """side x side wrap-around grid: diameter ~ side (high-diameter regime)."""
    ids = np.arange(side * side, dtype=np.int64).reshape(side, side)
    right = np.roll(ids, -1, axis=1)
    down = np.roll(ids, -1, axis=0)
    src = np.concatenate([ids.ravel(), ids.ravel()])
    dst = np.concatenate([right.ravel(), down.ravel()])
    return csr.from_edges(src, dst, side * side)


def path_graph(n: int) -> csr.Graph:
    """Path: the paper's Webbase 'hundred-vertex tail' pathology, distilled."""
    src = np.arange(n - 1, dtype=np.int64)
    return csr.from_edges(src, src + 1, n)


def star_graph(n: int) -> csr.Graph:
    """One hub connected to n-1 leaves (extreme degree skew)."""
    dst = np.arange(1, n, dtype=np.int64)
    src = np.zeros(n - 1, dtype=np.int64)
    return csr.from_edges(src, dst, n)
