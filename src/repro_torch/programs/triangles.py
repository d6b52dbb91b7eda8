"""Triangle counting as a vertex program: one OR-exchange round builds the
replicated neighbor bitmaps, then owned-edge wedge checks finish locally.

The port of ``repro.programs.triangles``.

* **gather (round 0)** — each rank scatter-ORs its owned out-edges into a
  flat row-major adjacency bitmap (row ``u`` = ``n_rows`` bits, bit ``v``
  set iff edge ``(u, v)``; self-loops dropped).  The OR merge, through
  ``bitmap_or_reduce``, replicates the FULL adjacency — the one
  collective of the whole count.
* **apply** — for every owned edge ``(u, v)``, the wedge count
  ``|N(u) & N(v)|`` is a word AND + popcount of the two merged rows;
  accumulated at ``u``, every triangle lands exactly twice on each corner,
  so ``tri(v) = acc(v) / 2`` and the global count is ``sum(acc) / 6``.

Edges are partitioned by source, so each vertex's wedge accumulator is
complete on its owner.  The bitmap is ``n_rows^2`` bits replicated per
rank; :meth:`TriangleCountProgram.msg_words` keeps the reference's refusal
of graphs whose flat bit index would overflow int32, though the port
indexes in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.core import monoid as mono
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.programs import core

#: Largest replicated-bitmap side whose flat bit index fits int32.
MAX_ROWS = 46340  # floor(sqrt(2^31))

#: Words of the two gathered rows a wedge-count chunk may hold, per rank.
_CHUNK_WORDS = 1 << 22


class TriangleCountProgram(core.VertexProgram):
    name = "tri"
    monoid = mono.OR_U32

    def msg_words(self, ctx) -> int:
        if ctx.n_rows > MAX_ROWS:
            raise ValueError(
                f"triangle program needs n_rows^2 bits addressable by "
                f"int32: n_rows={ctx.n_rows} > {MAX_ROWS}")
        return ctx.n_rows * (ctx.n_rows // fr.WORD_BITS)

    def init(self, ctx, arg):
        return (torch.zeros((ctx.p, ctx.vmax), dtype=torch.int32, device=ctx.device),)

    def active(self, ctx, state, it):
        return it < 1  # one exchange round; counting is local

    def gather(self, ctx, state, it):
        a = ctx.arrays
        src, dst = a["edge_src"].long(), a["edge_dst"].long()
        valid = ctx.edge_mask & (src != dst)
        # flat bit index: row-major (u, v) -> u * n_rows + v
        adj = fr.scatter_or(self.msg_words(ctx), src * ctx.n_rows + dst, valid)
        return adj, None, valid.sum(1, dtype=torch.float32)

    def apply(self, ctx, state, merged, it):
        a = ctx.arrays
        src, dst = a["edge_src"].long(), a["edge_dst"].long()
        valid = ctx.edge_mask & (src != dst)
        rw = ctx.n_rows // fr.WORD_BITS
        adjm = merged.reshape(ctx.p, ctx.n_rows, rw)
        ranks = torch.arange(ctx.p, device=merged.device)[:, None]
        chunk = max(1, _CHUNK_WORDS // rw)
        common = torch.cat([
            fr.popcount(adjm[ranks, src[:, c : c + chunk]]
                        & adjm[ranks, dst[:, c : c + chunk]], dim=-1)
            for c in range(0, src.shape[1], chunk)], dim=1)
        lidx = torch.where(valid, src - ctx.v_start, 0)
        acc = torch.zeros_like(state[0]).scatter_add_(
            1, lidx, torch.where(valid, common, 0).to(torch.int32))
        return (state[0] + acc,)

    def outputs(self, ctx, state):
        return (state[0],)

    def metrics(self, ctx, state, merged):
        # POP: wedge hits accumulated this round, over every rank
        return state[0].sum(dtype=torch.int32), 0

    def default_max_iters(self, pg: PartitionedGraph) -> int:
        return 1

    def assemble(self, pg: PartitionedGraph, out) -> np.ndarray:
        """Per-vertex triangle counts ``int64[n]`` (each corner's incident
        triangles); the wedge accumulator lands twice per triangle corner."""
        return core.assemble_owned(pg, out, 0, np.int64) // 2


def total_triangles(per_vertex: np.ndarray) -> int:
    """Global triangle count from :meth:`assemble`'s per-vertex counts
    (every triangle has three corners)."""
    return int(per_vertex.sum() // 3)


def triangles_reference(g: Graph) -> np.ndarray:
    """Host oracle: per-vertex triangle counts ``int64[n]`` with the
    reference's wedge semantics — neighbor SETS (self-loops dropped)
    intersected along every directed edge, halved per corner.  Vectorised
    with a sparse product where the reference loops over Python sets: for
    the 0/1 adjacency ``A`` (row ``u`` the out-neighbors of ``u``), the
    wedge hits at ``u`` are ``sum_v A[u, v] * (A @ A.T)[u, v]``."""
    import scipy.sparse as sp

    n = g.n
    src = np.repeat(np.arange(n), np.diff(g.row_offsets))
    keep = src != g.dst
    a = sp.csr_matrix((np.ones(int(keep.sum()), dtype=np.int64),
                       (src[keep], g.dst[keep].astype(np.int64))), shape=(n, n))
    a.data[:] = 1  # sets: a repeated edge counts once
    acc = np.asarray(a.multiply(a @ a.T).sum(axis=1)).ravel().astype(np.int64)
    return acc // 2
