"""Label-propagation connected components as a vertex program.

The port of ``repro.programs.cc``.  Min-label propagation over the
``MIN_U32`` exchange: every vertex starts as its own label (its id), each
round CHANGED vertices push their label to both endpoints of every
incident owned edge (both directions, so weak connectivity holds on
directed inputs), and the sparse exchange ships only changed-vs-previous
label words (**remerge** mode — MIN is idempotent).  Converged labels are
the minimum vertex id of each weakly-connected component — exact, so the
host oracle (union-find) matches bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.core import monoid as mono
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.programs import core

#: Pad-row label == the MIN identity (never a real vertex id).
NO_LABEL = 0xFFFFFFFF


class ConnectedComponentsProgram(core.VertexProgram):
    name = "cc"
    monoid = mono.MIN_U32

    def init(self, ctx, arg):
        # arg: replicated uint32[n_rows] initial labels (int32 patterns);
        # every real vertex starts changed — round 1 pushes ids
        labels = arg.to(ctx.device).expand(ctx.p, ctx.n_rows).contiguous()
        real = torch.arange(ctx.n_rows, device=ctx.device) < ctx.n
        return (labels, fr.pack(real).expand(ctx.p, ctx.nw).contiguous())

    def active(self, ctx, state, it):
        return fr.popcount(state[1][0]) > 0

    def gather(self, ctx, state, it):
        labels, changed = state
        a = ctx.arrays
        src, dst = a["edge_src"], a["edge_dst"]
        emask = ctx.edge_mask
        # both directions from the owned edge list (labels are replicated,
        # so the owner of u can propose v -> u without owning v)
        src_on = fr.get_bits(changed, src) & emask
        dst_on = fr.get_bits(changed, dst) & emask
        fwd = torch.where(src_on, torch.gather(labels, 1, src.long()), -1)
        bwd = torch.where(dst_on, torch.gather(labels, 1, dst.long()), -1)
        # msg starts AT the reference and only improves: the remerge
        # monotonicity contract (msg == combine(msg, ref)) by construction
        msg = self.monoid.scatter_into(labels, dst, fwd)
        msg = self.monoid.scatter_into(msg, src, bwd)
        work = src_on.sum(1, dtype=torch.float32) + dst_on.sum(1, dtype=torch.float32)
        return msg, labels, work

    def apply(self, ctx, state, merged, it):
        return (merged, fr.pack(mono.ult(merged, state[0])))

    def outputs(self, ctx, state):
        return (ctx.owned_slice(state[0]),)

    def metrics(self, ctx, state, merged):
        # POP: labels changed this round (the convergence column)
        return fr.popcount(state[1][0]), 0

    def default_max_iters(self, pg: PartitionedGraph) -> int:
        return pg.n + 1  # min-label propagation worst case (a path)

    def default_arg(self, pg: PartitionedGraph, device="cuda"):
        return identity_labels(pg, device)

    def assemble(self, pg: PartitionedGraph, out) -> np.ndarray:
        return core.assemble_owned(pg, out.cpu().numpy().view(np.uint32), NO_LABEL,
                                   np.int64)


def identity_labels(pg: PartitionedGraph, device="cuda") -> torch.Tensor:
    """Cold-start labels: each real vertex its own id, pad rows the MIN
    identity (they never propose — no edges touch them); int32 patterns."""
    rows = torch.arange(core.program_rows(pg), dtype=torch.int32,
                        device=core.resolve_device(device))
    return torch.where(rows < pg.n, rows, -1)


def cc_reference(g: Graph) -> np.ndarray:
    """Host union-find oracle: ``int64[n]``, each vertex labelled with the
    minimum vertex id of its weakly-connected component — the exact fixed
    point of min-label propagation."""
    parent = np.arange(g.n, dtype=np.int64)

    def find(v):
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:
            parent[v], v = root, parent[v]
        return root

    src = np.repeat(np.arange(g.n), np.diff(g.row_offsets))
    for u, v in zip(src.tolist(), g.dst.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            # union by min root keeps every root the component minimum
            if ru < rv:
                parent[rv] = ru
            else:
                parent[ru] = rv
    return np.array([find(v) for v in range(g.n)], dtype=np.int64)
