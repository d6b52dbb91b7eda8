"""k-core decomposition as a vertex program: iterative peeling with
degree-threshold scatter waves on the OR exchange.

The port of ``repro.programs.kcore``.  An ``alive`` bitmap is replicated
on every rank; each round every rank recomputes its owned vertices'
alive-degree from its owned out-edges and proposes a PEEL WAVE — the owned
alive vertices with ``deg < k`` — as a bitmap shipped through the OR
exchange (idempotent, ``ref=None``: only nonzero peel words travel on the
sparse wire).  The wave's dense merges go through ``bitmap_or_reduce``.
Peeled vertices get core number ``k - 1``; an empty wave advances the
threshold ``k``.  Terminates when nothing is alive; every round either
peels a vertex or bumps ``k``.

Exact: the host oracle runs the same peel schedule in NumPy and matches
integer for integer (degrees count alive out-neighbors of the symmetrized
generator graphs, self-loops dropped).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.core import monoid as mono
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.programs import core


class KCoreProgram(core.VertexProgram):
    name = "kcore"
    monoid = mono.OR_U32

    def init(self, ctx, arg):
        real = torch.arange(ctx.n_rows, device=ctx.device) < ctx.n
        alive = fr.pack(real).expand(ctx.p, ctx.nw).contiguous()
        core_no = torch.zeros((ctx.p, ctx.vmax), dtype=torch.int32, device=ctx.device)
        return (alive, core_no, torch.ones((), dtype=torch.int32, device=ctx.device))

    def active(self, ctx, state, it):
        return fr.popcount(state[0][0]) > 0

    def msg_words(self, ctx) -> int:
        return ctx.nw  # the peel wave is a packed bitmap, not f32/u32 rows

    def gather(self, ctx, state, it):
        alive, _, k = state
        a = ctx.arrays
        src, dst = a["edge_src"], a["edge_dst"]
        valid = ctx.edge_mask & (src != dst)
        # owned alive-degree from owned out-edges (symmetrized graphs:
        # out-degree == degree)
        alive_dst = fr.get_bits(alive, dst) & valid
        lidx = torch.where(valid, src.long() - ctx.v_start, 0)
        deg = torch.zeros((ctx.p, ctx.vmax), dtype=torch.int32, device=alive.device)
        deg.scatter_add_(1, lidx, alive_dst.to(torch.int32))
        alive_own = fr.get_bits(alive, ctx.own_ids) & ctx.owned_mask
        peel = alive_own & (deg < k)
        msg = fr.scatter_or(ctx.nw, ctx.own_ids, peel)
        return msg, None, valid.sum(1, dtype=torch.float32)

    def apply(self, ctx, state, merged, it):
        alive, core_no, k = state
        peeled_own = fr.get_bits(merged, ctx.own_ids)
        core_no = torch.where(peeled_own, k - 1, core_no)
        # empty wave: nothing peelable below k — raise the threshold
        k = torch.where(fr.popcount(merged[0]) > 0, k, k + 1)
        return (alive & ~merged, core_no, k)

    def outputs(self, ctx, state):
        return (state[1],)

    def metrics(self, ctx, state, merged):
        # POP: vertices peeled this round; DIR: the current threshold k
        return fr.popcount(merged[0]), state[2]

    def default_max_iters(self, pg: PartitionedGraph) -> int:
        return 2 * pg.n + 64  # every round peels or bumps k (<= max deg + 1)

    def assemble(self, pg: PartitionedGraph, out) -> np.ndarray:
        return core.assemble_owned(pg, out, 0, np.int64)


def kcore_reference(g: Graph) -> np.ndarray:
    """Host peeling oracle: ``int64[n]`` core numbers via the same schedule
    the device runs (threshold sweep, alive-out-degree, self-loops
    dropped) — exact integer agreement.  The degrees are a ``bincount``
    (exact in float64 below 2^53) where the reference uses ``np.add.at``."""
    n = g.n
    src = np.repeat(np.arange(n), np.diff(g.row_offsets))
    dst = g.dst.astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    alive = np.ones(n, dtype=bool)
    cores = np.zeros(n, dtype=np.int64)
    k = 1
    while alive.any():
        deg = np.bincount(src, weights=alive[dst], minlength=n)
        peel = alive & (deg < k)
        if peel.any():
            cores[peel] = k - 1
            alive &= ~peel
        else:
            k += 1
    return cores
