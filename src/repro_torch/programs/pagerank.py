"""PageRank as a vertex program — the first NON-idempotent monoid on the
sparse butterfly path.

The port of ``repro.programs.pagerank``.  Power iteration in the
gather-apply-scatter contract:

* **gather** — each rank scatters ``rank[u] / deg_out[u]`` over its owned
  out-edges into a per-rank CONTRIBUTION buffer (``ADD_F32``), plus its
  owned dangling mass into the slack row ``n`` (riding the same exchange —
  no second collective);
* **sync** — ADD is not idempotent, so the sparse path runs in **delta
  mode** (``ref=None``): each rank ships its own nonzero contribution
  words (float32 bits on the wire), identity-padded with exact ``0.0``
  no-ops; the butterfly delivers each subcube partial exactly once, so the
  sparse/adaptive results are **bit-identical** to the dense reduce;
* **apply** — ``rank' = (1-d)/n + d * (contrib + dangling/n)`` on every
  rank from the replicated merged buffer; convergence when the total L1
  residual drops to ``cfg.tol``.

``arg`` is the initial rank vector, so a warm start runs the same
program from cached ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import monoid as mono
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.programs import core


class PageRankProgram(core.VertexProgram):
    name = "pagerank"
    monoid = mono.ADD_F32

    def init(self, ctx, arg):
        # arg: replicated float32[n_rows] initial ranks; residual inf =>
        # at least one round
        rank = arg.to(ctx.device).expand(ctx.p, ctx.n_rows).contiguous()
        return (rank, torch.tensor(float("inf"), device=ctx.device))

    def active(self, ctx, state, it):
        return state[1] > ctx.cfg.tol

    def gather(self, ctx, state, it):
        rank = state[0]
        a = ctx.arrays
        src, dst = a["edge_src"].long(), a["edge_dst"].long()
        emask = ctx.edge_mask
        # out-degree of each owned edge's source (locally indexed; real
        # owned edges always have deg_out >= 1 — they carry this edge)
        lidx = torch.where(emask, src - ctx.v_start, 0)
        deg = torch.gather(a["deg_out"], 1, lidx).clamp_min(1).to(torch.float32)
        contrib = torch.where(emask, torch.gather(rank, 1, src) / deg, 0.0)
        msg = torch.zeros_like(rank).scatter_add_(1, dst, contrib)
        # owned dangling mass rides the exchange in slack row n (outside
        # every owned output window, so it never leaks into results)
        owned_rank = ctx.owned_slice(rank)
        dangle = torch.where(ctx.owned_mask & (a["deg_out"] == 0), owned_rank, 0.0).sum(1)
        msg[:, ctx.n] += dangle
        return msg, None, emask.sum(1, dtype=torch.float32)

    def apply(self, ctx, state, merged, it):
        rank = state[0]
        n = ctx.n
        d = np.float32(ctx.cfg.damping)
        base = np.float32(1.0 - d) / n + d * merged[:, n : n + 1] / n
        real = torch.arange(ctx.n_rows, device=rank.device) < n
        new = torch.where(real, base + d * merged, 0.0)
        resid = (new - rank).abs().sum(1)
        return (new, resid[0])

    def outputs(self, ctx, state):
        return (ctx.owned_slice(state[0]),)

    def metrics(self, ctx, state, merged):
        # POP: residual mass in parts-per-million (int32 trace cell)
        return (state[1] * 1e6).clamp_max(2**31 - 1).to(torch.int32), 0

    def default_max_iters(self, pg: PartitionedGraph) -> int:
        return 200

    def default_arg(self, pg: PartitionedGraph, device="cuda"):
        return uniform_ranks(pg, device)

    def assemble(self, pg: PartitionedGraph, out) -> np.ndarray:
        return core.assemble_owned(pg, out, 0.0, np.float64)


def uniform_ranks(pg: PartitionedGraph, device="cuda") -> torch.Tensor:
    """The cold-start operand: ``1/n`` on real vertices, zero pad rows."""
    rows = torch.arange(core.program_rows(pg), device=core.resolve_device(device))
    return torch.where(rows < pg.n, np.float32(1.0 / pg.n), np.float32(0.0))


def rank_arg(pg: PartitionedGraph, ranks: np.ndarray, device="cuda") -> torch.Tensor:
    """Lift a cached global rank vector back into the replicated operand
    (a warm-start seed)."""
    buf = np.zeros(core.program_rows(pg), dtype=np.float32)
    buf[: pg.n] = np.asarray(ranks, dtype=np.float32)[: pg.n]
    return torch.from_numpy(buf).to(core.resolve_device(device))


def repair_rank_rows(rows, *, pg: PartitionedGraph, fn, arrays):
    """§16 batch repairer: warm-start re-push of cached rank vectors.

    ``fn`` is the built program (the one the cold path runs — a warm start
    is only a different operand), ``arrays`` the engine's placed partition
    (already refreshed for the mutated partition); the operands go to the
    device those arrays are on.  Returns ``[(new_row, touched, iters),
    ...]`` in ``migrate_cache``'s outcome contract: ``touched`` counts
    vertices whose rank moved, ``iters`` the re-push rounds (the
    recompute-vs-repair §16 accounting).
    """
    program = PageRankProgram()
    device = arrays["edge_src"].device
    outcomes = []
    for row in rows:
        out = fn(arrays, rank_arg(pg, row, device))
        new = program.assemble(pg, out[0])
        iters = int(out[1])
        touched = int(np.sum(~np.isclose(new, row, rtol=1e-6, atol=1e-12)))
        outcomes.append((new if touched else row, touched, iters))
    return outcomes


def pagerank_reference(
    g: Graph, *, damping: float = 0.85, tol: float = 1e-5,
    max_iters: int = 200, init: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host power iteration (float64) — the PageRank oracle.  Mirrors the
    device semantics exactly: per-edge ``rank[u]/deg_out[u]`` pushes,
    dangling mass redistributed uniformly, total-L1-residual stopping — so
    device float32 results match to float tolerance, not bit-exactly."""
    n = g.n
    offs, dst = g.row_offsets, g.dst
    deg = np.diff(offs).astype(np.float64)
    rank = (np.full(n, 1.0 / n) if init is None
            else np.asarray(init, dtype=np.float64).copy())
    src = np.repeat(np.arange(n), np.diff(offs))
    inv_deg = 1.0 / np.maximum(deg, 1.0)
    for _ in range(max_iters):
        contrib = np.zeros(n)
        np.add.at(contrib, dst, rank[src] * inv_deg[src])
        dangle = rank[deg == 0].sum()
        new = (1.0 - damping) / n + damping * (contrib + dangle / n)
        resid = np.abs(new - rank).sum()
        rank = new
        if resid <= tol:
            break
    return rank
