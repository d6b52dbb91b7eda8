"""Distributed Brandes betweenness centrality on the MS-BFS bit-lanes.

The port of ``repro.traversal.bc``.  Brandes (2001) decomposes
betweenness into per-source *dependencies*:

  ``BC(v) = sum_s delta_s(v)``,
  ``delta_s(v) = sum_{w: succ} sigma_s(v)/sigma_s(w) * (1 + delta_s(w))``

B sources run concurrently, one bit-lane each:

* **Forward wave** — the lane-packed frontier expands exactly like MS-BFS
  (phase 1 push with ``lanes=True``, phase 2 the frontier OR sync with its
  dense rounds merged by ``bitmap_or_reduce``), while per-lane
  shortest-path counts ``sigma[v, b]`` accumulate: each rank sums
  ``sigma[u]`` over its OWNED in-edges ``(u -> v)`` with ``u`` in the
  frontier and ``v`` newly reached, and the disjoint partial sums merge
  with a dense ADD all-reduce (ADD is not idempotent, so the sparse wire
  does not apply).  Per-lane levels are captured en route.
* **Backward replay** — levels run in reverse: each rank scores its OWNED
  out-edges ``(u -> w)`` with ``lvl[u] == L-1`` and ``lvl[w] == L`` as
  ``sigma[u]/sigma[w] * (1 + delta[w])``, scatter-adds into ``delta[u]``,
  and the partials merge with the same ADD all-reduce.  The level array is
  the replay index: no per-level frontier is stored.

The forward loop reads one value per level (the new frontier's size); the
replay knows its depth and reads nothing.  The ADD merges are plain
PyTorch, as the reference's are XLA ops.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analytics.msbfs import lane_words, wave_rows
from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core.bfs import (
    INF,
    BFSConfig,
    _expand_push,
    _lane_rows,
    _sync_frontier,
    device_sync,
    mesh_comm,
    place_arrays,
    resolve_device,
    resolve_mesh,
)
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.traversal.sssp import owned_rows


# ---------------------------------------------------------------------------
# Host oracle (Brandes)
# ---------------------------------------------------------------------------


def bc_reference(g: Graph, sources: Sequence[int]) -> np.ndarray:
    """Host Brandes over the given sources — ground truth for every BC test.

    Unnormalized directed-pair accumulation (each ordered pair ``(s, t)``
    contributes once); on the symmetric graphs the ETL produces this is 2x
    the undirected convention, matching the distributed path exactly.
    Returns ``float64[n]``.
    """
    bc = np.zeros(g.n, dtype=np.float64)
    offs, dst = g.row_offsets, g.dst
    for s in sources:
        s = int(s)
        sigma = np.zeros(g.n)
        sigma[s] = 1.0
        d = np.full(g.n, -1, dtype=np.int64)
        d[s] = 0
        order = [s]
        frontier = [s]
        while frontier:
            nxt = []
            for u in frontier:
                for v in dst[offs[u] : offs[u + 1]]:
                    if d[v] < 0:
                        d[v] = d[u] + 1
                        nxt.append(int(v))
            for u in frontier:
                for v in dst[offs[u] : offs[u + 1]]:
                    if d[v] == d[u] + 1:
                        sigma[v] += sigma[u]
            order.extend(nxt)
            frontier = nxt
        delta = np.zeros(g.n)
        for u in reversed(order):
            for v in dst[offs[u] : offs[u + 1]]:
                if d[v] == d[u] + 1:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
        delta[s] = 0.0
        bc += delta
    return bc


# ---------------------------------------------------------------------------
# Distributed BC
# ---------------------------------------------------------------------------


def _sync_add(buf: torch.Tensor, cfg: BFSConfig,
              comm: collectives.Communicator) -> torch.Tensor:
    """ADD all-reduce of per-rank partial sums ``buf[P, ...]``.  ADD is not
    idempotent, so the sparse changed-word wire format does not apply —
    sparse/adaptive configs ride the dense butterfly here while their
    frontier OR sync stays sparse."""
    axes = cfg.axes
    if cfg.sync == "all_to_all":
        return collectives.all_to_all_merge(buf, comm, op="add", axes=axes)
    if cfg.sync == "xla":
        return collectives.xla_allreduce(buf, comm, op="add", axes=axes)
    if cfg.sync == "rabenseifner":
        return collectives.butterfly_allreduce_rabenseifner(buf, comm, fanout=cfg.fanout,
                                                            op="add", axes=axes)
    return collectives.butterfly_allreduce(buf, comm, fanout=cfg.fanout, axes=axes)


def _scatter_add_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``zeros[P, n_rows, L]`` with ``vals[P, E, L]`` added into rows
    ``idx[P, E]``."""
    out = vals.new_zeros((vals.shape[0], n_rows, vals.shape[2]))
    return out.scatter_add_(1, idx.long()[..., None].expand(vals.shape), vals)


def build_bc_fn(pg: PartitionedGraph, cfg: BFSConfig, n_lanes: int, *, device="cuda",
                trace: bool = False, trace_levels: Optional[int] = None,
                mesh: Optional[SimMesh] = None):
    """B-lane betweenness centrality over ``pg``'s P simulated ranks on
    ``mesh`` (:func:`~repro_torch.core.bfs.resolve_mesh`), every sync over
    ``cfg.axes``.

    Returns ``run(arrays, roots, comm=None, *, or_comm=None, level_ms=None,
    lanes=None)`` where ``roots`` is ``n_lanes`` vertex ids (``-1`` =
    inactive lane).  ``comm`` counts every sync's bytes; ``or_comm``, when
    given, takes the forward frontier OR syncs' bytes in its place (the
    traced rows' syncs alone, which the byte model reconciles).
    Output: per-rank owned dependency sums ``float32[P, vmax]`` (the BC
    contribution of this wave's sources, root rows excluded per lane), wave
    depth, and edges examined (float32).  A dict ``lanes`` receives each
    rank's owned rows per lane, the window's rows past ``v_count`` masked:
    ``"levels"`` (``int32[P, vmax, B]``, INF unreached, as the
    single-source BFS gives them) and ``"delta"`` (``float32[P, vmax, B]``,
    zero).

    ``trace=True`` appends the flight-recorder buffer for the FORWARD
    wave's frontier OR sync (the replay re-walks the recorded levels with
    the dense ADD merge, reported as ``extra_dense_syncs``).
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if cfg.mode != "top_down":
        raise NotImplementedError("betweenness centrality uses the push traversal; "
                                  "build the config with mode='top_down'")
    if cfg.use_kernels:
        raise NotImplementedError("use_kernels=True is single-source only; BC uses "
                                  "the plain path")
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    bw = lane_words(n_lanes)
    n_rows = wave_rows(pg)
    p, vmax = pg.p, pg.vmax
    max_levels = cfg.max_levels if cfg.max_levels is not None else pg.n
    own = owned_rows(pg, dev)
    owned = (torch.arange(vmax, device=dev)[None, :]
             < torch.as_tensor(pg.v_count, device=dev)[:, None])
    lane_ids = torch.arange(n_lanes, device=dev)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_levels)

    def lanes_of(rows):
        """bool[..., n_lanes] of lane-packed ``rows[..., bw]``."""
        return fr.lane_unpack(rows)[..., :n_lanes]

    def window(buf):
        """Each rank's owned rows of ``buf[P, n_rows, k]``."""
        return torch.gather(buf, 1, own[..., None].expand(p, vmax, buf.shape[2]))

    def run(arrays, roots, comm: Optional[collectives.Communicator] = None, *,
            or_comm: Optional[collectives.Communicator] = None,
            level_ms: Optional[list] = None, lanes: Optional[dict] = None):
        roots = np.asarray(roots, dtype=np.int64)
        if roots.shape != (n_lanes,):
            raise ValueError(f"expected {n_lanes} roots, got shape {roots.shape}")
        comm = mesh_comm(comm, mesh, dev)
        or_comm = comm if or_comm is None else mesh_comm(or_comm, mesh, dev)
        active = torch.as_tensor(roots >= 0, device=dev)
        seeds = torch.as_tensor(np.where(roots >= 0, roots, 0), device=dev)
        onehot = (torch.arange(bw * fr.WORD_BITS, device=dev)[None, :]
                  == lane_ids[:, None]) & active[:, None]
        seen = fr.scatter_or_lanes(n_rows, seeds, fr.lane_pack(onehot))
        seen = seen.expand(p, n_rows, bw).contiguous()
        sigma = torch.zeros((p, n_rows, n_lanes), dtype=torch.float32, device=dev)
        sigma[:, seeds, lane_ids] += active.to(torch.float32)
        lvl = torch.full((p, n_rows, n_lanes), INF, dtype=torch.int32, device=dev)
        lvl[:, seeds[active], lane_ids[active]] = 0

        isrc, idst = arrays["in_src"], arrays["in_dst"]
        imask = torch.arange(isrc.shape[1], device=dev) < arrays["in_count"][:, None]
        osrc, odst = arrays["edge_src"], arrays["edge_dst"]
        omask = torch.arange(osrc.shape[1], device=dev) < arrays["edge_count"][:, None]
        deg_out = arrays["deg_out"]

        # ---- forward wave: frontier expansion + sigma accumulation
        def fcond(s):
            return s[6] > 0 and s[4] < max_levels

        def fstep(s):
            frontier, seen, lvl, sigma, level, scanned, _ = s
            gq = _expand_push(arrays, frontier, n_rows, False, lanes=True)
            if trace:
                stats = flightrec.or_sync_stats(gq.reshape(p, -1), cfg)
            merged = _sync_frontier(gq.reshape(p, -1), cfg, or_comm,
                                    use_kernels=True).reshape(p, n_rows, bw)
            new = merged & ~seen
            # sigma increments over OWNED in-edges u -> v (v newly reached,
            # u in the closing level's frontier); partial sums are disjoint
            # across ranks, so one ADD all-reduce finalizes the level
            u_front = lanes_of(_lane_rows(frontier, isrc))
            v_new = lanes_of(_lane_rows(new, idst))
            contrib = torch.where(u_front & v_new & imask[..., None],
                                  torch.gather(sigma, 1, isrc.long()[..., None].expand(
                                      *isrc.shape, n_lanes)), 0.0)
            partial = _scatter_add_rows(n_rows, idst, contrib)
            sigma = sigma + _sync_add(partial.reshape(p, -1), cfg, comm).reshape(
                p, n_rows, n_lanes)
            lvl = torch.where(lanes_of(new), level + 1, lvl)
            # edges examined: out-degree of owned frontier rows, per lane
            owned_front = lanes_of(window(frontier)) & owned[..., None]
            m_f = (deg_out[..., None] * owned_front).sum((1, 2))
            n_new = int(fr.popcount(new[0]))
            out = (new, seen | new, lvl, sigma, level + 1,
                   scanned + m_f.to(torch.float32), n_new)
            if not trace:
                return out, None
            row = flightrec.trace_row(level, stats[0], n_new, 0, stats[1], stats[2],
                                      fr.count_nonzero(new[0].reshape(-1)))
            return out, (level, row)

        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        finit = (seen, seen, lvl, sigma, 0, torch.zeros(p, dtype=torch.float32, device=dev),
                 int(fr.popcount(seen[0])))
        fs = loop.host_while(fcond, fstep, finit, trace_buffer=tbuf, level_ms=level_ms,
                             sync=device_sync(dev))
        lvl, sigma, depth, scanned = fs[2], fs[3], fs[4], fs[5]

        # ---- backward replay: dependency accumulation, deepest first
        def rows(buf, idx):
            return torch.gather(buf, 1, idx.long()[..., None].expand(*idx.shape, n_lanes))

        sig_src = rows(sigma, osrc)
        sig_dst = rows(sigma, odst).clamp_min(1.0)  # reached => sigma >= 1
        lvl_src, lvl_dst = rows(lvl, osrc), rows(lvl, odst)
        delta = torch.zeros((p, n_rows, n_lanes), dtype=torch.float32, device=dev)
        for level in range(depth, 0, -1):
            on_dag = (lvl_src == level - 1) & (lvl_dst == level) & omask[..., None]
            c = torch.where(on_dag, sig_src / sig_dst * (1.0 + rows(delta, odst)), 0.0)
            partial = _scatter_add_rows(n_rows, osrc, c)
            delta = delta + _sync_add(partial.reshape(p, -1), cfg, comm).reshape(
                p, n_rows, n_lanes)

        # a source never scores its own lane (Brandes excludes s)
        delta[:, seeds, lane_ids] = 0.0
        owned_delta = window(delta)
        if lanes is not None:
            mine = owned[..., None]
            lanes["levels"] = torch.where(mine, window(lvl), INF)
            lanes["delta"] = torch.where(mine, owned_delta, 0.0)
        out = (owned_delta.sum(2), depth, float(scanned.sum()))
        return out + (tbuf,) if trace else out

    return run


def assemble_bc(pg: PartitionedGraph, bc_owned: torch.Tensor) -> np.ndarray:
    """``bc_owned [P, vmax]`` -> global ``float64[n]``."""
    bc_owned = bc_owned.cpu().numpy()
    out = np.zeros(pg.n, dtype=np.float64)
    for i in range(pg.p):
        s, c = int(pg.v_start[i]), int(pg.v_count[i])
        out[s : s + c] = bc_owned[i, :c]
    return out


def betweenness_centrality(pg: PartitionedGraph, sources: Sequence[int],
                           cfg: BFSConfig = BFSConfig(), *, device="cuda",
                           mesh: Optional[SimMesh] = None) -> Tuple[np.ndarray, int, float]:
    """End-to-end helper: one wave over ``sources`` (one lane per source).

    Returns ``(bc float64[n], depth, scanned)``; ``bc`` matches
    :func:`bc_reference` over the same sources.  ``-1`` marks an inactive
    lane; any other out-of-range source raises.
    """
    sources = np.asarray(sources, dtype=np.int64)
    if sources.ndim != 1 or sources.size < 1:
        raise ValueError("sources must be a non-empty 1-D sequence")
    if np.any((sources < -1) | (sources >= pg.n)):
        raise ValueError(f"source out of range (n={pg.n}, -1=inactive): {sources}")
    dev = resolve_device(device)
    fn = build_bc_fn(pg, cfg, int(sources.size), device=dev, mesh=mesh)
    bc_owned, depth, scanned = fn(place_arrays(pg, device=dev), sources)
    return assemble_bc(pg, bc_owned), depth, scanned
