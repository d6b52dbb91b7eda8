"""Bit-parallel multi-source BFS (MS-BFS) on the butterfly sync (DESIGN.md §13).

The port of ``repro.analytics.msbfs``.  One wave runs up to ``B``
breadth-first searches concurrently, one BIT-LANE per root: every rank's
wave frontier is lane-packed ``int32[n_rows, B_words]`` (``B_words =
ceil(B/32)``) where row ``v`` is vertex ``v`` and bit ``b`` of lane-word
``b >> 5`` says "search ``b`` has ``v`` in its frontier".

Phase 1 is :func:`repro_torch.core.bfs._expand_push` / ``_expand_pull``
with ``lanes=True``, in plain PyTorch (the frontier kernels are
single-source, as the reference's Pallas kernels are); phase 2 is the
single-source :func:`~repro_torch.core.bfs._sync_frontier` UNCHANGED on
the flat ``[P, n_rows * B_words]`` buffer, its dense rounds merged by
``bitmap_or_reduce`` (the CUDA kernel on the card, its plain version on
the CPU) whatever ``use_kernels`` says, since phase 1 has no kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core.bfs import (
    INF,
    BFSConfig,
    _expand_pull,
    _expand_push,
    _sync_frontier,
    device_sync,
    mesh_comm,
    place_arrays,
    resolve_device,
    resolve_mesh,
)
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.partition import PartitionedGraph

LANE_BITS = fr.WORD_BITS


def lane_words(n_lanes: int) -> int:
    """Words per row: ceil(B/32)."""
    return (n_lanes + LANE_BITS - 1) // LANE_BITS


def wave_rows(pg: PartitionedGraph, *, lane_pad: int = 128) -> int:
    """Vertex rows of the wave buffer: the whole graph plus one rank
    window of slack (every rank reads its aligned ``[v_start, v_start +
    vmax)`` rows), lane-padded."""
    rows = pg.n + pg.vmax
    return (rows + lane_pad - 1) // lane_pad * lane_pad


def build_msbfs_fn(pg: PartitionedGraph, cfg: BFSConfig, n_lanes: int, *,
                   device="cuda", trace: bool = False,
                   trace_levels: Optional[int] = None, mesh: Optional[SimMesh] = None):
    """B-lane multi-source BFS over ``pg``'s P simulated ranks on ``mesh``
    (:func:`~repro_torch.core.bfs.resolve_mesh`), syncing over ``cfg.axes``.

    Returns ``run(arrays, roots, comm=None)`` where ``arrays`` is the SAME
    placed dict the single-source BFS consumes (no kernel layout) and
    ``roots`` ``n_lanes`` vertex ids (``-1`` = inactive lane; duplicates
    allowed).  Output:

    * ``d_owned int32[P, vmax, n_lanes]`` — per-rank owned distances, one
      column per lane (INF for unreached / inactive lanes),
    * ``levels`` — wave depth (all lanes step levels in lock-step),
    * ``scanned`` — edges examined, summed over lanes, in float32 as the
      reference counts them (honest aggregate TEPS).

    ``trace=True`` appends the flight-recorder buffer
    ``int32[trace_levels, TRACE_COLS]`` (stats over the FLATTENED lane-word
    buffer the sync exchanges; POP/CHANGED aggregate over all lanes).
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if cfg.use_kernels:
        raise NotImplementedError(
            "use_kernels=True is single-source only; MS-BFS uses the plain path")
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    bw = lane_words(n_lanes)
    n_rows = wave_rows(pg)
    p, vmax = pg.p, pg.vmax
    max_levels = cfg.max_levels if cfg.max_levels is not None else pg.n
    own_rows = (torch.as_tensor(pg.v_start, dtype=torch.int64, device=dev)[:, None]
                + torch.arange(vmax, device=dev))[..., None].expand(p, vmax, bw)
    owned = (torch.arange(vmax, device=dev)[None, :]
             < torch.as_tensor(pg.v_count, device=dev)[:, None])
    lane_ids = torch.arange(n_lanes, device=dev)
    alpha = np.float32(cfg.alpha)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_levels)

    def window(buf):
        """Each rank's owned rows ``[v_start, v_start + vmax)`` of
        ``buf[P, n_rows, bw]``."""
        return torch.gather(buf, 1, own_rows)

    def owned_lanes(buf):
        """bool[P, vmax, n_lanes]: each rank's owned rows, lane by lane."""
        return fr.lane_unpack(window(buf))[..., :n_lanes] & owned[..., None]

    def run(arrays, roots, comm: Optional[collectives.Communicator] = None, *,
            level_ms: Optional[list] = None):
        roots = np.asarray(roots, dtype=np.int64)
        if roots.shape != (n_lanes,):
            raise ValueError(f"expected {n_lanes} roots, got shape {roots.shape}")
        comm = mesh_comm(comm, mesh, dev)
        deg_out = arrays["deg_out"]
        active = torch.as_tensor(roots >= 0, device=dev)
        lane_bits = torch.zeros(bw * LANE_BITS, dtype=torch.bool, device=dev)
        lane_bits[:n_lanes] = active
        lane_mask = fr.lane_pack(lane_bits)  # the active lanes, packed
        # one-hot lane masks, OR-scattered so duplicate roots compose
        onehot = (torch.arange(bw * LANE_BITS, device=dev)[None, :]
                  == lane_ids[:, None]) & active[:, None]
        seeds = torch.as_tensor(np.where(roots >= 0, roots, 0), device=dev)
        seen = fr.scatter_or_lanes(n_rows, seeds, fr.lane_pack(onehot))
        seen = seen.expand(p, n_rows, bw).contiguous()
        d_owned = torch.where(owned_lanes(seen), 0, INF).to(torch.int32)
        active_count = max(int((roots >= 0).sum()), 1)
        push_below = np.float32(np.float32(active_count * pg.n) / np.float32(cfg.beta))

        def cond(s):
            return s[6] > 0 and s[3] < max_levels

        def step(s):
            frontier, seen, d_owned, level, scanned, pull, _ = s
            # -- Phase 1: lane-parallel traversal
            if pull:
                gq = _expand_pull(arrays, frontier, seen, n_rows, False, lanes=True)
            else:
                gq = _expand_push(arrays, frontier, n_rows, False, lanes=True)
            # edges examined this level, summed over ACTIVE lanes
            front_rows = fr.popcount(window(frontier), dim=-1)
            unvisited_rows = fr.popcount(~window(seen) & lane_mask, dim=-1)
            m_f = (deg_out * front_rows * owned).sum(1)
            m_u = (deg_out * unvisited_rows * owned).sum(1)
            # -- Phase 2: the single-source sync, unchanged on the flat buffer
            if trace:
                stats = flightrec.or_sync_stats(gq.reshape(p, -1), cfg)
            merged = _sync_frontier(gq.reshape(p, -1), cfg, comm,
                                    use_kernels=True).reshape(p, n_rows, bw)
            new = merged & ~seen
            seen = seen | new
            d_owned = d_owned.masked_fill_(owned_lanes(new), level + 1)
            scanned = scanned + (m_u if pull else m_f).to(torch.float32)
            n_new, g_mf, g_mu = torch.stack(
                [fr.popcount(new[0]), m_f.sum(), m_u.sum()]).tolist()
            # -- Direction-optimizing switch, wave-aggregated, in float32
            next_pull = pull
            if cfg.mode == "direction_optimizing":
                if pull:
                    next_pull = not np.float32(n_new) < push_below
                else:
                    next_pull = bool(np.float32(g_mf) > np.float32(g_mu) / alpha)
            out = (new, seen, d_owned, level + 1, scanned, next_pull, n_new)
            if not trace:
                return out, None
            row = flightrec.trace_row(level, stats[0], n_new, int(pull), stats[1],
                                      stats[2], fr.count_nonzero(new[0].reshape(-1)))
            return out, (level, row)

        init = (seen, seen, d_owned, 0, torch.zeros(p, dtype=torch.float32, device=dev),
                cfg.mode == "bottom_up", int(fr.popcount(seen[0])))
        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        s = loop.host_while(cond, step, init, trace_buffer=tbuf, level_ms=level_ms,
                            sync=device_sync(dev))
        out = (s[2], s[3], float(s[4].sum()))
        return out + (tbuf,) if trace else out

    return run


def assemble_distances(pg: PartitionedGraph, d_owned, n_lanes: int) -> np.ndarray:
    """``d_owned [P, vmax, B]`` -> global ``int64[B, n]`` distance matrix
    (row per search lane, INT32_MAX sentinel for unreached)."""
    if isinstance(d_owned, torch.Tensor):
        d_owned = d_owned.cpu().numpy()
    dist = np.full((n_lanes, pg.n), INF, dtype=np.int64)
    for i in range(pg.p):
        s, c = int(pg.v_start[i]), int(pg.v_count[i])
        dist[:, s : s + c] = d_owned[i, :c, :].T
    return dist


def multi_source_bfs(pg: PartitionedGraph, roots: Sequence[int],
                     cfg: BFSConfig = BFSConfig(), *, device="cuda",
                     mesh: Optional[SimMesh] = None) -> Tuple[np.ndarray, int, float]:
    """End-to-end helper: one wave over ``roots`` (one lane per root).

    Returns ``(dist int64[B, n], levels, scanned)``; ``dist[b]`` matches
    ``bfs_reference(g, roots[b])`` exactly.  ``-1`` marks an inactive lane
    (all-INF row); any other out-of-range root raises."""
    roots = np.asarray(roots, dtype=np.int64)
    if roots.ndim != 1 or roots.size < 1:
        raise ValueError("roots must be a non-empty 1-D sequence")
    if np.any((roots < -1) | (roots >= pg.n)):
        raise ValueError(f"root out of range (n={pg.n}, -1=inactive): {roots}")
    dev = resolve_device(device)
    fn = build_msbfs_fn(pg, cfg, int(roots.size), device=dev, mesh=mesh)
    d_owned, levels, scanned = fn(place_arrays(pg, device=dev), roots)
    return assemble_distances(pg, d_owned, int(roots.size)), levels, scanned
