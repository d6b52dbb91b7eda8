"""Incremental traversal repair on the butterfly (DESIGN.md §16).

The port of ``repro.dynamic.repair``.  Repairs a PRIOR distance/level
vector after a mutation batch instead of recomputing from scratch.  Where
the reference stages one program holding two ``lax.while_loop`` waves,
the port runs the two waves as host-driven loops over P simulated ranks
(:func:`repro_torch.core.loop.host_while`, as ``traversal/sssp.py``):

* **Phase A — deletion taint closure.**  A deleted edge ``(u, v)`` can
  only invalidate ``v``'s distance if it was TIGHT (``d[u] + w == d[v]``).
  Seeding the taint at every tight-deleted head and propagating along
  SURVIVING tight edges (``d0[x] + w == d0[y]``) marks a superset of the
  vertices whose distance may have grown: any vertex outside the closure
  has, by induction on distance, a tight path that avoids every deleted
  edge entirely, so its distance is provably unchanged.  Tainted vertices
  are reset to the UNREACHED sentinel.  The taint bitmaps merge with the
  OR sync of the distances' family (:func:`_or_cfg`), whose dense rounds
  go through ``bitmap_or_reduce`` (the CUDA kernel on the card).

* **Phase B — monotone min re-relaxation.**  Inserts can only LOWER
  distances (weights are uint32 ≥ 1 and duplicate inserts keep the min),
  so under the MIN monoid the prior vector is a valid upper bound: the
  frontier is seeded with the insert endpoints that actually improve
  something plus the untainted boundary of the taint region, and relaxes
  (``traversal.sssp.relax``, the saturating uint32 relax, and its
  ``_sync_dist``) to the same unique fixpoint a from-scratch run reaches —
  hence bit-exact across dense/sparse/adaptive sync.

Distances are uint32 words held as int32 bit patterns (UNREACHED is
``-1``): the tight-edge test adds in int64 and masks to 32 bits, as the
reference's uint32 sum wraps, and every order compare is unsigned
(``monoid.ult``).

The EMPTY-seed case never touches the device: a batch whose edges neither
improve nor were tight proves the row unchanged on the host — the fast
path of the §16 partial-invalidation protocol.  BFS level repair is the
``unit_weight=True`` special case (every edge weight 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core import monoid as mono
from repro_torch.core.bfs import (
    BFSConfig,
    _lane_rows,
    _sync_frontier,
    device_sync,
    mesh_comm,
    place_arrays,
    resolve_device,
    resolve_mesh,
)
from repro_torch.core.devlock import device_lock
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.traversal import sssp as sssp_mod
from repro_torch.traversal.sssp import UNREACHED, SSSPConfig, dist_rows, owned_rows

INF32 = np.iinfo(np.int32).max
_U32 = 0xFFFFFFFF
#: Edge-slot terms ``[P, E, L]`` of the lane wave are evaluated in chunks
#: of about this many elements (the per-edge terms of a 32-lane wave do
#: not fit whole at Kronecker scale 21 and up).
CHUNK_ELEMS = 1 << 26


def _or_cfg(cfg: SSSPConfig) -> BFSConfig:
    """The OR-sync (bitmap) twin of a distance-sync config: taint and seed
    bitmaps merge with the same sync family the distances use."""
    return BFSConfig(axes=cfg.axes, fanout=cfg.fanout, sync=cfg.sync,
                     sparse_capacity=cfg.sparse_capacity,
                     density_threshold=cfg.density_threshold)


def _replicated(x, p: int, dev: torch.device) -> torch.Tensor:
    """A replicated operand (uint32 NumPy words or an int32 tensor) as an
    int32 ``[P, ...]`` view on ``dev``: every simulated rank reads the one
    copy, which is never written."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    x = x.to(device=dev, dtype=torch.int32)
    return x.unsqueeze(0).expand(p, *x.shape)


def _edge_mask(src: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.arange(src.shape[1], device=src.device) < count[:, None]


def _weights(arrays, unit_weight: bool):
    """Each edge slot's weight as int64 (uint32 values), or 1."""
    return 1 if unit_weight else arrays["edge_weight"].long() & _U32


def _check_weighted(pg: PartitionedGraph, unit_weight: bool) -> None:
    if not unit_weight and not pg.weighted:
        raise ValueError(
            "weighted repair needs a weighted partition; pass "
            "unit_weight=True for BFS level repair"
        )


def build_repair_fn(pg: PartitionedGraph, cfg: SSSPConfig, *, unit_weight: bool = False,
                    with_taint: bool = True, trace: bool = False,
                    trace_levels: Optional[int] = None, device="cuda",
                    mesh: Optional[SimMesh] = None):
    """Incremental repair over ``pg``'s P simulated ranks on ``mesh``
    (:func:`~repro_torch.core.bfs.resolve_mesh`), every sync over
    ``cfg.axes``.

    Returns ``run(arrays, dist0, taint_seed, relax_seed, comm=None, *,
    level_ms=None)`` where ``arrays`` is the placed (POST-update)
    partition, ``dist0`` the prior replicated ``uint32[dist_rows(pg)]``
    distances (:data:`UNREACHED` sentinel; NumPy uint32 or an int32 tensor
    of the patterns), ``taint_seed``/``relax_seed`` replicated
    ``uint32[dist_rows(pg) // 32]`` seed bitmaps (tight-deleted heads /
    improving insert endpoints).  Output: owned repaired distances
    ``int32[P, vmax]`` (uint32 patterns), iterations (taint + relax
    rounds), and the touched-vertex count.

    ``with_taint=False`` builds the INSERT-ONLY specialization: phase A,
    the boundary probe, and the pre-relax seed sync drop out (the relax
    seed bitmap is host-computed and replicated, so no merge is needed).
    ``taint_seed`` must then be all-zero.

    ``cfg.delta`` (bucket frontiers) is ignored: repair always runs plain
    monotone relaxation — the fixpoint, hence the result, is identical.

    ``trace=True`` appends one flight-recorder buffer spanning BOTH
    waves: phase-A taint rounds record DIR=0 (bitmap OR stats), phase-B
    relax iterations DIR=1 (MIN-monoid stats) at consecutive LEVEL
    indices.  The one-shot seed/boundary sync between the phases is not a
    level and is not recorded.  (The lane-packed
    :func:`build_repair_wave_fn` is untraced, as the reference's.)
    """
    _check_weighted(pg, unit_weight)
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    p, n_rows = pg.p, dist_rows(pg)
    nw = n_rows // fr.WORD_BITS
    capacity = cfg.resolved_capacity(n_rows)
    max_iters = cfg.max_iters if cfg.max_iters is not None else 1 << 30
    or_cfg = _or_cfg(cfg)
    own = owned_rows(pg, dev)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_iters)

    def run(arrays, dist0, taint_seed, relax_seed,
            comm: Optional[collectives.Communicator] = None, *,
            level_ms: Optional[list] = None):
        comm = mesh_comm(comm, mesh, dev)
        dist0 = _replicated(dist0, p, dev)
        src, dst = arrays["edge_src"], arrays["edge_dst"]
        emask = _edge_mask(src, arrays["edge_count"])
        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        sync = device_sync(dev)

        if with_taint:
            # -- Phase A: deletion taint closure over surviving tight edges;
            # an edge's tightness under dist0 holds for the whole phase
            du = torch.gather(dist0, 1, src.long())
            dv = torch.gather(dist0, 1, dst.long())
            tight_edge = emask & (du != -1) & (
                ((du.long() & _U32) + _weights(arrays, unit_weight)) & _U32
                == (dv.long() & _U32))
            del du, dv

            def t_cond(s):
                return s[3] > 0

            def t_step(s):
                taint, front, rounds, _ = s
                pre = fr.scatter_or(nw, dst, fr.get_bits(front, src) & tight_edge)
                if trace:
                    stats = flightrec.or_sync_stats(pre, or_cfg)
                prop = _sync_frontier(pre, or_cfg, comm, use_kernels=True)
                new = prop & ~taint
                n_new = int(fr.popcount(new[0]))
                out = (taint | new, new, rounds + 1, n_new)
                if not trace:
                    return out, None
                row = flightrec.trace_row(rounds, stats[0], n_new, 0, stats[1], stats[2],
                                          fr.count_nonzero(new[0]))
                return out, (rounds, row)

            seed = _replicated(taint_seed, p, dev)
            s = loop.host_while(t_cond, t_step, (seed, seed, 0, int(fr.popcount(seed[0]))),
                                trace_buffer=tbuf, level_ms=level_ms, sync=sync)
            taint, t_rounds = s[0], s[2]
            del tight_edge, s
            taint_bits = fr.unpack(taint)
            dist = torch.where(taint_bits, -1, dist0)
            taint_bits = taint_bits[0]  # replicated: one rank's for the count

            # untainted finite boundary: owners of a surviving edge INTO
            # the taint region re-propose distances across it
            ds = torch.gather(dist, 1, src.long())
            bnd = fr.scatter_or(nw, src, fr.get_bits(taint, dst) & ~fr.get_bits(taint, src)
                                & emask & (ds != -1))
            del ds
            changed = _sync_frontier(_replicated(relax_seed, p, dev) | bnd, or_cfg, comm,
                                     use_kernels=True)
        else:
            # insert-only: the prior distances stand as valid upper bounds
            # and the replicated host seeds need no merge
            t_rounds, taint_bits = 0, None
            dist = dist0
            changed = _replicated(relax_seed, p, dev)

        # -- Phase B: monotone min re-relaxation (the SSSP step) ----------
        def r_cond(s):
            return s[3] > 0 and s[2] < max_iters

        def r_step(s):
            d, ch, it, _ = s
            local, _ = sssp_mod.relax(arrays, d, ch, unit_weight=unit_weight)
            if trace:
                stats = flightrec.monoid_sync_stats(local, d, cfg, capacity)
            synced = sssp_mod._sync_dist(local, d, cfg, capacity, comm)
            improved = fr.pack(mono.ult(synced, d))
            n_imp = int(fr.popcount(improved[0]))
            out = (synced, improved, it + 1, n_imp)
            if not trace:
                return out, None
            row = flightrec.trace_row(t_rounds + it, stats[0], n_imp, 1, stats[1], stats[2],
                                      fr.changed_count(synced[0], d[0]))
            return out, (t_rounds + it, row)

        s = loop.host_while(r_cond, r_step, (dist, changed, 0, int(fr.popcount(changed[0]))),
                            trace_buffer=tbuf, level_ms=level_ms, sync=sync)
        dist, r_iters = s[0], s[2]

        touched = dist[0] != dist0[0]
        if taint_bits is not None:
            touched |= taint_bits
        out = (torch.gather(dist, 1, own), t_rounds + r_iters, int(touched.sum()))
        return out + (tbuf,) if trace else out

    return run


def compiled_repair_fn(pg: PartitionedGraph, cfg: SSSPConfig, *, unit_weight: bool = False,
                       with_taint: bool = True, device="cuda",
                       mesh: Optional[SimMesh] = None):
    """The module-cached repair program for this key (the same bounded-LRU
    program cache the engine's programs live in)."""
    from repro_torch.analytics import engine as eng

    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    return eng._cached(
        pg, dev, (id(pg), dev, "repair", cfg, unit_weight, with_taint, mesh),
        lambda: build_repair_fn(pg, cfg, unit_weight=unit_weight, with_taint=with_taint,
                                device=dev, mesh=mesh),
    )


LANE_BITS = fr.WORD_BITS


def build_repair_wave_fn(pg: PartitionedGraph, cfg: SSSPConfig, lane_words: int = 1, *,
                         unit_weight: bool = False, with_taint: bool = True,
                         device="cuda", mesh: Optional[SimMesh] = None):
    """Lane-packed repair: up to ``32 · lane_words`` prior rows repaired in
    ONE wave (the §13 result, replayed for repair: the sync round count —
    and most of the relax cost — is shared across lanes).

    Returns ``run(arrays, dist0, taint_seed, relax_seed, comm=None)`` with

    * ``dist0``      — ``uint32[dist_rows(pg), L]`` prior distances, one
      COLUMN per lane (``L = 32 · lane_words``; pad lanes all-UNREACHED),
    * ``taint_seed``/``relax_seed`` — lane-packed ``uint32[dist_rows(pg),
      lane_words]`` seed masks (bit ``b & 31`` of lane-word ``b >> 5`` =
      lane ``b`` seeded at that vertex row), all replicated (NumPy uint32
      or int32 tensors of the patterns).

    Output: owned distances ``int32[P, vmax, L]`` (uint32 patterns),
    iterations, and per-lane touched-vertex counts ``int64[L]``.  Pad lanes
    are inert: no seeds, all-unreached, zero touched.  Phase structure and
    the ``with_taint`` specialization match :func:`build_repair_fn`; each
    lane converges to its own from-scratch fixpoint, bit-exact per lane.

    Every simulated rank keeps the replicated ``[n_rows, L]`` distances, as
    the reference's ranks do; the per-edge ``[P, E, L]`` terms are
    evaluated in chunks of edge slots, about :data:`CHUNK_ELEMS` elements
    each (scatter-MIN and scatter-OR are associative, so the result is the
    same).
    """
    _check_weighted(pg, unit_weight)
    if lane_words < 1:
        raise ValueError(f"lane_words must be >= 1, got {lane_words}")
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    p, n_rows, vmax = pg.p, dist_rows(pg), pg.vmax
    lanes = lane_words * LANE_BITS
    capacity = cfg.resolved_capacity(n_rows * lanes)
    max_iters = cfg.max_iters if cfg.max_iters is not None else 1 << 30
    or_cfg = _or_cfg(cfg)
    own = owned_rows(pg, dev)[..., None].expand(p, vmax, lanes)
    step = max(1, CHUNK_ELEMS // (p * lanes))

    def run(arrays, dist0, taint_seed, relax_seed,
            comm: Optional[collectives.Communicator] = None):
        comm = mesh_comm(comm, mesh, dev)
        dist0 = _replicated(dist0, p, dev)  # [P, n_rows, L], one copy
        src, dst = arrays["edge_src"], arrays["edge_dst"]
        emask = _edge_mask(src, arrays["edge_count"])
        w_all = _weights(arrays, unit_weight)
        emax = src.shape[1]
        parts = [slice(lo, min(lo + step, emax)) for lo in range(0, emax, step)]

        def or_sync(words):
            """The OR sync on the flattened ``[P, n_rows * lane_words]``."""
            return _sync_frontier(words.reshape(p, -1), or_cfg, comm,
                                  use_kernels=True).reshape(p, n_rows, lane_words)

        def w_col(c):
            return 1 if unit_weight else w_all[:, c, None]

        def scatter_lanes(idx_of, masks_of):
            """OR the packed lane masks of every chunk into their rows."""
            out = torch.zeros((p, n_rows, lane_words), dtype=torch.int32, device=dev)
            for c in parts:
                out |= fr.scatter_or_lanes(n_rows, idx_of(c), masks_of(c))
            return out

        if with_taint:
            # -- Phase A, per lane: taint closure over tight edges; each
            # edge's tightness per lane, packed, holds for the whole phase
            tight_edge = torch.empty((p, src.shape[1], lane_words), dtype=torch.int32,
                                     device=dev)
            for c in parts:
                du = _lane_rows(dist0, src[:, c])
                dv = _lane_rows(dist0, dst[:, c])
                tight = emask[:, c, None] & (du != -1) & (
                    ((du.long() & _U32) + w_col(c)) & _U32 == (dv.long() & _U32))
                tight_edge[:, c] = fr.lane_pack(tight)
                del du, dv, tight

            def t_cond(s):
                return s[3] > 0

            def t_step(s):
                taint, front, rounds, _ = s
                prop = or_sync(scatter_lanes(
                    lambda c: dst[:, c],
                    lambda c: _lane_rows(front, src[:, c]) & tight_edge[:, c]))
                new = prop & ~taint
                return (taint | new, new, rounds + 1, int(fr.popcount(new[0]))), None

            seed = _replicated(taint_seed, p, dev)
            s = loop.host_while(t_cond, t_step, (seed, seed, 0, int(fr.popcount(seed[0]))))
            taint, t_rounds = s[0], s[2]
            del tight_edge, s
            taint_bits = fr.lane_unpack(taint)  # [P, n_rows, L]
            dist = torch.where(taint_bits, -1, dist0)
            taint_bits = taint_bits[0].clone()  # replicated: one rank's for the count

            def boundary(c):
                finite = emask[:, c, None] & (_lane_rows(dist, src[:, c]) != -1)
                return (_lane_rows(taint, dst[:, c]) & ~_lane_rows(taint, src[:, c])
                        & fr.lane_pack(finite))

            bnd = scatter_lanes(lambda c: src[:, c], boundary)
            changed = or_sync(_replicated(relax_seed, p, dev) | bnd)
            del bnd
        else:
            t_rounds, taint_bits = 0, None
            dist = dist0
            changed = _replicated(relax_seed, p, dev)

        # -- Phase B, per lane: monotone min re-relaxation ----------------
        def r_cond(s):
            return s[3] > 0 and s[2] < max_iters

        def r_step(s):
            d, ch, it, _ = s
            # scatter-MIN in the sign-biased order (uint32 order on int32)
            local = (d ^ mono._SIGN).contiguous()
            for c in parts:
                act = fr.lane_unpack(_lane_rows(ch, src[:, c])) & emask[:, c, None]
                ds = _lane_rows(d, src[:, c])
                nd = (ds.long() & _U32) + w_col(c)
                ok = act & (ds != -1) & (nd < 1 << 32)
                cand = torch.where(ok, nd, UNREACHED).to(torch.int32) ^ mono._SIGN
                idx = dst[:, c].long()[..., None].expand(cand.shape)
                local.scatter_reduce_(1, idx, cand, "amin")
                del act, ds, nd, ok, cand, idx
            local ^= mono._SIGN
            synced = sssp_mod._sync_dist(local.reshape(p, -1), d.reshape(p, -1), cfg,
                                         capacity, comm).reshape(p, n_rows, lanes)
            del local
            improved = fr.lane_pack(mono.ult(synced, d))
            return (synced, improved, it + 1, int(fr.popcount(improved[0]))), None

        s = loop.host_while(r_cond, r_step, (dist, changed, 0, int(fr.popcount(changed[0]))))
        dist, r_iters = s[0], s[2]
        del s, changed

        touched = dist[0] != dist0[0]  # [n_rows, L]
        if taint_bits is not None:
            touched |= taint_bits
        counts = touched.sum(0).cpu().numpy()
        return torch.gather(dist, 1, own), t_rounds + r_iters, counts

    return run


def compiled_repair_wave_fn(pg: PartitionedGraph, cfg: SSSPConfig, lane_words: int = 1, *,
                            unit_weight: bool = False, with_taint: bool = True,
                            device="cuda", mesh: Optional[SimMesh] = None):
    """The module-cached lane-packed repair program for this key."""
    from repro_torch.analytics import engine as eng

    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    return eng._cached(
        pg, dev,
        (id(pg), dev, "repair_wave", cfg, lane_words, unit_weight, with_taint, mesh),
        lambda: build_repair_wave_fn(pg, cfg, lane_words, unit_weight=unit_weight,
                                     with_taint=with_taint, device=dev, mesh=mesh),
    )


# ---------------------------------------------------------------------------
# Host-side seeding + end-to-end row repair
# ---------------------------------------------------------------------------


def repair_seeds(row: np.ndarray, update, *, unit_weight: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(relax_seed_ids, taint_seed_ids)`` for repairing ``row`` (global
    ``int64[n]`` distances, any sentinel ≥ INT32_MAX) after ``update``.

    BOTH empty proves the row unchanged: no inserted edge improves either
    endpoint and no deleted edge was tight — the zero-cost survival check
    of the partial-invalidation protocol (§16).  Finite distances are
    assumed < 2^31 (they are bounded by ``n · max_weight`` everywhere in
    this repo)."""
    d = np.asarray(row, dtype=np.int64)

    def _w(ws, size):
        if unit_weight or ws is None:
            return np.ones(size, dtype=np.int64)
        return ws.astype(np.int64)

    du = d[update.ins_src]
    dv = d[update.ins_dst]
    improving = (du < INF32) & (du + _w(update.ins_w, update.ins_src.size) < dv)
    relax_ids = update.ins_src[improving]

    du = d[update.del_src]
    dv = d[update.del_dst]
    tight = (du < INF32) & (du + _w(update.del_w, update.del_src.size) == dv)
    taint_ids = update.del_dst[tight]
    return relax_ids, taint_ids


def seed_words(ids: np.ndarray, nw: int) -> np.ndarray:
    """Vertex ids -> packed ``uint32[nw]`` seed bitmap."""
    words = np.zeros(nw, dtype=np.uint32)
    ids = np.asarray(ids, dtype=np.int64)
    np.bitwise_or.at(words, ids >> 5, (np.uint32(1) << (ids & 31).astype(np.uint32)))
    return words


def encode_distances(row: np.ndarray, n_rows: int) -> np.ndarray:
    """Global ``int64[n]`` distances (sentinel ≥ INT32_MAX) -> the repair
    buffer ``uint32[n_rows]`` (:data:`UNREACHED` sentinel, slack rows
    unreached)."""
    buf = np.full(n_rows, UNREACHED, dtype=np.uint32)
    row = np.asarray(row, dtype=np.int64)
    buf[: row.size] = np.where(row >= INF32, UNREACHED, row).astype(np.uint32)
    return buf


def repair_row(pg: PartitionedGraph, row: np.ndarray, update, cfg: SSSPConfig, *,
               unit_weight: bool = False, arrays: Optional[dict] = None,
               bfs_sentinel: Optional[bool] = None, device="cuda",
               comm: Optional[collectives.Communicator] = None,
               mesh: Optional[SimMesh] = None) -> Tuple[np.ndarray, int, int]:
    """Repair one cached distance row after ``update`` has been applied to
    ``pg``'s partition arrays.  Returns ``(new_row, touched, iters)`` —
    ``touched == 0`` means the row is proven unchanged (``new_row is
    row``); a seed-free proof costs NO device work.

    ``arrays`` are the placed post-update arrays (placed on ``device`` when
    omitted); ``comm`` collects the syncs' bytes per rank; ``mesh`` is the
    ranks' mesh, the syncs running over ``cfg.axes``.  ``bfs_sentinel``
    controls the unreached sentinel of the
    returned row (INT32_MAX for BFS levels, :data:`UNREACHED` for SSSP);
    defaults to ``unit_weight``."""
    relax_ids, taint_ids = repair_seeds(row, update, unit_weight=unit_weight)
    if relax_ids.size == 0 and taint_ids.size == 0:
        return row, 0, 0
    dev = resolve_device(device)
    if arrays is None:
        arrays = place_arrays(pg, device=dev)
    n_rows = dist_rows(pg)
    nw = n_rows // fr.WORD_BITS
    fn = compiled_repair_fn(pg, cfg, unit_weight=unit_weight,
                            with_taint=taint_ids.size > 0, device=dev, mesh=mesh)
    with device_lock(dev):
        d_owned, iters, count = fn(arrays, encode_distances(row, n_rows),
                                   seed_words(taint_ids, nw), seed_words(relax_ids, nw),
                                   comm)
        # copy out INSIDE the lock: the repair's work must not overlap
        # another engine's on the same device
        d_owned = d_owned.cpu()
    new_row = sssp_mod.assemble_distances(pg, d_owned)
    if unit_weight if bfs_sentinel is None else bfs_sentinel:
        new_row = np.where(new_row >= UNREACHED, INF32, new_row)
    return new_row, count, iters


def repair_rows(pg: PartitionedGraph, rows, update, cfg: SSSPConfig, *,
                unit_weight: bool = False, arrays: Optional[dict] = None,
                bfs_sentinel: Optional[bool] = None, max_repairs: Optional[int] = None,
                device="cuda", comm: Optional[collectives.Communicator] = None,
                mesh: Optional[SimMesh] = None):
    """Repair MANY prior rows against one update batch, lane-packed: rows
    proven unchanged on the host cost nothing; the suspects share one
    §16 repair wave per 32 lanes (a lone suspect takes the cheaper
    single-row program).  Returns ``[(new_row, touched, iters), ...]`` in
    input order — ``touched == 0`` means ``new_row is rows[i]``; suspects
    beyond ``max_repairs`` (the device-repair budget) return ``None``.
    ``comm`` collects the syncs' bytes per rank; ``mesh`` as
    :func:`repair_row`'s."""
    results = [None] * len(rows)
    suspects = []
    seeds = []
    for i, row in enumerate(rows):
        relax_ids, taint_ids = repair_seeds(row, update, unit_weight=unit_weight)
        if relax_ids.size == 0 and taint_ids.size == 0:
            results[i] = (row, 0, 0)
        elif max_repairs is None or len(suspects) < max_repairs:
            suspects.append(i)
            seeds.append((relax_ids, taint_ids))
    if not suspects:
        return results
    dev = resolve_device(device)
    if len(suspects) == 1:
        i = suspects[0]
        results[i] = repair_row(pg, rows[i], update, cfg, unit_weight=unit_weight,
                                arrays=arrays, bfs_sentinel=bfs_sentinel, device=dev,
                                comm=comm, mesh=mesh)
        return results
    if arrays is None:
        arrays = place_arrays(pg, device=dev)
    from repro_torch.analytics import msbfs

    n_rows = dist_rows(pg)
    use_bfs_sentinel = unit_weight if bfs_sentinel is None else bfs_sentinel
    for lo in range(0, len(suspects), LANE_BITS):
        chunk = suspects[lo : lo + LANE_BITS]
        lane_words = (len(chunk) + LANE_BITS - 1) // LANE_BITS
        lanes = lane_words * LANE_BITS
        dist0 = np.full((n_rows, lanes), UNREACHED, dtype=np.uint32)
        relax_w = np.zeros((n_rows, lane_words), dtype=np.uint32)
        taint_w = np.zeros((n_rows, lane_words), dtype=np.uint32)
        with_taint = False
        for b, i in enumerate(chunk):
            dist0[:, b] = encode_distances(rows[i], n_rows)
            relax_ids, taint_ids = seeds[lo + b]
            mask = np.uint32(1) << np.uint32(b & 31)
            relax_w[relax_ids, b >> 5] |= mask
            if taint_ids.size:
                taint_w[taint_ids, b >> 5] |= mask
                with_taint = True
        fn = compiled_repair_wave_fn(pg, cfg, lane_words, unit_weight=unit_weight,
                                     with_taint=with_taint, device=dev, mesh=mesh)
        with device_lock(dev):
            d_owned, it, counts = fn(arrays, dist0, taint_w, relax_w, comm)
            d_owned = d_owned.cpu().numpy().view(np.uint32)
        dist = msbfs.assemble_distances(pg, d_owned, lanes)
        for b, i in enumerate(chunk):
            new_row = dist[b]
            if use_bfs_sentinel:
                new_row = np.where(new_row >= UNREACHED, INF32, new_row)
            touched = int(counts[b])
            results[i] = (rows[i] if touched == 0 else new_row, touched, it)
    return results
