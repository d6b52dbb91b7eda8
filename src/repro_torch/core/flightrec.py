"""Traversal flight recorder (DESIGN.md §18).

The port of ``repro.core.flightrec``.  A traced traversal writes one row
per level into an ``int32[trace_levels, TRACE_COLS]`` buffer on the
device:

====  ===========  =====================================================
col   name         meaning
====  ===========  =====================================================
0     LEVEL        1-based level / iteration index (0 = row unwritten)
1     WORDS        densest rank's active-word count of the exchanged
                   buffer (nonzero words for OR syncs, changed-vs-ref
                   words for monoid syncs) — what the sparse dispatch
                   decides on
2     POP          bit population of the NEW frontier after the merge
                   (BFS/MS-BFS/BC: vertices discovered this level; SSSP:
                   distances improved this iteration)
3     DIR          direction: 0 = push, 1 = pull (SSSP/BC: 0)
4     BRANCH       sync branch taken: 0 dense, 1 sparse, 2 overflow-
                   fallback (dense-family syncs always report 0)
5     SHIPPED      active ``(word, value)`` pairs in the densest rank's
                   compaction when the sparse wire format ran, else 0
6     CHANGED      words the merge changed (OR: words gaining bits; MIN:
                   words lowered)
====  ===========  =====================================================

Vertex programs (:mod:`repro_torch.programs`) share the buffer and read
POP as the program's progress (PageRank: L1 residual in ppm; CC: labels
changed; k-core: vertices peeled; triangles: wedge hits) and DIR as its
phase (k-core: the peel threshold ``k``; others 0).

The statistics are computed on the device with the EXACT predicates the
collectives dispatch on (the maximum over ranks stands for the
reference's ``pmax``), so BRANCH is the branch the sync took; the rows
stay on the device and the host reads the buffer once, after the run.
Untraced runs compute none of it.

Host side, :class:`TraversalTrace` turns the buffer into per-level tables
and attributes wire bytes per level by the byte model of what the port
ships, which :func:`reconcile_bytes` checks against the
:class:`~repro_torch.core.collectives.Communicator`'s count, and
:func:`timed_bfs_levels` attaches each level's wall time.

On a hierarchical mesh the syncs run over the config's ``axes``, which
cover the mesh, so the counts above (maxima over all ranks) are the
reference's; the byte models take the axes' sizes (``axis_sizes``):
the full-buffer and sparse rounds run axis by axis and all-to-all ships
``sum(a - 1)`` buffers.  The reference's recorder models one flat axis of
``P`` ranks there, which over-counts all-to-all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import butterfly, collectives
from repro_torch.core import frontier as fr

TRACE_COLS = 7
COL_LEVEL = 0
COL_WORDS = 1
COL_POP = 2
COL_DIR = 3
COL_BRANCH = 4
COL_SHIPPED = 5
COL_CHANGED = 6

COL_NAMES = ("level", "words", "pop", "dir", "branch", "shipped", "changed")

BRANCH_DENSE = 0
BRANCH_SPARSE = 1
BRANCH_FALLBACK = 2

#: Default trace-buffer depth: the loop bound capped here.
DEFAULT_TRACE_LEVELS = 256

TRACE_SCHEMA = "traversal_trace/v1"
_DENSE_SYNCS = ("butterfly", "rabenseifner", "all_to_all", "xla")


def resolve_trace_levels(trace_levels: Optional[int], max_levels: int) -> int:
    """Buffer depth: explicit request wins; otherwise the loop bound capped
    at :data:`DEFAULT_TRACE_LEVELS`.  Levels beyond the buffer still RUN —
    their rows are dropped, never wrapped."""
    if trace_levels is not None:
        if trace_levels < 1:
            raise ValueError(f"trace_levels must be >= 1, got {trace_levels}")
        return int(trace_levels)
    return max(1, min(int(max_levels), DEFAULT_TRACE_LEVELS))


# ---------------------------------------------------------------------------
# Device-side helpers (on the EXACT pre-sync buffer the collectives see)
# ---------------------------------------------------------------------------


def or_sync_stats(buf: torch.Tensor, cfg):
    """``(words, branch, shipped)`` int32 0-d tensors for a bitmap OR sync
    of ``buf[P, ...]``, mirroring ``bfs._sync_frontier``'s dispatch: the
    adaptive sync's ``(popcount, nonzero words)`` pair and the sparse
    sync's overflow guard, over the flattened per-rank buffers.

    ``cfg`` is a :class:`~repro_torch.core.bfs.BFSConfig` (duck-typed:
    ``sync``, ``resolved_capacity``, ``density_threshold``)."""
    flat = buf.reshape(buf.shape[0], -1)
    n_words = flat.shape[1]
    nz = fr.count_nonzero(flat).max()
    zero = torch.zeros((), dtype=torch.int32, device=buf.device)
    if cfg.sync in _DENSE_SYNCS:
        return nz, zero, zero
    cap = cfg.resolved_capacity(n_words)
    if cfg.sync == "sparse":
        ok = nz <= cap
        branch = torch.where(ok, BRANCH_SPARSE, BRANCH_FALLBACK).to(torch.int32)
        return nz, branch, torch.where(ok, nz, zero)
    if cfg.sync == "adaptive":
        pops, _ = collectives.adaptive_counts(flat)
        go_sparse = (pops <= collectives.bits_limit(n_words, cfg.density_threshold)) \
            & (nz <= cap)
        return nz, go_sparse.to(torch.int32), torch.where(go_sparse, nz, zero)
    raise ValueError(f"unknown sync {cfg.sync!r}")


def monoid_sync_stats(new: torch.Tensor, prev, cfg, capacity: int):
    """``(words, branch, shipped)`` int32 0-d tensors for a monoid sync of
    ``new[P, ...]`` against the sparse reference ``prev`` (a per-rank
    ``[P, ...]`` buffer, or one every rank shares), mirroring the dispatch
    of SSSP's and the vertex programs' syncs: the changed-word count of the
    busiest rank against the capacity (``sparse``'s overflow guard) and
    against ``density_threshold`` of the words (``adaptive``).  ``cfg`` is
    an ``SSSPConfig`` or ``ProgramConfig``; ``capacity`` the resolved
    capacity the sync was given."""
    flat = new.reshape(new.shape[0], -1)
    ref = prev.reshape(-1) if prev.dim() < new.dim() else prev.reshape(flat.shape)
    n_words = flat.shape[1]
    changed = fr.changed_count(flat, ref).max()
    zero = torch.zeros((), dtype=torch.int32, device=new.device)
    if cfg.sync in ("butterfly", "all_to_all", "xla"):
        return changed, zero, zero
    cap = min(int(capacity), n_words)
    if cfg.sync == "sparse":
        ok = changed <= cap
        branch = torch.where(ok, BRANCH_SPARSE, BRANCH_FALLBACK).to(torch.int32)
        return changed, branch, torch.where(ok, changed, zero)
    if cfg.sync == "adaptive":
        go_sparse = (changed <= int(cfg.density_threshold * n_words)) & (changed <= cap)
        return changed, go_sparse.to(torch.int32), torch.where(go_sparse, changed, zero)
    raise ValueError(f"unknown sync {cfg.sync!r}")


def dense_sync_stats(buf: torch.Tensor):
    """Stats for an always-dense sync of ``buf[P, ...]`` (BC's
    non-idempotent ADD merge): nonzero words on the busiest rank, branch 0,
    nothing shipped sparse."""
    nz = fr.count_nonzero(buf.reshape(buf.shape[0], -1)).max()
    zero = torch.zeros((), dtype=torch.int32, device=buf.device)
    return nz, zero, zero


def trace_row(level, words, pop, direction, branch, shipped, changed) -> torch.Tensor:
    """One ``int32[TRACE_COLS]`` row on the device of its tensor arguments
    (LEVEL is stored 1-based so a zero LEVEL cell marks an unwritten row).
    Each column is a Python int or a 0-d tensor; ints are filled on the
    device, never copied from the host."""
    cols = (level + 1, words, pop, direction, branch, shipped, changed)
    dev = next(c.device for c in cols if isinstance(c, torch.Tensor))
    return torch.stack([
        c.to(torch.int32) if isinstance(c, torch.Tensor)
        else torch.full((), int(c), dtype=torch.int32, device=dev)
        for c in cols])


def record(tbuf: torch.Tensor, index: int, row: torch.Tensor) -> torch.Tensor:
    """Write ``row`` at ``index``; out-of-buffer levels drop silently."""
    if 0 <= index < tbuf.shape[0]:
        tbuf[index] = row
    return tbuf


def zeros(trace_levels: int, device="cuda") -> torch.Tensor:
    """An empty trace buffer on ``device`` (the card unless the caller
    asks for the CPU)."""
    from repro_torch.core.bfs import resolve_device

    return torch.zeros((trace_levels, TRACE_COLS), dtype=torch.int32,
                       device=resolve_device(device))


# ---------------------------------------------------------------------------
# Host-side trace object
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraversalTrace:
    """Per-level flight-recorder table of one traversal.

    ``data`` is the trimmed ``int32[levels, TRACE_COLS]`` buffer (see the
    module docstring for columns).  ``n_words`` / ``capacity`` describe the
    EXCHANGED buffer (the flattened word count the sync ran over), which is
    what the byte attribution is computed against.  ``wall_ms`` is per-level
    wall-clock when the trace came from :func:`timed_bfs_levels`.

    Byte attribution covers the level's frontier/distance/message sync;
    BC's dense sigma/delta ADD all-reduces (one per forward level, one per
    backward level) are reported in ``summary()['extra_dense_syncs']``.
    ``axis_sizes`` are the sizes of the mesh axes the sync ran over, in
    order (``None``: one axis of ``p`` ranks).
    """

    algo: str
    sync: str
    p: int
    fanout: int
    n_words: int
    capacity: int
    density_threshold: float = 0.02
    data: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, TRACE_COLS), np.int32)
    )
    wall_ms: Optional[np.ndarray] = None
    axis_sizes: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_buffer(cls, buf, *, algo: str, sync: str, p: int, fanout: int,
                    n_words: int, capacity: int, density_threshold: float = 0.02,
                    wall_ms=None, axis_sizes=None) -> "TraversalTrace":
        """Build from the raw buffer (``[L, COLS]``, a tensor or an array;
        or the reference's ``[P, L, COLS]``, whose row [0] is taken),
        trimming unwritten rows (LEVEL cell 0)."""
        if isinstance(buf, torch.Tensor):
            buf = buf.cpu().numpy()
        buf = np.asarray(buf)
        if buf.ndim == 3:
            buf = buf[0]
        if buf.ndim != 2 or buf.shape[1] != TRACE_COLS:
            raise ValueError(f"expected [levels, {TRACE_COLS}] buffer, "
                             f"got shape {buf.shape}")
        data = buf[buf[:, COL_LEVEL] > 0].astype(np.int32)
        if wall_ms is not None:
            wall_ms = np.asarray(wall_ms, dtype=np.float64)[: data.shape[0]]
        return cls(algo=algo, sync=sync, p=int(p), fanout=int(fanout),
                   n_words=int(n_words), capacity=int(capacity),
                   density_threshold=float(density_threshold), data=data,
                   wall_ms=wall_ms,
                   axis_sizes=None if axis_sizes is None else tuple(int(a) for a in axis_sizes))

    @property
    def levels(self) -> int:
        return int(self.data.shape[0])

    def word_density(self) -> np.ndarray:
        """Active-word fraction of the exchanged buffer per level."""
        return self.data[:, COL_WORDS].astype(np.float64) / max(self.n_words, 1)

    # -- byte attribution: what the port's collectives ship ----------------

    @property
    def sizes(self) -> Tuple[int, ...]:
        """The byte models' ranks: the axes' sizes, or ``(p,)``."""
        return self.axis_sizes if self.axis_sizes is not None else (self.p,)

    def _dense_bytes_per_node(self) -> float:
        """A dense level's bytes per rank.  Where the reference models a
        compiler-scheduled collective (``xla``: a ring estimate) the port
        counts what it ships: the all-gather's ``(G - 1)`` buffers, and for
        Rabenseifner the buffer zero-padded to a multiple of ``G`` words
        (``G`` the group of ``prod(sizes)`` ranks)."""
        nbytes = self.n_words * 4
        g = max(butterfly.group_size(self.sizes), 1)
        if self.sync == "rabenseifner":
            padded = -(-self.n_words // g) * g * 4
            return float(butterfly.bytes_per_node_rabenseifner(g, self.fanout, padded))
        if self.sync == "all_to_all":
            return float(butterfly.bytes_per_node_all_to_all(self.sizes, nbytes))
        if self.sync == "xla":
            return float(butterfly.bytes_per_node_allgather(self.sizes, nbytes))
        return float(butterfly.bytes_per_node_allreduce(self.sizes, self.fanout, nbytes))

    def _sparse_bytes_per_node(self) -> float:
        return float(butterfly.bytes_per_node_sparse(
            self.sizes, self.fanout, self.capacity, self.n_words))

    def level_bytes_per_node(self) -> np.ndarray:
        """Wire bytes per rank per level: sparse levels pay the §12
        capacity-growth schedule, dense and overflow-fallback levels the
        dense sync (the fallback predicate fires BEFORE any compaction
        ships, so a fallback level costs exactly a dense level)."""
        dense = self._dense_bytes_per_node()
        sparse = self._sparse_bytes_per_node()
        return np.where(self.data[:, COL_BRANCH] == BRANCH_SPARSE, sparse, dense)

    def level_table(self) -> List[Dict]:
        """One dict per level — the human-facing flight log."""
        bytes_per_node = self.level_bytes_per_node()
        density = self.word_density()
        out = []
        for i in range(self.levels):
            row = {name: int(self.data[i, c]) for c, name in enumerate(COL_NAMES)}
            row["density"] = float(density[i])
            row["bytes_per_node"] = float(bytes_per_node[i])
            if self.wall_ms is not None and i < self.wall_ms.size:
                row["wall_ms"] = float(self.wall_ms[i])
            out.append(row)
        return out

    def summary(self) -> Dict:
        branch = self.data[:, COL_BRANCH]
        out = {
            "algo": self.algo,
            "sync": self.sync,
            "p": self.p,
            "fanout": self.fanout,
            "n_words": self.n_words,
            "capacity": self.capacity,
            "levels": self.levels,
            "total_pop": int(self.data[:, COL_POP].sum()),
            "dense_levels": int((branch == BRANCH_DENSE).sum()),
            "sparse_levels": int((branch == BRANCH_SPARSE).sum()),
            "fallback_levels": int((branch == BRANCH_FALLBACK).sum()),
            "pull_levels": int((self.data[:, COL_DIR] == 1).sum()),
            "bytes_per_node_total": float(self.level_bytes_per_node().sum()),
        }
        if self.algo == "bc":
            out["extra_dense_syncs"] = 2 * self.levels
        if self.wall_ms is not None:
            out["wall_ms_total"] = float(self.wall_ms.sum())
        return out

    def to_dict(self) -> Dict:
        """JSON-ready form (the ``--trace`` / ``--stats-json`` payload)."""
        return {"schema": TRACE_SCHEMA, **self.summary(),
                "per_level": self.level_table()}


def trace_chrome_doc(trace: TraversalTrace) -> Dict:
    """Render one :class:`TraversalTrace` as a Perfetto/Chrome
    ``trace_event`` document on one ``traversal`` track.  Levels with a
    measured wall clock (:func:`timed_bfs_levels`) become duration spans
    laid end to end; without one each level is an instant at ``level`` ms —
    durations are never fabricated."""
    branch_names = {BRANCH_DENSE: "dense", BRANCH_SPARSE: "sparse",
                    BRANCH_FALLBACK: "fallback"}
    events = [{"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
               "args": {"name": "traversal"}}]
    t = 0.0
    for i, row in enumerate(trace.level_table(), start=1):
        ev = {"name": (f"L{row['level']} {branch_names[row['branch']]}"
                       f"{' pull' if row['dir'] else ''}"),
              "cat": trace.algo, "pid": 1, "tid": 1,
              "args": dict(row, span_id=f"{i:08x}")}
        if "wall_ms" in row:
            ev.update(ph="X", ts=int(round(t * 1e3)),
                      dur=max(int(round((t + row["wall_ms"]) * 1e3))
                              - int(round(t * 1e3)), 0))
            t += row["wall_ms"]
        else:
            ev.update(ph="i", s="t", ts=int(round(row["level"] * 1e3)))
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA, **trace.summary()}}


def reconcile_bytes(trace: TraversalTrace, bytes_sent, *,
                    forward_only: bool = False) -> Dict:
    """Check the trace's per-level byte attribution against what the
    ranks really shipped: the sum over the traced levels of the model's
    bytes per rank must equal every rank's
    :attr:`Communicator.bytes_sent` over the same run exactly (the
    counterpart of the reference's check against the compiled HLO).
    Holds for the traces of BFS, MS-BFS, SSSP and the vertex programs,
    whose one sync a level is the traced one; a BC trace leaves its dense
    ADD syncs out of the rows, so it is refused unless ``forward_only``
    says ``bytes_sent`` counts the forward OR syncs alone (a Communicator
    of their own: ``build_bc_fn``'s ``or_comm``).
    Returns ``{"model": {...}, "measured": [...], "matches": bool}``."""
    if trace.algo == "bc" and not forward_only:
        raise ValueError("a BC trace covers the forward OR sync only; its "
                         "dense ADD syncs are not in the rows")
    per_level = trace.level_bytes_per_node()
    model = {"dense": trace._dense_bytes_per_node(),
             "sparse": trace._sparse_bytes_per_node(),
             "total": float(per_level.sum())}
    measured = [int(b) for b in np.asarray(bytes_sent)]
    return {"model": model, "measured": measured,
            "matches": all(b == model["total"] for b in measured)}


# ---------------------------------------------------------------------------
# Convenience entry points
# ---------------------------------------------------------------------------


def _bfs_parts(pg, cfg, arrays, layout, device):
    from repro_torch.core import bfs as bfs_mod
    from repro_torch.kernels import blocks

    dev = bfs_mod.resolve_device(device)
    if cfg.use_kernels and layout is None:
        if arrays is not None:
            raise ValueError("use_kernels=True with placed arrays needs the layout "
                             "they were placed with")
        layout = blocks.build_bfs_layout(pg)
    if arrays is None:
        arrays = bfs_mod.place_arrays(pg, layout, device=dev)
    return dev, arrays, layout


def axis_sizes(cfg, mesh=None) -> Optional[Tuple[int, ...]]:
    """The sizes of ``cfg.axes`` on ``mesh`` (``None`` without a mesh: one
    axis of the partition's ranks)."""
    return None if mesh is None else tuple(mesh.shape[a] for a in cfg.axes)


def _trace(pg, cfg, tbuf, wall_ms=None, mesh=None) -> TraversalTrace:
    return TraversalTrace.from_buffer(
        tbuf, algo="bfs", sync=cfg.sync, p=pg.p, fanout=cfg.fanout,
        n_words=pg.n_words, capacity=cfg.resolved_capacity(pg.n_words),
        density_threshold=cfg.density_threshold, wall_ms=wall_ms,
        axis_sizes=axis_sizes(cfg, mesh))


def traced_bfs(pg, root: int, cfg, *, trace_levels: Optional[int] = None,
               comm=None, device="cuda", mesh=None):
    """End-to-end single-source BFS with the flight recorder on (on
    ``mesh``, as :func:`repro_torch.core.bfs.build_bfs_fn`).

    Returns ``(dist int64[n], levels, scanned, TraversalTrace)`` — the
    first three exactly as :func:`repro_torch.core.bfs.distributed_bfs`."""
    from repro_torch.core import bfs as bfs_mod

    dev, arrays, layout = _bfs_parts(pg, cfg, None, None, device)
    fn = bfs_mod.build_bfs_fn(pg, cfg, layout, device=dev, trace=True,
                              trace_levels=trace_levels, mesh=mesh)
    d_owned, levels, scanned, tbuf = fn(arrays, root, comm)
    return (bfs_mod.assemble_distances(pg, d_owned), levels, scanned,
            _trace(pg, cfg, tbuf, mesh=mesh))


def timed_bfs_levels(pg, cfg, root: int, *, arrays=None, layout=None,
                     trace_levels: Optional[int] = None, warmup: bool = True,
                     device="cuda", mesh=None):
    """Host-timed BFS: each level's wall time, the clock stopping after
    ``torch.cuda.synchronize()`` (on the card), beside the flight
    recorder's row.  The host loop already runs one level per host
    iteration, so the traversal is the one :func:`traced_bfs` runs, with a
    device synchronisation added after each level.

    Returns ``(dist int64[n], TraversalTrace)`` with ``wall_ms`` filled;
    the distances equal the untimed run's.  The synchronisation adds an
    idle device per level, so read the per-level times as RELATIVE
    weights (an untimed run's total is the honest absolute)."""
    from repro_torch.core import bfs as bfs_mod

    dev, arrays, layout = _bfs_parts(pg, cfg, arrays, layout, device)
    fn = bfs_mod.build_bfs_fn(pg, cfg, layout, device=dev, trace=True,
                              trace_levels=trace_levels, mesh=mesh)
    if warmup:
        fn(arrays, root)
    walls: List[float] = []
    d_owned, _, _, tbuf = fn(arrays, root, level_ms=walls)
    return bfs_mod.assemble_distances(pg, d_owned), _trace(pg, cfg, tbuf, walls, mesh)
