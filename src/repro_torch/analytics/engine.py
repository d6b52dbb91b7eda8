"""Batched traversal query engine (DESIGN.md §13/§14).

The port of ``repro.analytics.engine``.  All set-up happens ONCE, up
front: the partition's arrays are placed on the device at construction,
and one built program per ``(graph, device, algo, config, lanes)`` is
cached module-wide.  Query streams are then packed into fixed-width waves
(pad lanes carry root ``-1`` and cost nothing: their bit-lanes never
activate), so every wave reuses the same program at the same shapes.

Four query families share the placed arrays and the cache:

* ``query``          — BFS distances, B bit-lanes per wave (§13),
* ``sssp``           — weighted distances, one butterfly-min program reused
                       across the root stream (§14),
* ``betweenness``    — Brandes dependency waves, B lanes per wave,
                       accumulated across waves (§14),
* ``vertex_program`` — §19 gather-apply-scatter analytics (pagerank / cc /
                       tri / kcore), one program per algo+config,
                       warm-startable via ``arg`` (the §16 re-push path).

Where the reference takes a mesh, the port takes a device: the P ranks
are simulated on it, and the cache key holds the device in place of the
mesh's identity.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import programs
from repro_torch.analytics import msbfs
from repro_torch.core import metrics as metrics_mod
from repro_torch.core.bfs import BFSConfig, place_arrays, resolve_device, resolve_mesh
from repro_torch.core.devlock import device_lock
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.traversal import bc as bc_mod
from repro_torch.traversal import sssp as sssp_mod
from repro_torch.traversal.sssp import SSSPConfig

# Registry-backed engine observability (DESIGN.md §20), host-side only.
_REG = metrics_mod.default_registry()
_CACHE_EVENTS = _REG.counter(
    "engine_program_cache_total",
    "built-program cache events (hit / miss / evict)", ("event",))
_BUILDS = _REG.counter(
    "engine_program_builds_total",
    "program constructions on cache miss, by algo", ("algo",))
_BUILD_SECONDS = _REG.histogram(
    "engine_program_build_seconds", "wall time of each program build",
    buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
_WAVES = _REG.counter(
    "engine_waves_total", "program invocations, by algo", ("algo",))
_DEDUPED = _REG.counter(
    "engine_deduped_roots_total",
    "duplicate roots folded out of waves before lane packing")

# Program cache: (graph identity, device, algo, cfg, lanes) -> (fn, pg,
# device).  Configs are frozen dataclasses, so they hash by value; graphs
# hash by identity (re-partitioning a graph is a new program).  Each entry
# keeps a STRONG reference to its graph so a live key's id() can never be
# recycled onto a different object.  Bounded LRU: hits refresh recency,
# eviction drops the coldest program.
_PROGRAM_CACHE: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_PROGRAM_CACHE_MAX = 32


_REG.gauge(
    "engine_program_cache_size", "live entries in the program cache"
).set_function(lambda: len(_PROGRAM_CACHE))


def _cached(pg, device, key: Tuple, build: Callable[[], object]):
    entry = _PROGRAM_CACHE.get(key)
    if entry is not None and entry[1] is pg and entry[2] == device:
        _PROGRAM_CACHE.move_to_end(key)
        _CACHE_EVENTS.inc(event="hit")
        return entry[0]
    _CACHE_EVENTS.inc(event="miss")
    t0 = time.perf_counter()
    fn = build()
    _BUILD_SECONDS.observe(time.perf_counter() - t0)
    _BUILDS.inc(algo=str(key[2]) if len(key) > 2 else "?")
    while len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.popitem(last=False)
        _CACHE_EVENTS.inc(event="evict")
    _PROGRAM_CACHE[key] = (fn, pg, device)
    return fn


def compiled_wave_fn(pg: PartitionedGraph, device, cfg: BFSConfig, lanes: int,
                     mesh: Optional[SimMesh] = None):
    """The cached MS-BFS wave program for this key."""
    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    return _cached(pg, dev, (id(pg), dev, "bfs", cfg, lanes, mesh),
                   lambda: msbfs.build_msbfs_fn(pg, cfg, lanes, device=dev, mesh=mesh))


def compiled_sssp_fn(pg: PartitionedGraph, device, cfg: SSSPConfig,
                     mesh: Optional[SimMesh] = None):
    """The cached distributed-SSSP program for this key."""
    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    return _cached(pg, dev, (id(pg), dev, "sssp", cfg, mesh),
                   lambda: sssp_mod.build_sssp_fn(pg, cfg, device=dev, mesh=mesh))


def compiled_bc_fn(pg: PartitionedGraph, device, cfg: BFSConfig, lanes: int,
                   mesh: Optional[SimMesh] = None):
    """The cached betweenness-centrality wave program for this key."""
    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    return _cached(pg, dev, (id(pg), dev, "bc", cfg, lanes, mesh),
                   lambda: bc_mod.build_bc_fn(pg, cfg, lanes, device=dev, mesh=mesh))


def compiled_program_fn(pg: PartitionedGraph, device, algo: str,
                        cfg: "programs.ProgramConfig", mesh: Optional[SimMesh] = None):
    """The cached §19 vertex program for this key (warm starts reuse it —
    only the operand differs)."""
    dev, mesh = resolve_device(device), resolve_mesh(pg.p, cfg.axes, mesh)
    prog = programs.by_name(algo)
    return _cached(pg, dev, (id(pg), dev, "vp:" + algo, cfg, mesh),
                   lambda: programs.build_program_fn(pg, prog, cfg, device=dev, mesh=mesh))


@dataclasses.dataclass
class EngineStats:
    queries: int = 0
    waves: int = 0
    deduped_roots: int = 0  # duplicate roots folded out of waves (§15)
    scanned_edges: float = 0.0  # aggregate over lanes, honest TEPS numerator
    max_levels: int = 0
    sssp_queries: int = 0
    relaxed_edges: float = 0.0  # SSSP relaxation analogue of scanned_edges
    bc_sources: int = 0
    program_runs: int = 0  # §19 vertex-program executions
    program_iters: int = 0  # gather/sync/apply rounds across those runs
    program_edges: float = 0.0  # edges examined by vertex programs


class BFSQueryEngine:
    """Accepts streams of root queries, answers with distance vectors.

    ``lanes`` is the wave width (bit-lanes per wave; 32 fills one lane
    word).  Queries are packed greedily: ``ceil(len(roots)/lanes)`` waves
    per batch, each one call of the cached program.  ``device`` holds the
    placed arrays and runs every program (the card unless the caller asks
    for the CPU); ``mesh`` is the ranks' mesh, every program syncing over
    ``cfg.axes`` (:func:`~repro_torch.core.bfs.resolve_mesh`).
    """

    def __init__(self, pg: PartitionedGraph, cfg: BFSConfig = BFSConfig(), *,
                 lanes: int = 32, device="cuda", mesh: Optional[SimMesh] = None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.pg = pg
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(pg.p, cfg.axes, mesh)
        self.cfg = cfg
        self.lanes = lanes
        self.stats = EngineStats()
        self._arrays = place_arrays(pg, device=self.device)
        self._fn = compiled_wave_fn(pg, self.device, cfg, lanes, self.mesh)

    def refresh_arrays(self) -> None:
        """Re-place the partition arrays after an IN-PLACE host mutation
        (``dynamic.delta.apply_update_to_partition``, DESIGN.md §16).  The
        partition object — hence every program keyed on its identity — is
        unchanged: shapes are static, only values moved."""
        self._arrays = place_arrays(self.pg, device=self.device)

    def _run_wave(self, roots: np.ndarray) -> np.ndarray:
        padded = np.full(self.lanes, -1, dtype=np.int64)
        padded[: roots.size] = roots
        with device_lock(self.device):
            d_owned, levels, scanned = self._fn(self._arrays, padded)
            # copy out INSIDE the lock: the wave's work must not overlap
            # another engine's on the same device; pad lanes stay behind
            d_owned = d_owned[..., : roots.size].cpu().numpy()
        self.stats.waves += 1
        _WAVES.inc(algo="bfs")
        self.stats.scanned_edges += float(scanned)
        self.stats.max_levels = max(self.stats.max_levels, int(levels))
        return msbfs.assemble_distances(self.pg, d_owned, roots.size)

    def _checked_ids(self, ids: Sequence[int], what: str) -> np.ndarray:
        """Shared query-path validation: non-empty 1-D int32 vertex ids in
        ``[0, n)`` (pad lanes are an engine-internal detail — callers never
        pass ``-1``)."""
        ids = np.asarray(ids, dtype=np.int32)
        if ids.ndim != 1 or ids.size == 0:
            raise ValueError(f"{what}s must be a non-empty 1-D sequence")
        if np.any((ids < 0) | (ids >= self.pg.n)):
            raise ValueError(f"{what} out of range [0, {self.pg.n}): {ids}")
        return ids

    def query(self, roots: Sequence[int]) -> np.ndarray:
        """Distances for every root: ``int64[len(roots), n]`` (INT32_MAX for
        unreached), in query order.

        Duplicate roots are folded before lane packing — each DISTINCT root
        occupies one lane and every duplicate reads the shared result row —
        so a hot root repeated across a batch burns one lane, not many
        (``stats.deduped_roots`` counts the folds)."""
        roots = self._checked_ids(roots, "root")
        uniq, inverse = np.unique(roots, return_inverse=True)
        out: List[np.ndarray] = []
        for lo in range(0, uniq.size, self.lanes):
            out.append(self._run_wave(uniq[lo : lo + self.lanes]))
        self.stats.queries += int(roots.size)
        self.stats.deduped_roots += int(roots.size - uniq.size)
        _DEDUPED.inc(int(roots.size - uniq.size))
        return np.concatenate(out, axis=0)[inverse]

    def query_one(self, root: int) -> np.ndarray:
        """Single-root convenience: ``int64[n]`` distances."""
        return self.query([root])[0]

    def profile(self, root: int = 0, *, iters: int = 3, layout=None) -> Dict:
        """§20 cost-model profile: a deep (timed, byte-reconciled) profile
        of the single-source program from ``root``, plus the byte
        reconciliation of every program cached for this graph and device
        (:func:`repro_torch.core.profiler.cache_report`).  Returns
        ``{"program": ProgramProfile, "cache": [CacheEntryReport, ...]}``.

        The wave config cannot carry the kernels (MS-BFS refuses
        ``use_kernels=True``), so on a CUDA device, or wherever a kernel
        ``layout`` of the partition is given, the profiled program is the
        engine's config with ``use_kernels=True``: the kernel path, over
        the engine's placed arrays and the layout's planes (the layout is
        built when not given).  On the CPU without a layout it is the
        plain program of the engine's config."""
        from repro_torch.core import bfs as bfs_mod
        from repro_torch.core import profiler
        from repro_torch.kernels import blocks

        cfg, arrays = self.cfg, self._arrays
        if layout is not None or self.device.type == "cuda":
            cfg = dataclasses.replace(cfg, use_kernels=True)
            if layout is None:
                layout = blocks.build_bfs_layout(self.pg)
            arrays = {**arrays, **bfs_mod.place_layout(layout, device=self.device)}
        with device_lock(self.device):
            prof = profiler.profile_bfs(self.pg, cfg, int(root), iters=iters,
                                        arrays=arrays, layout=layout, device=self.device,
                                        mesh=self.mesh)
            del arrays
            cache = profiler.cache_report(self, root=int(root))
        return {"program": prof, "cache": cache}

    # --- weighted traversals (DESIGN.md §14) ------------------------------

    def _sssp_cfg(self, cfg: Optional[SSSPConfig]) -> SSSPConfig:
        if cfg is not None:
            return cfg
        if self.cfg.sync not in sssp_mod.SYNCS:
            # never silently coerce: a 'rabenseifner' engine would
            # otherwise measure 'butterfly'
            raise ValueError(
                f"engine sync {self.cfg.sync!r} has no SSSP equivalent "
                f"(expected one of {sssp_mod.SYNCS}); pass an explicit "
                "SSSPConfig"
            )
        return SSSPConfig(
            axes=self.cfg.axes, fanout=self.cfg.fanout, sync=self.cfg.sync,
            sparse_capacity=self.cfg.sparse_capacity,
            density_threshold=self.cfg.density_threshold,
        )

    def sssp(self, roots: Sequence[int], cfg: Optional[SSSPConfig] = None) -> np.ndarray:
        """Weighted distances for every root: ``int64[len(roots), n]``
        (:data:`repro_torch.traversal.sssp.UNREACHED` for unreachable), in
        query order.  One program serves the whole stream; ``cfg`` defaults
        to the engine's BFS knobs lifted to :class:`SSSPConfig`."""
        roots = self._checked_ids(roots, "root")
        cfg = self._sssp_cfg(cfg)
        fn = compiled_sssp_fn(self.pg, self.device, cfg, self.mesh)
        out = np.empty((roots.size, self.pg.n), dtype=np.int64)
        for i, r in enumerate(roots):
            with device_lock(self.device):
                d_owned, _, relaxed = fn(self._arrays, int(r))
                d_owned = d_owned.cpu()
            out[i] = sssp_mod.assemble_distances(self.pg, d_owned)
            self.stats.relaxed_edges += float(relaxed)
            _WAVES.inc(algo="sssp")
        self.stats.sssp_queries += int(roots.size)
        return out

    def betweenness(self, sources: Sequence[int]) -> np.ndarray:
        """Betweenness centrality accumulated over ``sources``:
        ``float64[n]``.  Sources pack into ``lanes``-wide Brandes waves
        (pad lanes carry ``-1``); one program serves every wave."""
        sources = self._checked_ids(sources, "source")
        fn = compiled_bc_fn(self.pg, self.device, self.cfg, self.lanes, self.mesh)
        bc = np.zeros(self.pg.n, dtype=np.float64)
        for lo in range(0, sources.size, self.lanes):
            chunk = sources[lo : lo + self.lanes]
            padded = np.full(self.lanes, -1, dtype=np.int64)
            padded[: chunk.size] = chunk
            with device_lock(self.device):
                bc_owned, depth, scanned = fn(self._arrays, padded)
                bc_owned = bc_owned.cpu()
            bc += bc_mod.assemble_bc(self.pg, bc_owned)
            self.stats.waves += 1
            _WAVES.inc(algo="bc")
            self.stats.scanned_edges += float(scanned)
            self.stats.max_levels = max(self.stats.max_levels, int(depth))
        self.stats.bc_sources += int(sources.size)
        return bc

    # --- vertex programs (DESIGN.md §19) ----------------------------------

    def _program_cfg(self, cfg: Optional["programs.ProgramConfig"]
                     ) -> "programs.ProgramConfig":
        if cfg is not None:
            return cfg
        if self.cfg.sync not in programs.SYNCS:
            # same no-silent-coercion rule as _sssp_cfg
            raise ValueError(
                f"engine sync {self.cfg.sync!r} has no vertex-program "
                f"equivalent (expected one of {programs.SYNCS}); pass an "
                "explicit ProgramConfig"
            )
        return programs.ProgramConfig(
            axes=self.cfg.axes, fanout=self.cfg.fanout, sync=self.cfg.sync,
            sparse_capacity=self.cfg.sparse_capacity,
            density_threshold=self.cfg.density_threshold,
        )

    def vertex_program(self, algo: str, cfg: Optional["programs.ProgramConfig"] = None,
                       *, arg=None) -> np.ndarray:
        """Run one §19 vertex program to convergence; returns its global
        result vector (``pagerank``: float64 ranks; ``cc``: int64 min
        labels; ``tri``: int64 per-vertex triangle counts; ``kcore``:
        int64 core numbers).  ``arg`` warm-starts convergence-style
        programs (the §16 re-push seed); ``cfg`` defaults to the engine's
        BFS knobs lifted to :class:`~repro_torch.programs.ProgramConfig`."""
        result, _, _ = self.run_program(algo, cfg, arg=arg)
        return result

    def run_program(self, algo: str, cfg: Optional["programs.ProgramConfig"] = None,
                    *, arg=None):
        """:meth:`vertex_program` plus the convergence accounting:
        ``(result, iters, edges_examined)`` — the repair path reads
        ``iters`` for the §16 re-push-vs-recompute ledger."""
        prog = programs.by_name(algo)
        cfg = self._program_cfg(cfg)
        fn = compiled_program_fn(self.pg, self.device, algo, cfg, self.mesh)
        if arg is None:
            arg = prog.default_arg(self.pg, self.device)
        with device_lock(self.device):
            out = fn(self._arrays, arg)
            # copy out INSIDE the lock (same rule as _run_wave)
            result = prog.assemble(self.pg, out[0])
        iters = int(out[prog.n_outputs])
        work = float(out[prog.n_outputs + 1])
        self.stats.program_runs += 1
        self.stats.program_iters += iters
        self.stats.program_edges += work
        _WAVES.inc(algo="vp:" + algo)
        return result, iters, work
