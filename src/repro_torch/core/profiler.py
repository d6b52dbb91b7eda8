"""Per-program cost-model profiler (DESIGN.md §20).

The port of ``repro.core.profiler``.  It joins three sources of truth
about one traversal program:

* the §12 byte model (``flightrec.TraversalTrace``): what the butterfly
  exchange should move a rank a level;
* what the ranks really shipped: the
  :class:`~repro_torch.core.collectives.Communicator`'s count, where the
  reference reads the compiled HLO (this backend has none);
* host wall clock: the program's minimum over ``iters`` runs, each ending
  in a device synchronisation, and per-level times from
  ``flightrec.timed_bfs_levels`` (relative weights).

The join gives achieved against modeled GTEP/s, a wire efficiency (model
bytes over shipped bytes: exactly 1.0 when the model reconciles, the
acceptance bar) and a per-level time × bytes table.  The JSON keeps the
reference's fields: ``hlo_bytes`` holds the bytes a rank shipped, as the
Communicator counted them.

The roofline (:func:`repro_torch.launch.hlo_stats.roofline`, whose H100
constants it uses) has no XLA cost analysis to read.  Its memory term is
the least bytes the run's kernel launches must move
(:mod:`..kernels.bounds`, the count the kernels' bounds use), tallied in
the kernel wrappers on both routes; a program run without the kernels
tallies nothing there.  BFS does no floating-point work, so the compute
term is 0.  The network term is the bytes a rank shipped over an NVLink 4
link's rate.

``cache_report`` reconciles every program of the engine's module-wide
cache that belongs to the engine's graph and device: each is run once
more as a traced twin (the same config with the flight recorder on, built
outside the cache) from one root on a fresh Communicator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.launch import hlo_stats
from repro_torch.launch.hlo_stats import HBM_BW as HBM_BYTES_PER_S
from repro_torch.launch.hlo_stats import LINK_BW as NVLINK_BYTES_PER_S

__all__ = [
    "LevelRow",
    "ProgramProfile",
    "CacheEntryReport",
    "profile_bfs",
    "cache_report",
    "format_profile",
    "HBM_BYTES_PER_S",
    "NVLINK_BYTES_PER_S",
]



@dataclasses.dataclass
class LevelRow:
    """One level of the time×bytes attribution table."""

    level: int
    branch: str  # dense / sparse / fallback
    direction: str  # push / pull
    pop: int
    density: float
    bytes_per_node: float
    wall_ms: float
    time_frac: float  # share of segmented wall clock
    bytes_frac: float  # share of analytic wire bytes

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProgramProfile:
    """The profiler's verdict on one single-source BFS program."""

    algo: str
    sync: str
    p: int
    fanout: int
    levels: int
    n_words: int
    capacity: int
    scanned_edges: float
    wall_ms: float  # whole program, min of k timed runs
    wall_ms_levels: float  # segmented per-level total (device sync inflated)
    achieved_gteps: float
    modeled_gteps: float
    model_bytes: Dict[str, float]  # analytic dense/sparse/total bytes a rank
    hlo_bytes: Dict[str, float]  # bytes a rank shipped (Communicator count)
    reconciled: bool  # model == shipped exactly, every rank
    wire_efficiency: float  # Σ analytic level bytes / Σ shipped bytes
    roofline: Dict
    per_level: List[LevelRow]

    def to_dict(self) -> Dict:
        out = dataclasses.asdict(self)
        out["per_level"] = [r.to_dict() for r in self.per_level]
        return out

    def table(self) -> str:
        return format_profile(self)


@dataclasses.dataclass
class CacheEntryReport:
    """Reconciliation of one cached engine program (by a traced twin)."""

    algo: str
    sync: str
    lanes: Optional[int]
    n_words: int
    capacity: int
    supported: bool  # byte model stated for this program shape
    reconciled: bool
    model_bytes: Dict[str, float]
    hlo_bytes: Dict[str, float]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


_BRANCH_NAMES = {0: "dense", 1: "sparse", 2: "fallback"}


def _per_level_rows(trace) -> List[LevelRow]:
    from repro_torch.core import flightrec

    bytes_per_node = trace.level_bytes_per_node()
    density = trace.word_density()
    total_bytes = float(bytes_per_node.sum()) or 1.0
    walls = (np.asarray(trace.wall_ms, dtype=np.float64)
             if trace.wall_ms is not None else np.zeros(trace.levels))
    total_wall = float(walls.sum()) or 1.0
    rows = []
    for i in range(trace.levels):
        branch = int(trace.data[i, flightrec.COL_BRANCH])
        rows.append(LevelRow(
            level=int(trace.data[i, flightrec.COL_LEVEL]),
            branch=_BRANCH_NAMES.get(branch, str(branch)),
            direction="pull" if trace.data[i, flightrec.COL_DIR] else "push",
            pop=int(trace.data[i, flightrec.COL_POP]),
            density=float(density[i]),
            bytes_per_node=float(bytes_per_node[i]),
            wall_ms=float(walls[i]) if i < walls.size else 0.0,
            time_frac=float(walls[i]) / total_wall if i < walls.size else 0.0,
            bytes_frac=float(bytes_per_node[i]) / total_bytes,
        ))
    return rows


def _shipped(rec: Dict) -> Dict[str, float]:
    """The reconciliation's measured side: rank 0's bytes (every rank's
    must equal the model for ``matches``)."""
    return {"total": float(rec["measured"][0]) if rec["measured"] else 0.0}


def roofline(least_bytes: float, wire_bytes: float) -> Dict:
    """The H100 roofline of one run: ``least_bytes`` the run's kernel
    launches must move, ``wire_bytes`` a rank ships.  The reference's
    fields, the terms in seconds, ``dominant`` the largest term and
    ``step_time`` their maximum."""
    return hlo_stats.roofline(0.0, least_bytes, wire_bytes).to_dict()


def profile_bfs(pg, cfg, root: int, *, iters: int = 3, arrays=None, layout=None,
                device="cuda", mesh=None) -> ProgramProfile:
    """Profile the single-source BFS program for ``(pg, cfg)`` on ``device``,
    the kernels included when ``cfg.use_kernels``.

    Builds the UNINSTRUMENTED program (``trace=False``, what production
    runs) and times it min-of-``iters``, each run ending in a device
    synchronisation; runs it once more on a fresh Communicator with the
    kernels' least bytes tallied; re-runs it level by level for the
    per-level wall clock and flight-recorder rows; and reconciles the byte
    model against the Communicator's count exactly.  ``arrays`` (placed
    with ``layout`` when the kernels run) are placed when not given;
    ``mesh`` is the ranks' mesh (:func:`~repro_torch.core.bfs.resolve_mesh`),
    whose axes' sizes the byte model takes."""
    from repro_torch.core import bfs as bfs_mod
    from repro_torch.core import collectives, flightrec
    from repro_torch.kernels import bounds

    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev, arrays, layout = flightrec._bfs_parts(pg, cfg, arrays, layout, device)
    mesh = bfs_mod.resolve_mesh(pg.p, cfg.axes, mesh)
    sync = bfs_mod.device_sync(dev)
    fn = bfs_mod.build_bfs_fn(pg, cfg, layout, device=dev, mesh=mesh)
    fn(arrays, root)  # warm
    sync()
    best = float("inf")
    levels = scanned = 0
    for _ in range(iters):
        t0 = time.perf_counter()
        _, levels, scanned = fn(arrays, root)
        sync()
        best = min(best, time.perf_counter() - t0)

    comm = collectives.Communicator(mesh, dev)
    with bounds.tallying() as counts:
        fn(arrays, root, comm)
    _, trace = flightrec.timed_bfs_levels(pg, cfg, root, arrays=arrays, layout=layout,
                                          warmup=False, device=dev, mesh=mesh)
    rec = flightrec.reconcile_bytes(trace, comm.bytes_sent)
    shipped = _shipped(rec)
    rf = roofline(bounds.total_bytes(counts), shipped["total"])
    rf["kernel_bytes"] = {k: v for k, v in counts.items() if not k.startswith("calls:")}
    rf["kernel_calls"] = {k[6:]: v for k, v in counts.items() if k.startswith("calls:")}
    # modeled time: the run's least kernel bytes at the memory rate (the
    # reference's levels × per-level local term) plus the analytic wire
    # bytes over the link (§12 cost model)
    analytic_total = float(trace.level_bytes_per_node().sum())
    t_model = max(rf["t_compute"], rf["t_memory"]) + analytic_total / NVLINK_BYTES_PER_S

    return ProgramProfile(
        algo="bfs",
        sync=cfg.sync,
        p=int(pg.p),
        fanout=int(cfg.fanout),
        levels=trace.levels,
        n_words=int(pg.n_words),
        capacity=int(cfg.resolved_capacity(pg.n_words)),
        scanned_edges=float(scanned),
        wall_ms=best * 1e3,
        wall_ms_levels=float(np.asarray(trace.wall_ms).sum()),
        achieved_gteps=scanned / best / 1e9 if best > 0 else 0.0,
        modeled_gteps=scanned / t_model / 1e9 if t_model > 0 else 0.0,
        model_bytes={k: float(v) for k, v in rec["model"].items()},
        hlo_bytes=shipped,
        reconciled=bool(rec["matches"]),
        wire_efficiency=analytic_total / shipped["total"] if shipped["total"] else 0.0,
        roofline=rf,
        per_level=_per_level_rows(trace),
    )


def _twin(engine, algo: str, cfg, lanes: Optional[int], root: int, mesh):
    """Run the traced twin of one cached program (built on ``mesh``) from
    ``root``: returns ``(trace, rec)``.  Wave programs (MS-BFS,
    betweenness) exchange the flattened ``wave_rows × lane_words`` lane
    buffer, SSSP the padded distance buffer.  BC's forward OR syncs ship on a Communicator of
    their own (its dense ADD syncs are not in the rows)."""
    from repro_torch.analytics import msbfs
    from repro_torch.core import collectives, flightrec
    from repro_torch.traversal import bc as bc_mod
    from repro_torch.traversal import sssp as sssp_mod

    pg, dev, arrays = engine.pg, engine.device, engine._arrays
    comm = collectives.Communicator(mesh, dev)
    if algo == "sssp":
        n_words = sssp_mod.dist_rows(pg)
        out = sssp_mod.build_sssp_fn(pg, cfg, device=dev, trace=True, mesh=mesh)(
            arrays, root, comm)
        counted = comm
    else:
        n_words = msbfs.wave_rows(pg) * msbfs.lane_words(lanes)
        roots = np.full(lanes, -1, dtype=np.int64)
        roots[0] = root
        if algo == "bfs":
            out = msbfs.build_msbfs_fn(pg, cfg, lanes, device=dev, trace=True, mesh=mesh)(
                arrays, roots, comm)
            counted = comm
        else:
            counted = collectives.Communicator(mesh, dev)
            out = bc_mod.build_bc_fn(pg, cfg, lanes, device=dev, trace=True, mesh=mesh)(
                arrays, roots, comm, or_comm=counted)
    trace = flightrec.TraversalTrace.from_buffer(
        out[-1], algo={"bfs": "msbfs"}.get(algo, algo), sync=cfg.sync, p=pg.p,
        fanout=cfg.fanout, n_words=n_words, capacity=cfg.resolved_capacity(n_words),
        density_threshold=cfg.density_threshold,
        axis_sizes=flightrec.axis_sizes(cfg, mesh))
    return trace, flightrec.reconcile_bytes(trace, counted.bytes_sent,
                                            forward_only=algo == "bc")


def cache_report(engine, *, root: int = 0) -> List[CacheEntryReport]:
    """Reconcile the byte model against what the ranks ship for EVERY
    program in the module-wide cache belonging to ``engine``'s graph and
    device.

    Each cached wave (MS-BFS, betweenness) or SSSP program gets a traced
    twin, run from ``root`` (a wave's other lanes idle) on a fresh
    Communicator, whose per-level model bytes must equal every rank's
    count exactly.  §19 vertex programs use monoid all-reduces without an
    adaptive branch structure the model covers, so they are reported
    ``supported=False`` rather than given a fabricated verdict."""
    from repro_torch.analytics import engine as engine_mod
    from repro_torch.core.devlock import device_lock

    pg, dev = engine.pg, engine.device
    reports: List[CacheEntryReport] = []
    for key, (_, e_pg, e_dev) in list(engine_mod._PROGRAM_CACHE.items()):
        if e_pg is not pg or e_dev != dev:
            continue
        algo, cfg = str(key[2]), key[3]
        if algo not in ("bfs", "bc", "sssp"):  # vp:* — no frontier sync to reconcile
            reports.append(CacheEntryReport(
                algo=algo, sync=getattr(cfg, "sync", "?"), lanes=None,
                n_words=0, capacity=0, supported=False, reconciled=False,
                model_bytes={}, hlo_bytes={},
            ))
            continue
        lanes = int(key[4]) if algo != "sssp" else None
        with device_lock(dev):
            trace, rec = _twin(engine, algo, cfg, lanes, int(root), key[-1])
        reports.append(CacheEntryReport(
            algo=algo, sync=cfg.sync, lanes=lanes, n_words=int(trace.n_words),
            capacity=int(trace.capacity), supported=True,
            reconciled=bool(rec["matches"]),
            model_bytes={k: float(v) for k, v in rec["model"].items()},
            hlo_bytes=_shipped(rec),
        ))
    return reports


def format_profile(prof: ProgramProfile) -> str:
    """Human-facing report: header lines plus the per-level time×bytes
    attribution table."""
    lines = [
        f"program {prof.algo} sync={prof.sync} p={prof.p} "
        f"fanout={prof.fanout} n_words={prof.n_words} "
        f"capacity={prof.capacity}",
        f"levels={prof.levels} scanned_edges={prof.scanned_edges:.0f} "
        f"wall={prof.wall_ms:.3f}ms (min-of-k; segmented "
        f"{prof.wall_ms_levels:.3f}ms)",
        f"achieved {prof.achieved_gteps:.4f} GTEPS vs modeled "
        f"{prof.modeled_gteps:.4f} GTEPS",
        f"wire efficiency (analytic/shipped bytes) = "
        f"{prof.wire_efficiency:.4f}  reconciled={prof.reconciled}",
        f"roofline dominant={prof.roofline.get('dominant', '?')}",
        "",
        f"{'lvl':>4} {'branch':>8} {'dir':>4} {'pop':>10} {'density':>8} "
        f"{'B/node':>12} {'wall_ms':>9} {'t%':>6} {'B%':>6}",
    ]
    for r in prof.per_level:
        lines.append(
            f"{r.level:>4} {r.branch:>8} {r.direction:>4} {r.pop:>10} "
            f"{r.density:>8.4f} {r.bytes_per_node:>12.1f} "
            f"{r.wall_ms:>9.3f} {r.time_frac * 100:>5.1f}% "
            f"{r.bytes_frac * 100:>5.1f}%"
        )
    return "\n".join(lines)
