"""ButterFly BFS (paper Alg. 2) on PyTorch: distributed breadth-first search
over P ranks simulated as the leading axis of ``[P, ...]`` tensors.

The port of ``repro.core.bfs``.  Per level:

* **Phase 1 — traversal**: every rank expands the frontier over its owned
  edges, top-down (push), bottom-up (pull) or with Beamer's
  direction-optimizing switch, into its "global queue" bitmap.
* **Phase 2 — frontier synchronization**: the per-rank bitmaps are
  OR-merged across ranks by one of six syncs of
  :mod:`repro_torch.core.collectives`: the butterfly (configurable
  fanout), its sparse and density-adaptive variants, Rabenseifner's
  reduce-scatter + all-gather, the all-to-all baseline, or the all-gather
  that stands for the JAX package's compiler-scheduled collective.

The level loop runs on the host and reads one small tensor per level (the
new frontier's size and the two edge counts Beamer's switch needs); the
sparse and adaptive syncs read one more, the counts their branch depends
on.  ``use_kernels=True`` runs phase 1 and every OR merge of a dense round
through the CUDA kernels of :mod:`repro_torch.kernels`; on CPU tensors the
same calls take the kernels' plain versions.  ``trace=True`` records one
flight-recorder row per level (:mod:`repro_torch.core.flightrec`).

**Mesh.** The ranks sit on a :class:`~repro_torch.dist.sharding.SimMesh`
(one ``data`` axis of P ranks unless a ``mesh`` is given), and every
sync runs over the config's ``axes``, as the reference's over its mesh's
axes: ``SimMesh((4, 4), ("pod", "data"))`` with ``axes=("pod", "data")``
syncs axis by axis (:func:`resolve_mesh` checks the pair).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core.tracing import span
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.kernels import blocks
from repro_torch.kernels import ops as kops

INF = int(np.iinfo(np.int32).max)

MODES = ("top_down", "bottom_up", "direction_optimizing")
SYNCS = ("butterfly", "sparse", "adaptive", "rabenseifner", "all_to_all", "xla")
# Layout planes indexed by torch.gather, which wants int64 indices.
_INDEX_KEYS = ("tds_perm", "pus_perm")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device that is not
    there raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain path on the CPU")
    return dev


def resolve_mesh(p: int, axes: Tuple[str, ...], mesh: Optional[SimMesh] = None) -> SimMesh:
    """The mesh a traversal of ``p`` partitions syncs on over ``axes``:
    ``mesh``, or one ``data`` axis of ``p`` ranks.  Partition ``i`` sits on
    rank ``i`` (row-major over the mesh, where the reference's
    ``P(axes)`` puts it when ``axes`` are in the mesh's order; no result
    depends on which rank holds which partition).  Raises ``ValueError``
    when ``axes`` names an axis the mesh lacks or names one twice, or
    when the axes' sizes do not multiply to ``p`` (the reference's
    ``P(axes)`` places ``p`` partitions on them) or the mesh holds other
    ranks (a rank holds one partition)."""
    mesh = SimMesh(p) if mesh is None else mesh
    axes = tuple(axes)
    missing = [a for a in axes if a not in mesh.shape]
    if missing or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} do not name distinct axes of the mesh "
                         f"{mesh.axis_names}")
    size = math.prod(mesh.shape[a] for a in axes)
    if size != p or mesh.ranks != p:
        raise ValueError(f"axes {axes} of the {mesh.ranks}-rank mesh {mesh.shape} hold "
                         f"{size} ranks; {p} partitions need {p} on both")
    return mesh


def mesh_comm(comm: Optional[collectives.Communicator], mesh: SimMesh,
              dev: torch.device) -> collectives.Communicator:
    """A run's Communicator: a fresh one on ``mesh``, or the caller's,
    which must simulate the mesh the program was built on."""
    if comm is None:
        return collectives.Communicator(mesh, dev)
    if comm.mesh != mesh:
        raise ValueError(f"a Communicator on {comm.mesh} for a program built on {mesh}")
    return comm


# ---------------------------------------------------------------------------
# Host oracle (paper Alg. 1 semantics)
# ---------------------------------------------------------------------------


def bfs_reference(g: Graph, root: int) -> np.ndarray:
    """Sequential frontier BFS — the ground truth for small graphs."""
    d = np.full(g.n, INF, dtype=np.int64)
    d[root] = 0
    frontier = [root]
    level = 0
    while frontier:
        nxt = []
        for v in frontier:
            for u in g.neighbors(v):
                if d[u] > level + 1:
                    d[u] = level + 1
                    nxt.append(u)
        frontier = nxt
        level += 1
    return d


# ---------------------------------------------------------------------------
# Distributed ButterFly BFS
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BFSConfig:
    """Algorithm knobs (paper Sec. 3/4)."""

    axes: Tuple[str, ...] = ("data",)  # mesh axes the syncs run over
    fanout: int = 2  # paper fanout: 1 -> pairwise, 4 -> radix-4 rounds
    # butterfly | sparse | adaptive | rabenseifner | all_to_all | xla
    sync: str = "butterfly"
    mode: str = "top_down"  # top_down | bottom_up | direction_optimizing
    alpha: float = 15.0  # Beamer push->pull threshold
    beta: float = 18.0  # Beamer pull->push threshold
    max_levels: Optional[int] = None
    use_kernels: bool = False  # phase 1 + merge via the CUDA kernels
    # --- sparse/adaptive sync knobs (DESIGN.md §12) -----------------------
    # max (word_index, word) pairs shipped in the first sparse round;
    # 0 -> auto-size to n_words // 64 (>= 64) at build time.
    sparse_capacity: int = 0
    # adaptive dispatch: go sparse while the densest rank's popcount stays
    # under this fraction of the bitmap bits (and its word count fits the
    # capacity).
    density_threshold: float = 0.02

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown BFS mode {self.mode!r}; expected one of {MODES}")
        if self.sync not in SYNCS:
            raise ValueError(f"unknown frontier sync {self.sync!r}; expected one of {SYNCS}")

    def resolved_capacity(self, n_words: int) -> int:
        cap = self.sparse_capacity or max(64, n_words // 64)
        return min(cap, n_words)


def _sync_frontier(words: torch.Tensor, cfg: BFSConfig, comm: collectives.Communicator,
                   use_kernels: Optional[bool] = None) -> torch.Tensor:
    """OR-merge the per-rank buffers ``words[P, W]`` with ``cfg.sync``; the
    dense rounds' merges go through ``bitmap_or_reduce`` when
    ``use_kernels`` (by default ``cfg.use_kernels``)."""
    if use_kernels is None:
        use_kernels = cfg.use_kernels
    kw = dict(fanout=cfg.fanout, use_kernels=use_kernels, axes=cfg.axes)
    if cfg.sync == "butterfly":
        return collectives.butterfly_or(words, comm, **kw)
    if cfg.sync == "sparse":
        # always-sparse wire format, dense fallback only on overflow
        return collectives.butterfly_or_sparse(
            words, comm, capacity=cfg.resolved_capacity(words.shape[-1]), **kw)
    if cfg.sync == "adaptive":
        # per-level dense/sparse dispatch keyed on frontier density
        return collectives.butterfly_or_adaptive(
            words, comm, capacity=cfg.resolved_capacity(words.shape[-1]),
            density_threshold=cfg.density_threshold, **kw)
    if cfg.sync == "rabenseifner":
        return collectives.butterfly_allreduce_rabenseifner(words, comm, op="or", **kw)
    if cfg.sync == "all_to_all":
        return collectives.all_to_all_merge(words, comm, op="or", axes=cfg.axes)
    return collectives.xla_allreduce(words, comm, op="or", use_kernels=use_kernels,
                                     axes=cfg.axes)


def _lane_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx[P, E]`` of a lane-packed ``buf[P, n_rows, k]`` ->
    ``[P, E, k]``."""
    idx = idx.long()
    return torch.gather(buf, 1, idx[..., None].expand(*idx.shape, buf.shape[-1]))


def _expand_push(arrays, frontier, n_words, use_kernels, meta=None, *, lanes=False):
    """Top-down: scatter frontier bits along owned out-edges (paper Alg. 2
    phase 1).  Returns every rank's 'global queue' bitmap ``[P, n_words]``.

    ``lanes=True``: lane-packed ``int32[P, n_words, B/32]`` rows, the same
    traversal bit-parallel over B concurrent searches
    (:mod:`repro_torch.analytics.msbfs`), where ``n_words`` counts vertex
    ROWS and the merge is a per-row lane-mask OR (plain PyTorch only)."""
    if use_kernels:
        if lanes:
            raise NotImplementedError("the frontier kernels are single-source "
                                      "(vertex-packed) only")
        return kops.expand_push(frontier, arrays, meta, n_words)
    src, dst = arrays["edge_src"], arrays["edge_dst"]
    mask = torch.arange(src.shape[1], device=src.device) < arrays["edge_count"][:, None]
    if lanes:
        active = torch.where(mask[..., None], _lane_rows(frontier, src), 0)
        return fr.scatter_or_lanes(n_words, dst, active)
    active = fr.get_bits(frontier, src) & mask
    return fr.scatter_or(n_words, dst, active)


def _expand_pull(arrays, frontier, visited, n_words, use_kernels, meta=None, *,
                 lanes=False):
    """Bottom-up: every unvisited owned vertex probes its in-edges for a
    parent in the frontier (Beamer; paper Sec. 3).  ``lanes=True`` runs
    the probe per search lane: a vertex can be settled in one search and
    still pulling in another, all in one bitwise op."""
    if use_kernels:
        if lanes:
            raise NotImplementedError("the frontier kernels are single-source "
                                      "(vertex-packed) only")
        return kops.expand_pull(frontier, visited, arrays, meta, n_words)
    src, dst = arrays["in_src"], arrays["in_dst"]
    mask = torch.arange(src.shape[1], device=src.device) < arrays["in_count"][:, None]
    if lanes:
        parent = torch.where(mask[..., None], _lane_rows(frontier, src), 0)
        return fr.scatter_or_lanes(n_words, dst, parent & ~_lane_rows(visited, dst))
    found = fr.get_bits(frontier, src) & mask & ~fr.get_bits(visited, dst)
    return fr.scatter_or(n_words, dst, found)


def place_arrays(pg: PartitionedGraph, layout: Optional[blocks.BFSKernelLayout] = None,
                 *, device="cuda") -> Dict[str, torch.Tensor]:
    """The stacked partition (and layout) planes as tensors on ``device``;
    a weighted partition's ``edge_weight``/``in_weight`` come as int32
    tensors holding the uint32 weights' bit patterns."""
    dev = resolve_device(device)
    with span("etl.place_arrays"):
        planes = dict(pg.arrays())
        if layout is not None:
            planes.update(layout.arrays)
        return _place(planes, dev)


def place_layout(layout: blocks.BFSKernelLayout, *, device="cuda") -> Dict[str, torch.Tensor]:
    """The layout planes alone on ``device``: merged into arrays placed
    without a layout, they make the kernel path's arrays."""
    return _place(layout.arrays, resolve_device(device))


def _place(planes, dev: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in planes.items():
        v = np.ascontiguousarray(v)
        t = torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
        out[k] = (t.long() if k in _INDEX_KEYS else t).to(dev)
    return out


class _State(NamedTuple):
    frontier: torch.Tensor  # int32[P, n_words]
    visited: torch.Tensor  # int32[P, n_words]
    d_owned: torch.Tensor  # int32[P, vmax]
    level: int
    scanned: torch.Tensor  # float32[P] edges examined per rank
    pull: bool  # this level's direction
    n_front: int  # popcount of the frontier


def device_sync(dev: torch.device):
    """A function that waits for ``dev`` to finish its work (a no-op on the
    CPU): what stops a wall clock after device work."""
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def build_bfs_fn(pg: PartitionedGraph, cfg: BFSConfig,
                 layout: Optional[blocks.BFSKernelLayout] = None, *, device="cuda",
                 trace: bool = False, trace_levels: Optional[int] = None,
                 mesh: Optional[SimMesh] = None):
    """Distributed BFS over ``pg``'s P simulated ranks on ``mesh``
    (:func:`resolve_mesh`), every sync over ``cfg.axes``.

    Returns ``run(arrays, root, comm=None, *, level_ms=None)`` with
    ``arrays`` from :func:`place_arrays` on the same device.  Output:
    per-rank owned distances ``int32[P, vmax]`` (``INF`` for unreached),
    levels executed, and edges examined (float32, as the reference counts
    them, for honest TEPS).  ``comm`` (a
    :class:`~repro_torch.core.collectives.Communicator`) collects the
    merge's bytes per rank; a list ``level_ms`` takes each level's wall
    time in ms, the clock stopping after the device has finished the level.
    Each call is a ``bfs.search`` span (args ``root``, ``levels``) holding
    a ``loop.level`` span a level, and in it the level's phases:
    ``bfs.expand`` (arg ``pull``), ``bfs.edge_counts``, ``bfs.sync``,
    ``bfs.update`` and ``bfs.readback``, the host's wait for the level's
    counts (a last ``bfs.readback`` reads ``scanned``).

    ``trace=True`` appends the flight-recorder buffer
    ``int32[trace_levels, TRACE_COLS]`` (:mod:`.flightrec`) to the output:
    one row per level, from statistics computed on the device and read
    once, with the buffer, after the run.  ``trace=False`` computes no sync
    statistics and launches exactly the uninstrumented work."""
    dev = resolve_device(device)
    if cfg.use_kernels and layout is None:
        raise ValueError("use_kernels=True requires a BFSKernelLayout")
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    meta = layout.meta if layout is not None else None
    p, n_words, vmax = pg.p, pg.n_words, pg.vmax
    max_levels = cfg.max_levels if cfg.max_levels is not None else pg.n
    word_cols = (torch.as_tensor(pg.word_start, dtype=torch.int64, device=dev)[:, None]
                 + torch.arange(pg.wmax, device=dev))
    owned = (torch.arange(vmax, device=dev)[None, :]
             < torch.as_tensor(pg.v_count, device=dev)[:, None])
    alpha = np.float32(cfg.alpha)
    push_below = np.float32(pg.n / cfg.beta)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_levels)

    def own(words):
        """bool[P, vmax]: each rank's bits of its owned vertex range."""
        return fr.unpack(torch.gather(words, 1, word_cols))[:, :vmax]

    def traverse(arrays, root, comm, level_ms):
        root = int(root)
        if not 0 <= root < pg.n:
            raise ValueError(f"root {root} outside [0, {pg.n})")
        comm = mesh_comm(comm, mesh, dev)
        deg_out = arrays["deg_out"]
        visited = fr.set_bit(torch.zeros((p, n_words), dtype=torch.int32, device=dev), root)
        d_owned = torch.full((p, vmax), INF, dtype=torch.int32, device=dev)
        owner = pg.owner_of(root)
        d_owned[owner, root - int(pg.v_start[owner])] = 0

        def cond(s: _State) -> bool:
            return s.n_front > 0 and s.level < max_levels

        def step(s: _State):
            # -- Phase 1: traversal
            with span("bfs.expand", pull=s.pull):
                if s.pull:
                    gq = _expand_pull(arrays, s.frontier, s.visited, n_words,
                                      cfg.use_kernels, meta)
                else:
                    gq = _expand_push(arrays, s.frontier, n_words, cfg.use_kernels, meta)
            # edges examined this level (honest TEPS accounting)
            with span("bfs.edge_counts"):
                m_f = (deg_out * (own(s.frontier) & owned)).sum(1)
                m_u = (deg_out * (~own(s.visited) & owned)).sum(1)
            # -- Phase 2: frontier synchronization
            with span("bfs.sync"):
                if trace:
                    stats = flightrec.or_sync_stats(gq, cfg)
                merged = _sync_frontier(gq, cfg, comm)
            with span("bfs.update"):
                new = merged & ~s.visited
                visited = s.visited | new
                d_owned = s.d_owned.masked_fill_(own(new) & owned, s.level + 1)
                scanned = s.scanned + (m_u if s.pull else m_f).to(torch.float32)
                counts = torch.stack([fr.popcount(new[0]), m_f.sum(), m_u.sum()])
            with span("bfs.readback"):
                n_new, g_mf, g_mu = counts.tolist()
            # -- Direction-optimizing switch (Beamer alpha/beta), in
            # float32 as the reference compares
            pull = s.pull
            if cfg.mode == "direction_optimizing":
                if pull:
                    pull = not np.float32(n_new) < push_below
                else:
                    pull = bool(np.float32(g_mf) > np.float32(g_mu) / alpha)
            out = _State(new, visited, d_owned, s.level + 1, scanned, pull, n_new)
            if not trace:
                return out, None
            row = flightrec.trace_row(s.level, stats[0], n_new, int(s.pull),
                                      stats[1], stats[2], fr.count_nonzero(new[0]))
            return out, (s.level, row)

        init = _State(visited, visited, d_owned, 0,
                      torch.zeros(p, dtype=torch.float32, device=dev),
                      cfg.mode == "bottom_up", 1)
        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        s = loop.host_while(cond, step, init, trace_buffer=tbuf, level_ms=level_ms,
                            sync=device_sync(dev))
        with span("bfs.readback"):
            out = (s.d_owned, s.level, float(s.scanned.sum()))
        return out + (tbuf,) if trace else out

    def run(arrays, root: int, comm: Optional[collectives.Communicator] = None, *,
            level_ms: Optional[list] = None):
        with span("bfs.search", root=int(root)) as sp:
            out = traverse(arrays, root, comm, level_ms)
            if sp is not None:
                sp.args["levels"] = out[1]
        return out

    return run


def assemble_distances(pg: PartitionedGraph, d_owned: torch.Tensor) -> np.ndarray:
    """Per-rank owned distances ``[P, vmax]`` -> global ``int64[n]``."""
    d_owned = d_owned.cpu().numpy()
    dist = np.full(pg.n, INF, dtype=np.int64)
    for i in range(pg.p):
        s, c = int(pg.v_start[i]), int(pg.v_count[i])
        dist[s : s + c] = d_owned[i, :c]
    return dist


def distributed_bfs(pg: PartitionedGraph, root: int, cfg: BFSConfig = BFSConfig(),
                    *, device="cuda", mesh: Optional[SimMesh] = None
                    ) -> Tuple[np.ndarray, int, float]:
    """End-to-end helper: lay out, place, run, assemble global distances
    (``mesh``: the ranks' mesh, as the reference's ``mesh`` argument)."""
    dev = resolve_device(device)
    layout = blocks.build_bfs_layout(pg) if cfg.use_kernels else None
    arrays = place_arrays(pg, layout, device=dev)
    d_owned, levels, scanned = build_bfs_fn(pg, cfg, layout, device=dev, mesh=mesh)(
        arrays, root)
    return assemble_distances(pg, d_owned), levels, scanned
