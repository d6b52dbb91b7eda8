"""One gather-apply-scatter core for vertex programs.

The port of ``repro.programs.core``.  The traversals share one runtime
shape — phase-1 local work over owned edges, phase-2 merge of a
replicated buffer across the ranks, repeated until done — and this module
factors it into a **vertex program** contract, over P ranks simulated as
the leading axis of ``[P, ...]`` tensors:

* **gather** — each rank folds its owned edges into a message buffer under
  the program's :class:`~repro_torch.core.monoid.Monoid`;
* **sync**   — the buffer is merged across ranks by the same collectives
  every traversal uses (dense butterfly, sparse changed-word, adaptive,
  all-to-all, or the all-gather that stands for the JAX package's
  compiler-scheduled collective);
* **apply**  — each rank folds the merged buffer into the replicated
  per-vertex state;
* **active** — the program's predicate says whether another round runs.

The idempotence/delta dichotomy holds: an idempotent program (MIN/OR)
ships changed-vs-reference full values (*remerge*), a non-idempotent one
(ADD) ships its per-rank contributions against ``ref=None`` (*delta*), so
the sparse wire is bit-identical to the dense reduce.

The round loop runs on the host and reads one value per round (the
predicate); the sparse and adaptive syncs read one more.  An OR program's
dense merges go through ``bitmap_or_reduce`` (the CUDA kernel on the
card); the MIN and ADD merges are plain PyTorch, as the reference's are
XLA ops.  Programs are plain Python objects whose callbacks take tensors:
they hold no parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flightrec
from repro_torch.core import frontier as fr
from repro_torch.core import loop
from repro_torch.core import monoid as mono
from repro_torch.core.bfs import (device_sync, mesh_comm, place_arrays, resolve_device,
                                  resolve_mesh)
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.traversal.sssp import owned_rows

SYNCS = ("butterfly", "sparse", "adaptive", "all_to_all", "xla")


@dataclasses.dataclass(frozen=True)
class ProgramConfig:
    """Vertex-program knobs, mirroring
    :class:`repro_torch.traversal.sssp.SSSPConfig` (the sync family and its
    sparse/adaptive knobs are shared semantics); ``damping``/``tol`` are
    read by convergence-style programs (PageRank)."""

    axes: Tuple[str, ...] = ("data",)  # mesh axes the syncs run over
    fanout: int = 2
    # butterfly | sparse | adaptive | all_to_all | xla
    sync: str = "butterfly"
    max_iters: Optional[int] = None
    # --- sparse/adaptive sync knobs (shared semantics with SSSPConfig) ----
    sparse_capacity: int = 0  # 0 -> auto-size to n_words // 64 (>= 64)
    density_threshold: float = 0.02
    # --- convergence knobs (PageRank; ignored by exact programs) ----------
    damping: float = 0.85
    tol: float = 1e-5  # total L1 residual threshold

    def __post_init__(self):
        if self.sync not in SYNCS:
            raise ValueError(f"unknown program sync {self.sync!r}; expected one of {SYNCS}")
        if not 0.0 < self.damping < 1.0:
            raise ValueError(f"damping must be in (0, 1), got {self.damping}")
        if self.tol <= 0:
            raise ValueError(f"tol must be > 0, got {self.tol}")

    def resolved_capacity(self, n_words: int) -> int:
        cap = self.sparse_capacity or max(64, n_words // 64)
        return min(cap, n_words)


def program_rows(pg: PartitionedGraph, *, lane_pad: int = 128) -> int:
    """Length of a per-vertex replicated buffer: the whole graph plus one
    rank window of slack, lane-padded — identical to ``sssp.dist_rows`` /
    ``msbfs.wave_rows`` sizing."""
    rows = pg.n + pg.vmax
    return (rows + lane_pad - 1) // lane_pad * lane_pad


@dataclasses.dataclass
class ProgramContext:
    """Everything a program's callbacks may read: static ints (``n``,
    ``n_rows``, ``nw``, ``vmax``, ``p``) and the placed ``[P, ...]`` graph
    planes with each rank's owned window."""

    cfg: ProgramConfig
    n: int  # graph vertices (incl. CSR padding)
    n_rows: int  # replicated per-vertex buffer length (program_rows)
    nw: int  # words of an n_rows-bit bitmap
    vmax: int  # owned-window width
    p: int  # ranks
    arrays: dict  # placed graph planes, [P, ...]
    v_start: Optional[torch.Tensor]  # int64[P, 1]
    own_ids: Optional[torch.Tensor]  # int64[P, vmax]: each rank's owned rows
    owned_mask: Optional[torch.Tensor]  # bool[P, vmax]

    @property
    def device(self) -> torch.device:
        return self.own_ids.device

    @property
    def edge_mask(self) -> torch.Tensor:
        """bool[P, emax]: real owned out-edges (padding slots masked)."""
        src = self.arrays["edge_src"]
        return (torch.arange(src.shape[1], device=src.device)
                < self.arrays["edge_count"][:, None])

    def owned_slice(self, buf: torch.Tensor) -> torch.Tensor:
        """Each rank's ``[v_start, v_start + vmax)`` window of a replicated
        per-vertex buffer ``buf[P, n_rows]``."""
        return torch.gather(buf, 1, self.own_ids)


def _context(pg: PartitionedGraph, cfg: ProgramConfig, arrays: dict, dev) -> ProgramContext:
    n_rows = program_rows(pg)
    own = None if dev is None else owned_rows(pg, dev)
    owned = None if dev is None else (
        torch.arange(pg.vmax, device=dev)[None, :]
        < torch.as_tensor(pg.v_count, device=dev)[:, None])
    return ProgramContext(
        cfg=cfg, n=pg.n, n_rows=n_rows, nw=n_rows // fr.WORD_BITS, vmax=pg.vmax,
        p=pg.p, arrays=arrays, v_start=None if own is None else own[:, :1],
        own_ids=own, owned_mask=owned)


def program_msg_words(pg: PartitionedGraph, program: "VertexProgram") -> int:
    """Host-side :meth:`VertexProgram.msg_words`: programs size their
    exchanged buffer off static context fields only, so a stub context
    suffices (trace buffers and byte accounting need the figure)."""
    return program.msg_words(_context(pg, ProgramConfig(), {}, None))


class VertexProgram:
    """The gather-apply-scatter contract.

    Subclasses provide a monoid and callbacks on ``[P, ...]`` tensors;
    everything else (sync dispatch, round loop, trace rows) is shared.

    * ``name``       — the algo key;
    * ``monoid``     — the exchange monoid; its :attr:`sparse_mode`
      (remerge vs delta) constrains what ``gather`` may return as ``ref``;
    * ``msg_words(ctx)`` — static length of each rank's exchanged buffer;
    * ``init(ctx, arg)`` — initial state tuple from the replicated operand;
    * ``gather(ctx, state, it)`` — ``(msg [P, W], ref, work float32[P])``:
      each rank's message buffer, the sparse reference (``None`` = delta
      mode — REQUIRED for non-idempotent monoids), this round's work;
    * ``apply(ctx, state, merged, it)`` — next state from the merged buffer;
    * ``active(ctx, state, it)`` — keep iterating? (a bool, or a 0-d tensor
      read once; ANDed with ``it < max_iters``);
    * ``outputs(ctx, state)`` — tuple of per-rank owned result tensors;
    * ``metrics(ctx, state, merged)`` — ``(pop, direction)`` for the trace
      row: POP the program's progress, DIR its phase indicator.

    Host-side companions: ``default_arg(pg, device)`` (the cold-start
    operand) and ``assemble(pg, out)`` (per-rank owned output -> global).
    """

    name: str = "?"
    monoid: mono.Monoid = mono.OR_U32
    n_outputs: int = 1

    # --- callbacks on [P, ...] tensors --------------------------------------

    def msg_words(self, ctx: ProgramContext) -> int:
        return ctx.n_rows

    def init(self, ctx: ProgramContext, arg) -> tuple:
        raise NotImplementedError

    def gather(self, ctx: ProgramContext, state: tuple, it):
        raise NotImplementedError

    def apply(self, ctx: ProgramContext, state: tuple, merged, it) -> tuple:
        raise NotImplementedError

    def active(self, ctx: ProgramContext, state: tuple, it):
        raise NotImplementedError

    def outputs(self, ctx: ProgramContext, state: tuple) -> tuple:
        raise NotImplementedError

    def metrics(self, ctx: ProgramContext, state: tuple, merged):
        return 0, 0

    # --- host-side companions ---------------------------------------------

    def default_max_iters(self, pg: PartitionedGraph) -> int:
        return 1 << 30

    def default_arg(self, pg: PartitionedGraph, device="cuda"):
        resolve_device(device)
        return None

    def assemble(self, pg: PartitionedGraph, out) -> np.ndarray:
        raise NotImplementedError


def assemble_owned(pg: PartitionedGraph, out: torch.Tensor, fill, dtype) -> np.ndarray:
    """Per-rank owned rows ``out[P, vmax]`` (a tensor or an array) ->
    global ``[n]`` of ``dtype``, ``fill`` where no rank owns a row."""
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    res = np.full(pg.n, fill, dtype=dtype)
    for i in range(pg.p):
        s, c = int(pg.v_start[i]), int(pg.v_count[i])
        res[s : s + c] = out[i, :c]
    return res


#: The ``xla`` sync's reduce per monoid name (the reference's ``pmin``,
#: ``pmax``, ``psum`` and all-gather OR).
_XLA_OPS = {"or": "or", "min": "min", "max": "max", "add": "add", "add_u32": "add"}


def _sync_program(msg, ref, monoid: mono.Monoid, cfg: ProgramConfig, capacity: int,
                  comm: collectives.Communicator):
    """Phase-2 merge of the programs' message buffers ``msg[P, W]`` — the
    SSSP sync dispatch generalized over the monoid.  ``ref=None`` selects
    delta mode on the sparse paths (enforced against
    ``monoid.sparse_mode``)."""
    axes = cfg.axes
    if cfg.sync == "butterfly":
        return collectives.butterfly_reduce(msg, comm, monoid, fanout=cfg.fanout, axes=axes)
    if cfg.sync == "sparse":
        return collectives.butterfly_reduce_sparse(msg, comm, monoid, fanout=cfg.fanout,
                                                   capacity=capacity, ref=ref, axes=axes)
    if cfg.sync == "adaptive":
        return collectives.butterfly_reduce_adaptive(
            msg, comm, monoid, fanout=cfg.fanout, capacity=capacity,
            density_threshold=cfg.density_threshold, ref=ref, axes=axes)
    if cfg.sync == "all_to_all":
        return collectives.all_to_all_merge(msg, comm, op=monoid.combine, axes=axes)
    return collectives.xla_allreduce(msg, comm, op=_XLA_OPS[monoid.name], axes=axes)


def build_program_fn(pg: PartitionedGraph, program: VertexProgram,
                     cfg: ProgramConfig = ProgramConfig(), *, device="cuda",
                     trace: bool = False, trace_levels: Optional[int] = None,
                     mesh: Optional[SimMesh] = None):
    """Run ``program`` on the shared round loop over ``pg``'s P ranks on
    ``mesh`` (:func:`~repro_torch.core.bfs.resolve_mesh`), syncing over
    ``cfg.axes``.

    Returns ``run(arrays, arg, comm=None, *, level_ms=None)`` where
    ``arrays`` is the placed partition every traversal consumes and ``arg``
    the program's replicated operand (PageRank: the warm-start rank vector;
    CC: initial labels; others: ignored).  Output: ``(*outputs[P, ...],
    iters, work)`` — ``work`` the global edge-examination count (float32,
    as the reference counts it).

    ``trace=True`` appends the flight-recorder buffer ``int32[trace_levels,
    TRACE_COLS]`` with the POP/DIR columns read per program (see
    :meth:`VertexProgram.metrics`).
    """
    dev = resolve_device(device)
    mesh = resolve_mesh(pg.p, cfg.axes, mesh)
    max_iters = (cfg.max_iters if cfg.max_iters is not None
                 else program.default_max_iters(pg))
    msg_words = program_msg_words(pg, program)
    capacity = cfg.resolved_capacity(msg_words)
    if trace:
        t_levels = flightrec.resolve_trace_levels(trace_levels, max_iters)

    def run(arrays, arg=None, comm: Optional[collectives.Communicator] = None, *,
            level_ms: Optional[list] = None):
        comm = mesh_comm(comm, mesh, dev)
        ctx = _context(pg, cfg, arrays, dev)
        state0 = tuple(program.init(ctx, arg))
        k = len(state0)

        def cond(carry):
            return carry[k] < max_iters and bool(program.active(ctx, carry[:k], carry[k]))

        def step(carry):
            state, it, work = carry[:k], carry[k], carry[k + 1]
            msg, ref, w = program.gather(ctx, state, it)
            if trace:
                ref_arr = program.monoid.identity_like(msg) if ref is None else ref
                stats = flightrec.monoid_sync_stats(msg, ref_arr, cfg, capacity)
            merged = _sync_program(msg, ref, program.monoid, cfg, capacity, comm)
            state = tuple(program.apply(ctx, state, merged, it))
            out = state + (it + 1, work + w.to(torch.float32))
            if not trace:
                return out, None
            pop, direction = program.metrics(ctx, state, merged)
            row = flightrec.trace_row(it, stats[0], pop, direction, stats[1], stats[2],
                                      fr.changed_count(merged, ref_arr)[0])
            return out, (it, row)

        init = state0 + (0, torch.zeros(pg.p, dtype=torch.float32, device=dev))
        tbuf = flightrec.zeros(t_levels, dev) if trace else None
        carry = loop.host_while(cond, step, init, trace_buffer=tbuf, level_ms=level_ms,
                                sync=device_sync(dev))
        out = tuple(program.outputs(ctx, carry[:k])) + (carry[k], float(carry[k + 1].sum()))
        return out + (tbuf,) if trace else out

    return run


def run_program(pg: PartitionedGraph, program: VertexProgram,
                cfg: ProgramConfig = ProgramConfig(), *, arg=None,
                device="cuda", mesh: Optional[SimMesh] = None
                ) -> Tuple[np.ndarray, int, float]:
    """End-to-end helper: place arrays, run, assemble.

    Returns ``(result, iters, work)`` — the program's global result (see
    each program's ``assemble``), rounds executed, and edges examined.
    """
    dev = resolve_device(device)
    fn = build_program_fn(pg, program, cfg, device=dev, mesh=mesh)
    if arg is None:
        arg = program.default_arg(pg, dev)
    out = fn(place_arrays(pg, device=dev), arg)
    return program.assemble(pg, out[0]), out[program.n_outputs], out[program.n_outputs + 1]
