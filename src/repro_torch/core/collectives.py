"""Frontier merges over simulated ranks (BFS phase 2).

The port of ``repro.core.collectives``.  The P ranks are the leading axis
of a ``[P, W]`` tensor on one device, and a :class:`Communicator` plays
the network: :meth:`Communicator.ppermute` is an explicit copy of every
rank's buffer to its partner, and it counts the bytes each rank sends.

* :func:`butterfly_merge` / :func:`butterfly_reduce` / :func:`butterfly_or`
  / :func:`butterfly_allreduce` — the paper's butterfly (Alg. 2 phase 2):
  every round ships the full accumulator to ``digit - 1`` partners and
  merges the ``digit`` buffers; an OR merge is one ``bitmap_or_reduce``
  launch per round.
* :func:`butterfly_reduce_sparse` / :func:`butterfly_reduce_adaptive` /
  :func:`butterfly_or_sparse` / :func:`butterfly_or_adaptive` — the
  density-adaptive sparse exchange (DESIGN.md §12): fixed-capacity
  ``(word_index, word)`` pairs on the same wiring.
* :func:`butterfly_allreduce_rabenseifner` — reduce-scatter plus
  all-gather on the butterfly wiring: ``2 (P-1)/P`` of the buffer per rank.
* :func:`all_to_all_merge` — the baseline the paper replaces: ``P - 1``
  ring shifts, each merged with ``op``.
* :func:`xla_allreduce` — the compiler-scheduled reference point of the JAX
  package; on simulated ranks an all-gather (``P - 1`` shifts) and a
  ``P``-way reduce.
* :func:`tree_sync` / :func:`tree_sync_int8` — the train step's gradient
  sync: each ``[P, ...]`` leaf summed by one of the dense methods above
  (or by the butterfly with int8 on the wire) and divided by P.
* :class:`TensorParallel` — the LM's tensor-parallel collectives over the
  ``model`` axis (all-reduce, its conjugate copy, all-gather, split, max
  all-reduce), differentiable and recorded by kind; the communicator's
  :meth:`Communicator.axis_sum` / ``axis_max`` / ``axis_cat`` are their
  wire (a sum over the held blocks here, ``torch.distributed`` over a
  process subgroup in ``DistCommunicator``).
* :class:`FullyShardedData` — FSDP (ZeRO-3) over the data axes: a
  parameter's all-gather before the unit that uses it, whose backward is
  the gradient's reduce-scatter (``axis_reduce_scatter`` on the wire).

Every sync takes the reference's merge op or monoid.  ``"min"`` and
``"max"`` order int32 words as the uint32 values they hold
(:func:`~repro_torch.core.monoid.umin`); float32 buffers travel the sparse
wire bit-cast to int32 words, never converted.

Where the reference picks a branch on the device (``lax.cond``), the port
reads the deciding counts on the host: one read per call of the sparse
(overflow guard) and adaptive syncs, none for the dense ones; each read is
a ``sync.readback`` span (:mod:`repro_torch.core.tracing`).

**Axes.** A :class:`Communicator` carries a
:class:`~repro_torch.dist.sharding.SimMesh` (one ``data`` axis of P ranks
unless given one).  The dense syncs, Rabenseifner, int8 and ``tree_sync*``
take the reference's ``axes``: ``None`` syncs all ranks as one axis, a
tuple such as ``("pod", "data")`` syncs within each group of ranks that
differ only on those axes, axis by axis (the full-buffer rounds: the first
axis first, each least-significant digit first; Rabenseifner: the stages
of every axis in one mixed radix, the first axis least significant,
reduce-scattered most-significant digit first, as the reference's
``_global_stages``).  The sparse and adaptive syncs take ``axes`` too:
their rounds are the same, and the capacity grows by each round's digit
across the axes.  Their deciding counts (the overflow guard's changed
words, the adaptive OR's popcount and nonzero words) are maxed over each
group, as the reference's ``pmax`` over the axes, so each group takes its
own branch; the counts of every group come to the host in one read, and
each rank's bytes count the branch its group ran.

**Ranks held.** A sync's buffers hold one row for each rank in
``comm.ranks``: every rank for the simulated :class:`Communicator`, the
process's own for :class:`~repro_torch.dist.process.DistCommunicator`
over ``torch.distributed``; the per-rank index arithmetic is built from
``comm.ranks``, so the same function bodies serve both.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import butterfly
from repro_torch.core import frontier as fr
from repro_torch.core import monoid as mono
from repro_torch.core.monoid import Monoid
from repro_torch.core.tracing import span
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh
from repro_torch.kernels import bitmap_merge, ref as kref

_MERGE_OPS = {
    "add": torch.add,
    "or": torch.bitwise_or,
    "and": torch.bitwise_and,
    "max": mono.umax,
    "min": mono.umin,
}
Op = Union[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]
Axes = Union[None, str, Sequence[str]]


def _as_axes(axes: Axes) -> Optional[Tuple[str, ...]]:
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


#: The collective kinds of the reference's HLO count
#: (``repro.launch.hlo_stats``), under its names.
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def empty_stats() -> Dict[str, Dict[str, float]]:
    """``{kind: {"count", "operand_bytes", "wire_bytes"}}`` at zero."""
    return {k: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0}
            for k in COLLECTIVE_KINDS}


def route(perm: Sequence[Optional[int]], p: int) -> Tuple[int, ...]:
    """``perm`` as a tuple with ``-1`` for a rank that sends nothing (``None``
    or ``-1``; the reference's ``ppermute`` pairs need not cover every
    rank); refuses repeated or out-of-range destinations."""
    key = tuple(-1 if d is None else int(d) for d in perm)
    dst = [d for d in key if d >= 0]
    if len(key) != p or len(set(dst)) != len(dst) or any(d >= p for d in dst):
        raise ValueError(f"{key} is not a (partial) permutation of {p} ranks")
    return key


class Communicator:
    """P simulated ranks on one device, with per-rank send counters.

    ``p`` is a rank count (one ``data`` axis) or a
    :class:`~repro_torch.dist.sharding.SimMesh`.  ``ranks`` are the ranks
    whose rows a sync's buffers hold (all of them here).  ``bytes_sent[i]``
    counts the bytes rank ``ranks[i]`` has put on the wire and ``sends[i]``
    its messages; each sync's count must equal its byte model in
    :mod:`.butterfly`.

    ``collectives`` records the calls by the reference's collective kinds
    (:data:`COLLECTIVE_KINDS`), as its HLO count has them: a call's
    ``count``, ``operand_bytes`` (one rank's buffer) and ``wire_bytes``
    (what one rank sends for it).  Every :meth:`ppermute` is one
    ``collective-permute``; a collective built of shifts
    (:func:`xla_allreduce`) records itself as one call of its own kind
    (:meth:`as_one`) and its shifts go unrecorded there."""

    def __init__(self, p, device):
        self.mesh = p if isinstance(p, SimMesh) else SimMesh(int(p))
        self.p = self.mesh.ranks
        self.ranks = np.arange(self.p, dtype=np.int64)
        self.device = torch.device(device)
        self.bytes_sent = np.zeros(len(self.ranks), dtype=np.int64)
        self.sends = np.zeros(len(self.ranks), dtype=np.int64)
        self.collectives = empty_stats()
        self._as_one = False
        self._perms: Dict[Tuple[int, ...], Tuple] = {}
        self._schedules: Dict[int, butterfly.Schedule] = {}
        self._rounds: Dict[Tuple, Tuple[butterfly.Round, ...]] = {}

    def record(self, kind: str, operand_bytes: float, wire_bytes: float) -> None:
        """One call of ``kind`` in :attr:`collectives` (none inside
        :meth:`as_one`)."""
        if not self._as_one:
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["operand_bytes"] += float(operand_bytes)
            rec["wire_bytes"] += float(wire_bytes)

    @contextlib.contextmanager
    def as_one(self, kind: str, operand_bytes: float, wire_bytes: float):
        """The block is one call of ``kind``: it is recorded once, and the
        permutes inside it are not."""
        self.record(kind, operand_bytes, wire_bytes)
        outer, self._as_one = self._as_one, True
        try:
            yield
        finally:
            self._as_one = outer

    def schedule(self, fanout: int) -> butterfly.Schedule:
        if fanout not in self._schedules:
            self._schedules[fanout] = butterfly.build_schedule(self.p, fanout)
        return self._schedules[fanout]

    def group_size(self, axes: Axes = None) -> int:
        """The ranks a sync over ``axes`` reduces (all of them for ``None``)."""
        axes = _as_axes(axes)
        return self.p if axes is None else math.prod(self.mesh.shape[a] for a in axes)

    def _lift(self, axis: str, perm: Sequence[int]) -> Tuple[int, ...]:
        """A perm of ``axis``'s positions as a perm of the mesh's ranks: each
        rank moves along that axis only, within its group."""
        n, stride = self.mesh.shape[axis], self.mesh.axis_stride(axis)
        g = np.arange(self.p, dtype=np.int64)
        coord = (g // stride) % n
        return tuple(int(d) for d in g + (np.asarray(perm)[coord] - coord) * stride)

    def rounds(self, fanout: int, axes: Axes = None) -> Tuple[butterfly.Round, ...]:
        """The butterfly rounds over ``axes``, least-significant digit first
        and the first axis first; ``None`` is the schedule of all ranks.  An
        axis's round is lifted to the mesh's ranks, its stride in global
        rank numbers, so ``(rank // stride) % digit`` is the rank's digit on
        that axis."""
        axes = _as_axes(axes)
        if axes is None:
            return self.schedule(fanout).rounds
        key = (fanout, axes)
        if key not in self._rounds:
            self._rounds[key] = tuple(
                butterfly.Round(rnd.digit, rnd.stride * self.mesh.axis_stride(axis),
                                tuple(self._lift(axis, perm) for perm in rnd.perms))
                for axis in axes
                for rnd in butterfly.build_schedule(self.mesh.shape[axis], fanout).rounds)
        return self._rounds[key]

    def group_ids(self, axes: Axes = None) -> np.ndarray:
        """int64[R]: each held rank's group over ``axes`` (ranks that differ
        only on those axes share one id; all ranks are group 0 for
        ``None``)."""
        axes = _as_axes(axes)
        if axes is None:
            return np.zeros(len(self.ranks), dtype=np.int64)
        rest = tuple(a for a in self.mesh.axis_names if a not in axes)
        return self.mesh.group_index(self.ranks, rest)

    def group_max(self, counts: Sequence[torch.Tensor], axes: Axes = None) -> np.ndarray:
        """int64[K, R]: each of the ``K`` per-rank statistics ``counts[k][R]``
        maxed over each rank's group over ``axes`` (the reference's
        ``pmax`` over the axes), read on the host in one transfer (a
        ``sync.readback`` span)."""
        stack = torch.stack([c.to(torch.int64) for c in counts])
        gid = self.group_ids(axes)
        n = int(gid.max()) + 1
        if n == 1:
            gmax = stack.amax(1, keepdim=True)
        else:
            idx = torch.as_tensor(gid, device=stack.device).expand_as(stack)
            gmax = stack.new_full((stack.shape[0], n), torch.iinfo(torch.int64).min)
            gmax = gmax.scatter_reduce_(1, idx, stack, "amax")
        with span("sync.readback"):
            return gmax.cpu().numpy()[:, gid]

    def rings(self, axes: Axes = None) -> List[Tuple[Tuple[int, ...], int]]:
        """``(perm, n)`` for each axis of ``axes``: the ``+1`` ring shift
        within the axis's groups and the axis size; ``None``: the ring over
        all ranks."""
        axes = _as_axes(axes)
        if axes is None:
            return [(tuple((i + 1) % self.p for i in range(self.p)), self.p)]
        return [(self._lift(a, [(i + 1) % n for i in range(n)]), n)
                for a, n in ((a, self.mesh.shape[a]) for a in axes)]

    def shifts(self, axes: Axes = None) -> List[Tuple[int, ...]]:
        """Perms ``s = 1 .. G-1``: each rank to the rank ``s`` ahead of it in
        its group over ``axes`` (row-major over the axes), cyclically."""
        axes = _as_axes(axes)
        g = np.arange(self.p, dtype=np.int64)
        if axes is None:
            return [tuple(int(d) for d in (g + s) % self.p) for s in range(1, self.p)]
        size = self.group_size(axes)
        rest = tuple(a for a in self.mesh.axis_names if a not in axes)
        gi, other = self.mesh.group_index(g, axes), self.mesh.group_index(g, rest)
        table = np.empty((self.p // size, size), dtype=np.int64)
        table[other, gi] = g
        return [tuple(int(d) for d in table[other, (gi + s) % size]) for s in range(1, size)]

    def axis_sum(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``t[n, ...]``, the blocks of the ranks held of one group over
        ``axes`` in group order, summed into one (the wire of
        :class:`TensorParallel`; unrecorded here)."""
        return t.sum(0)

    def axis_max(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """As :meth:`axis_sum`, the elementwise max."""
        return t.amax(0)

    def axis_cat(self, t: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """As :meth:`axis_sum`, the blocks laid end to end along ``dim`` of
        the result in group order."""
        return _sim_cat(t, dim)

    def pmean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over all ranks of one scalar a rank (``values[i]`` is
        rank ``ranks[i]``'s), as ``lax.pmean``; not counted as sync bytes."""
        return values.sum() / self.p

    def _perm(self, perm: Sequence[Optional[int]]) -> Tuple:
        """(destination index, source index, sending mask) of a perm; the
        last two None when every rank sends, as in every sync's round."""
        key = tuple(perm)
        if key not in self._perms:
            dst = np.asarray(route(key, self.p), dtype=np.int64)
            send = dst >= 0
            if send.all():
                self._perms[key] = (torch.tensor(dst, device=self.device), None, None)
            else:
                src = torch.tensor(np.flatnonzero(send), device=self.device)
                self._perms[key] = (torch.tensor(dst[send], device=self.device), src, send)
        return self._perms[key]

    def ppermute(self, x: torch.Tensor, perm: Sequence[Optional[int]],
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``recv[perm[src]] = x[src]`` for every rank ``src``: the wire. A
        rank whose ``perm`` entry is ``None`` (or ``-1``) sends nothing, and
        a rank nobody sends to receives zeros, as the reference's partial
        ``ppermute``.  Differentiable: autograd carries the copy back.

        ``out`` (a ``[P, ...]`` view, e.g. one slot of a receive stack)
        takes the copy in place of a fresh buffer."""
        if x.shape[0] != self.p:
            raise ValueError(f"buffer has {x.shape[0]} ranks, expected {self.p}")
        dst, src, send = self._perm(perm)
        nbytes = x[0].numel() * x.element_size()
        self.record("collective-permute", nbytes, nbytes)
        if src is None:
            recv = torch.empty_like(x) if out is None else out
            recv.index_copy_(0, dst, x)
            self.bytes_sent += nbytes
            self.sends += 1
        else:
            recv = torch.zeros_like(x) if out is None else out.zero_()
            recv.index_copy_(0, dst, x.index_select(0, src))
            self.bytes_sent[send] += nbytes
            self.sends[send] += 1
        return recv


def _merge_stack(stack: torch.Tensor, op: Op, use_kernels: bool) -> torch.Tensor:
    """Merge ``stack[P, K, ...]`` along K.  OR is one ``bitmap_or_reduce``
    (the CUDA kernel; its plain version when ``use_kernels`` is False) over
    the contiguous ``[P, K, W]`` stack; any other op folds the K buffers in
    order, as the reference merges what it receives."""
    if op == "or" or op is torch.bitwise_or:
        merge = bitmap_merge.bitmap_or_reduce if use_kernels else kref.bitmap_or_reduce
        p, k = stack.shape[:2]
        return merge(stack.reshape(p, k, -1)).reshape((p,) + stack.shape[2:])
    fn = _MERGE_OPS[op] if isinstance(op, str) else op
    out = stack[:, 0]
    for k in range(1, stack.shape[1]):
        out = fn(out, stack[:, k])
    return out


# ---------------------------------------------------------------------------
# Paper-faithful full-buffer butterfly (Alg. 2, phase 2)
# ---------------------------------------------------------------------------


def butterfly_merge(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                    op: Op = "add", use_kernels: bool = True,
                    axes: Axes = None) -> torch.Tensor:
    """Merge ``x[P, ...]`` across the ranks (over ``axes``) with the
    butterfly schedule.

    Round by round (:meth:`Communicator.rounds`), each rank's accumulator
    and the ``digit - 1`` buffers it receives are stacked into ``[P, digit,
    ...]`` and merged (``op`` associative and commutative).  A round's
    stack is freed before the next is allocated: at a lane wave's widths
    one stack is tens of GB."""
    for rnd in comm.rounds(fanout, axes):
        stack = x.new_empty((x.shape[0], rnd.digit) + tuple(x.shape[1:]))
        stack[:, 0] = x
        for j, perm in enumerate(rnd.perms, start=1):
            comm.ppermute(x, perm, out=stack[:, j])
        x = _merge_stack(stack, op, use_kernels)
        del stack
    return x


def butterfly_reduce(x: torch.Tensor, comm: Communicator, monoid: Monoid, *,
                     fanout: int = 2, use_kernels: bool = True,
                     axes: Axes = None) -> torch.Tensor:
    """All-reduce ``x`` over a :class:`~repro_torch.core.monoid.Monoid` with
    the full-buffer butterfly (DESIGN.md §14)."""
    return butterfly_merge(x, comm, fanout=fanout, op=monoid.combine,
                           use_kernels=use_kernels, axes=axes)


def butterfly_or(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                 use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """Bitmap frontier synchronization (BFS phase 2): the OR monoid's
    butterfly, one ``bitmap_or_reduce`` launch per round."""
    return butterfly_reduce(x, comm, mono.OR_U32, fanout=fanout,
                            use_kernels=use_kernels, axes=axes)


def butterfly_allreduce(x: torch.Tensor, comm: Communicator, *,
                        fanout: int = 2, axes: Axes = None) -> torch.Tensor:
    """Sum all-reduce with the paper-faithful full-buffer butterfly."""
    return butterfly_merge(x, comm, fanout=fanout, op="add", axes=axes)


# ---------------------------------------------------------------------------
# Density-adaptive sparse frontier exchange (DESIGN.md §12)
# ---------------------------------------------------------------------------


def bits_limit(n_words: int, density_threshold: float) -> int:
    """The adaptive OR sync's popcount limit, computed as the reference
    computes it (a Python float product cast to an integer)."""
    return int(density_threshold * n_words * fr.WORD_BITS)


def _sparse_rounds(words, comm, monoid, fanout, capacity, ref, axes=None):
    """The sparse butterfly: per round every rank compacts the words of its
    pre-round accumulator that differ from ``ref`` to the round capacity
    and ships the pairs (``8 * cap_r`` bytes a message) to each partner,
    which combines them; the capacity grows by the round's digit, across
    the axes."""
    n_words = words.shape[-1]
    cap = capacity
    for rnd in comm.rounds(fanout, axes):
        idx, vals, _, _ = fr.compact_changed(words, ref, min(cap, n_words), monoid)
        wire = vals.view(torch.int32)  # float32 words ship as their bits
        for perm in rnd.perms:
            ridx = comm.ppermute(idx, perm)
            rvals = comm.ppermute(wire, perm).view(vals.dtype)
            words = fr.scatter_combine(words, ridx, rvals, monoid)
        cap *= rnd.digit
    return words


def _by_group(x: torch.Tensor, comm: Communicator, sparse_rows: np.ndarray,
              sparse: Callable, dense: Callable) -> torch.Tensor:
    """``sparse(x)`` on the ranks of ``sparse_rows``, ``dense(x)`` on the
    others (whole groups either way: a group's rounds stay inside it).
    When the groups disagree both branches run on every rank, and each
    rank's bytes and sends count only the branch its group took
    (``comm.collectives`` records the calls of both: both ran)."""
    if sparse_rows.all():
        return sparse(x)
    if not sparse_rows.any():
        return dense(x)
    b0, s0 = comm.bytes_sent.copy(), comm.sends.copy()
    out_dense = dense(x)
    b_dense, s_dense = comm.bytes_sent.copy(), comm.sends.copy()
    comm.bytes_sent[:], comm.sends[:] = b0, s0
    out_sparse = sparse(x)
    comm.bytes_sent[:] = np.where(sparse_rows, comm.bytes_sent, b_dense)
    comm.sends[:] = np.where(sparse_rows, comm.sends, s_dense)
    pick = torch.as_tensor(sparse_rows, device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(pick, out_sparse, out_dense)


def butterfly_reduce_sparse(x: torch.Tensor, comm: Communicator, monoid: Monoid, *,
                            fanout: int = 2, capacity: int = 256,
                            ref: Optional[torch.Tensor] = None, fallback: bool = True,
                            use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """Monoid all-reduce of ``x[P, W]`` shipping COMPACT ``(word_index,
    word)`` pairs of the words changed since ``ref`` (a ``[W]`` buffer the
    ranks share; the identity by default, which for OR makes "changed" ==
    "nonzero"), padded with ``(0, identity)``.

    The idempotence/delta dichotomy of the reference holds: an idempotent
    monoid may take any replicated-consistent ``ref`` whose changes are
    combine-improvements; a non-idempotent one only ``ref=None``
    (:class:`~repro_torch.core.monoid.MonoidContractError` otherwise).

    ``fallback=True`` guards the only overflow condition, the INITIAL
    changed count of the busiest rank of each group over ``axes`` against
    ``capacity``: the counts are read on the host and a group that
    overflows runs the dense :func:`butterfly_reduce` instead (its merges
    through ``bitmap_or_reduce`` for OR), so truncation never corrupts the
    result.  ``fallback=False`` skips the guard and the read (callers that
    pre-checked the count)."""
    monoid.check_sparse_ref(ref)
    n_words = x.shape[-1]
    ref_arr = monoid.identity_like(x) if ref is None else ref

    def sparse(w):
        return _sparse_rounds(w, comm, monoid, fanout, capacity, ref_arr, axes)

    if not fallback:
        return sparse(x)
    (count,) = comm.group_max([fr.changed_count(x, ref_arr)], axes)
    return _by_group(x, comm, count <= min(capacity, n_words), sparse,
                     lambda w: butterfly_reduce(w, comm, monoid, fanout=fanout,
                                                use_kernels=use_kernels, axes=axes))


def butterfly_reduce_adaptive(x: torch.Tensor, comm: Communicator, monoid: Monoid, *,
                              fanout: int = 2, capacity: int = 256,
                              density_threshold: float = 0.02,
                              ref: Optional[torch.Tensor] = None,
                              use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """Per-call dense/sparse dispatch keyed on the CHANGED-word density:
    sparse when the busiest rank's changed-since-``ref`` word count (of
    each group over ``axes``) stays under ``density_threshold`` of ``W``
    and fits ``capacity``, dense otherwise; the counts are read on the
    host."""
    monoid.check_sparse_ref(ref)
    n_words = x.shape[-1]
    cap = min(capacity, n_words)
    ref_arr = monoid.identity_like(x) if ref is None else ref
    (changed,) = comm.group_max([fr.changed_count(x, ref_arr)], axes)
    go_sparse = (changed <= int(density_threshold * n_words)) & (changed <= cap)
    return _by_group(
        x, comm, go_sparse,
        lambda w: butterfly_reduce_sparse(w, comm, monoid, fanout=fanout, capacity=cap,
                                          ref=ref, fallback=False, axes=axes),
        lambda w: butterfly_reduce(w, comm, monoid, fanout=fanout,
                                   use_kernels=use_kernels, axes=axes))


def butterfly_or_sparse(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                        capacity: int = 256, fallback: bool = True,
                        use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """Bitmap OR-merge shipping compact pairs: the OR-monoid instance of
    :func:`butterfly_reduce_sparse`."""
    return butterfly_reduce_sparse(x, comm, mono.OR_U32, fanout=fanout,
                                   capacity=capacity, fallback=fallback,
                                   use_kernels=use_kernels, axes=axes)


def adaptive_counts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adaptive OR sync's two statistics of ``x[P, W]`` on the device:
    the busiest rank's popcount and its nonzero-word count."""
    return fr.popcount(x, dim=-1).max(), fr.count_nonzero(x).max()


def butterfly_or_adaptive(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                          capacity: int = 256, density_threshold: float = 0.02,
                          use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """Per-call dense/sparse dispatch keyed on the frontier's density.

    In the BFS level loop this decides EVERY level: sparse when the
    densest rank's popcount (of each group over ``axes``) stays under
    ``density_threshold`` of the bitmap bits AND its nonzero-word count
    fits ``capacity`` (the sparse path's no-overflow precondition, so it
    runs without the guard), dense otherwise.  The two counts of every
    group are read on the host in one transfer."""
    n_words = x.shape[-1]
    cap = min(capacity, n_words)
    pops, nz = comm.group_max([fr.popcount(x, dim=-1), fr.count_nonzero(x)], axes)
    return _by_group(
        x, comm, (pops <= bits_limit(n_words, density_threshold)) & (nz <= cap),
        lambda w: butterfly_or_sparse(w, comm, fanout=fanout, capacity=cap,
                                      fallback=False, axes=axes),
        lambda w: butterfly_or(w, comm, fanout=fanout, use_kernels=use_kernels,
                               axes=axes))


# ---------------------------------------------------------------------------
# Beyond-paper: Rabenseifner on the butterfly wiring
# ---------------------------------------------------------------------------


def _global_stages(comm: Communicator, fanout: int, axes: Axes = None):
    """The rounds over ``axes`` most-significant digit first: the first
    axis least significant, each axis's rounds least-significant digit
    first, the flat list reversed (the reference's ``_global_stages``)."""
    return comm.rounds(fanout, axes)[::-1]


def _ranges(lo: np.ndarray, chunks: int, chunk_elems: int, device) -> torch.Tensor:
    """int64[P, chunks * chunk_elems]: the element indices of each rank's
    range of ``chunks`` chunks starting at chunk ``lo[r]``."""
    start = torch.as_tensor(lo * chunk_elems, dtype=torch.int64, device=device)
    return start[:, None] + torch.arange(chunks * chunk_elems, device=device)


def butterfly_reduce_scatter(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                             op: Op = "add", use_kernels: bool = True, axes: Axes = None):
    """Recursive-halving reduce-scatter over the butterfly wiring.

    Each rank's ``x[r]`` is flattened and zero-padded to a multiple of the
    group size ``G`` (the pad is the identity of add, or and unsigned
    max).  Returns ``(chunk [R, n/G], lo int64[R])`` for the ``R`` ranks
    held: each rank's ``1/G`` slice of the reduced buffer and its position
    in chunks.  The chunk offsets differ by rank, so every slice is a
    gather (and every write-back a scatter) along the rank axis; a round's
    merge runs on the contiguous ``[R, digit, chunk]`` stack."""
    g, dev, ranks = comm.group_size(axes), x.device, comm.ranks
    held = x.shape[0]
    flat = x.reshape(held, -1)
    pad = (-flat.shape[1]) % g
    flat = torch.cat([flat, flat.new_zeros((held, pad))], 1)
    ce = flat.shape[1] // g
    lo = np.zeros(held, dtype=np.int64)
    size = g
    for rnd in _global_stages(comm, fanout, axes):
        d, stride = rnd.digit, rnd.stride
        newsize = size // d
        dig = (ranks // stride) % d
        mylo = lo + dig * newsize
        mine = _ranges(mylo, newsize, ce, dev)
        stack = flat.new_empty((held, d, newsize * ce))
        stack[:, 0] = flat.gather(1, mine)
        for j, perm in enumerate(rnd.perms, start=1):
            send = _ranges(lo + ((dig + j) % d) * newsize, newsize, ce, dev)
            comm.ppermute(flat.gather(1, send), perm, out=stack[:, j])
        flat.scatter_(1, mine, _merge_stack(stack, op, use_kernels))
        lo, size = mylo, newsize
    return flat.gather(1, _ranges(lo, 1, ce, dev)), lo


def butterfly_allgather_chunks(chunk: torch.Tensor, lo: np.ndarray, total_elems: int,
                               comm: Communicator, *, fanout: int = 2,
                               axes: Axes = None) -> torch.Tensor:
    """Recursive-doubling all-gather: inverse of the reduce-scatter above.
    ``chunk[R, c]`` sits at chunk ``lo[i]`` of rank ``comm.ranks[i]``'s
    buffer; returns ``[R, total_elems]``."""
    g, dev, ranks = comm.group_size(axes), chunk.device, comm.ranks
    ce = chunk.shape[1]
    flat = chunk.new_zeros((chunk.shape[0], g * ce))
    lo = np.asarray(lo, dtype=np.int64)
    flat.scatter_(1, _ranges(lo, 1, ce, dev), chunk)
    size = 1
    for rnd in comm.rounds(fanout, axes):  # least-significant digit first
        d, stride = rnd.digit, rnd.stride
        dig = (ranks // stride) % d
        base = lo - dig * size
        mine = flat.gather(1, _ranges(lo, size, ce, dev))
        for j, perm in enumerate(rnd.perms, start=1):
            recv = comm.ppermute(mine, perm)
            flat.scatter_(1, _ranges(base + ((dig - j) % d) * size, size, ce, dev), recv)
        lo, size = base, size * d
    return flat[:, :total_elems]


def butterfly_allreduce_rabenseifner(x: torch.Tensor, comm: Communicator, *,
                                     fanout: int = 2, op: Op = "add",
                                     use_kernels: bool = True,
                                     axes: Axes = None) -> torch.Tensor:
    """All-reduce = reduce-scatter + all-gather (bandwidth-optimal):
    ``2 (G-1)/G`` of the padded buffer per rank, equal to
    ``butterfly.bytes_per_node_rabenseifner``.  ``op='or'`` gives the BFS
    bitmap merge, its rounds merged by ``bitmap_or_reduce``."""
    n = x[0].numel()
    chunk, lo = butterfly_reduce_scatter(x, comm, fanout=fanout, op=op,
                                         use_kernels=use_kernels, axes=axes)
    padded = n + (-n) % comm.group_size(axes)
    flat = butterfly_allgather_chunks(chunk, lo, padded, comm, fanout=fanout, axes=axes)
    return flat[:, :n].reshape(x.shape)


# ---------------------------------------------------------------------------
# Naive baseline the paper replaces, and the compiler's collective
# ---------------------------------------------------------------------------


def all_to_all_merge(x: torch.Tensor, comm: Communicator, *,
                     op: Op = "or", axes: Axes = None) -> torch.Tensor:
    """All-to-all broadcast-merge: ``P - 1`` ring shifts per axis, each rank
    ships its ORIGINAL buffer (the axis's input) to every peer and merges
    it with ``op`` (a name of ``_MERGE_OPS`` or a callable; the bitmap OR
    by default).  O(P^2) messages."""
    merge = _MERGE_OPS[op] if isinstance(op, str) else op
    for ring, n in comm.rings(axes):
        shifted = x
        for _ in range(n - 1):
            shifted = comm.ppermute(shifted, ring)
            x = merge(x, shifted)
    return x


def xla_allreduce(x: torch.Tensor, comm: Communicator, *, op: str = "add",
                  use_kernels: bool = True, axes: Axes = None) -> torch.Tensor:
    """The JAX package's compiler-scheduled all-reduce, on simulated ranks:
    an all-gather over the group of ``G`` ranks (each rank ships its buffer
    to the ``G - 1`` others, one shift each: ``(G - 1) * 4 W`` bytes per
    rank for int32 words) into a ``[R, G, W]`` stack, then a ``G``-way
    reduce over the gathered axis.  ``op`` is ``add``, ``min`` or ``max``
    (int32 words in their uint32 order, as the reference's ``pmin``/``pmax``
    order its uint32 words) or ``or`` (``bitmap_or_reduce`` with ``K =
    G``).  ``comm.collectives`` records it as one ``all-reduce`` of one
    rank's buffer, as the reference's HLO has it; its wire bytes are the
    ``G - 1`` buffers a rank really sends (the reference estimates a
    ring's ``2 N (G - 1) / G``)."""
    if op not in ("add", "min", "max", "or"):
        raise ValueError(op)
    shifts = comm.shifts(axes)
    stack = x.new_empty((x.shape[0], len(shifts) + 1) + tuple(x.shape[1:]))
    stack[:, 0] = x
    nbytes = x[0].numel() * x.element_size()
    with comm.as_one("all-reduce", nbytes, len(shifts) * nbytes):
        for s, perm in enumerate(shifts, start=1):
            comm.ppermute(x, perm, out=stack[:, s])
    if op == "add":
        return stack.sum(1, dtype=x.dtype)
    return _merge_stack(stack, op, use_kernels)


# ---------------------------------------------------------------------------
# Gradient synchronization (DESIGN.md Sec. 7)
# ---------------------------------------------------------------------------

GRAD_SYNCS = ("xla_psum", "butterfly", "rabenseifner", "all_to_all")


def sync_leaf(g: torch.Tensor, comm: Communicator, *, method: str = "xla_psum",
              fanout: int = 2, mean: bool = True, axes: Axes = None) -> torch.Tensor:
    """Sum ``g[R, ...]`` over the ranks (over ``axes``) with ``method``
    (then divide by the group size when ``mean``): every rank's row of the
    result holds the sum."""
    if method == "xla_psum":
        out = xla_allreduce(g, comm, op="add", axes=axes)
    elif method == "butterfly":
        out = butterfly_allreduce(g, comm, fanout=fanout, axes=axes)
    elif method == "rabenseifner":
        out = butterfly_allreduce_rabenseifner(g, comm, fanout=fanout, axes=axes)
    elif method == "all_to_all":
        out = all_to_all_merge(g, comm, op="add", axes=axes)
    else:
        raise ValueError(f"unknown grad-sync method {method!r}")
    return out / comm.group_size(axes) if mean else out


def tree_sync(tree, comm: Communicator, *, method: str = "xla_psum", fanout: int = 2,
              mean: bool = True, axes: Axes = None):
    """Synchronize a gradient tree (nested dicts of ``[R, ...]`` leaves)
    across the ranks (over ``axes``), leaf by leaf.

    method: ``xla_psum`` | ``butterfly`` (paper) | ``rabenseifner``
    (beyond-paper) | ``all_to_all`` (paper's baseline)."""
    if isinstance(tree, dict):
        return {k: tree_sync(v, comm, method=method, fanout=fanout, mean=mean, axes=axes)
                for k, v in tree.items()}
    return sync_leaf(tree, comm, method=method, fanout=fanout, mean=mean, axes=axes)


def quantize_int8(acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank's float32 ``acc[r]`` as int8 codes and its scale
    ``max(max|acc[r]| / 127, 1e-30)``: ``clip(round(acc / scale), -127, 127)``,
    rounding half to even as ``jnp.round`` does."""
    amax = acc.abs().reshape(acc.shape[0], -1).amax(dim=1)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    shape = (-1,) + (1,) * (acc.dim() - 1)
    q = torch.clamp(torch.round(acc / scale.reshape(shape)), -127, 127).to(torch.int8)
    return q, scale


def butterfly_allreduce_int8(x: torch.Tensor, comm: Communicator, *,
                             fanout: int = 2, axes: Axes = None) -> torch.Tensor:
    """Butterfly sum all-reduce with **int8 on the wire every round**.

    Each round every rank quantizes its float32 accumulator with its own
    scale (:func:`quantize_int8`) and ships the codes and the float32 scale
    to each partner (``|buf| + 4`` bytes a message); a receiver dequantizes
    and adds what it receives in the round's perm order. The error
    compounds over the rounds, bounded by ``depth * max|g| / 127`` per
    element."""
    acc = x.float()
    shape = (-1,) + (1,) * (x.dim() - 1)
    for rnd in comm.rounds(fanout, axes):
        q, scale = quantize_int8(acc)
        for perm in rnd.perms:
            rq = comm.ppermute(q, perm)
            rs = comm.ppermute(scale, perm)
            acc = acc + rq.float() * rs.reshape(shape)
    return acc


def sync_leaf_int8(g: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                   mean: bool = True, axes: Axes = None) -> torch.Tensor:
    """:func:`butterfly_allreduce_int8` of ``g[R, ...]``, divided by the
    group size when ``mean``, in ``g``'s dtype."""
    out = butterfly_allreduce_int8(g, comm, fanout=fanout, axes=axes)
    return ((out / comm.group_size(axes)) if mean else out).to(g.dtype)


def tree_sync_int8(tree, comm: Communicator, *, fanout: int = 2, mean: bool = True,
                   axes: Axes = None):
    """Gradient sync with int8 wire compression (DESIGN.md §7): every leaf
    by :func:`butterfly_allreduce_int8` (the reference's ``method`` is
    ignored there too)."""
    if isinstance(tree, dict):
        return {k: tree_sync_int8(v, comm, fanout=fanout, mean=mean, axes=axes)
                for k, v in tree.items()}
    return sync_leaf_int8(tree, comm, fanout=fanout, mean=mean, axes=axes)


def grad_sync_bytes(method: str, p, fanout: int, n: int, itemsize: int,
                    compress: Optional[str] = None) -> int:
    """The bytes one rank sends to sync a leaf of ``n`` elements of
    ``itemsize`` bytes: the byte model of each method. ``p`` is the rank
    count, or the sizes of the axes synced over in order (hierarchical:
    the full-buffer rounds, int8's messages and all-to-all's ring shifts
    add up axis by axis; Rabenseifner and ``xla_psum`` see the group of
    ``prod(p)`` ranks, Rabenseifner's buffer padded to a multiple of it;
    int8: one byte an element and a 4-byte scale a message)."""
    sizes = (p,) if isinstance(p, (int, np.integer)) else tuple(p)
    g = math.prod(sizes)
    if compress == "int8":
        return butterfly.messages_per_node(sizes, fanout) * (n + 4)
    if method == "butterfly":
        return butterfly.bytes_per_node_allreduce(sizes, fanout, n * itemsize)
    if method == "rabenseifner":
        return butterfly.bytes_per_node_rabenseifner(g, fanout, (n + (-n) % g) * itemsize)
    if method == "all_to_all":
        return butterfly.bytes_per_node_all_to_all(sizes, n * itemsize)
    if method == "xla_psum":
        return butterfly.bytes_per_node_allgather(sizes, n * itemsize)
    raise ValueError(f"unknown grad-sync method {method!r}")


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------


def _axis_dim(dim: int, ndim: int) -> int:
    """``dim`` of a replicated tensor of ``ndim`` dims, as a non-negative index."""
    return dim % ndim


def _sim_cat(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[M, ..., n, ...]`` -> ``[..., M * n, ...]``: the M blocks laid end to
    end along ``dim`` (of the result) in model order."""
    d = _axis_dim(dim, t.dim() - 1)
    return t.movedim(0, d).flatten(d, d + 1)


def _sim_split(x: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """The inverse of :func:`_sim_cat`: ``x``'s ``m`` blocks along ``dim``
    stacked on a new leading axis."""
    d = _axis_dim(dim, x.dim())
    return x.unflatten(d, (m, x.shape[d] // m)).movedim(d, 0)


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, tp, rows):
        ctx.tp, ctx.rows = tp, rows
        return x.unsqueeze(0).expand((tp.n_local,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g.contiguous(), ctx.rows), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, t, tp):
        ctx.n = t.shape[0]
        return tp._sum(t, True)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand((ctx.n,) + tuple(g.shape)), None


class _Gather(torch.autograd.Function):
    """All-gather forward; backward keeps each rank's own block of the
    (complete) gradient."""

    @staticmethod
    def forward(ctx, t, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._cat(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._own(g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """Each rank's own block forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._own(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._cat(g.contiguous(), ctx.dim), None, None


class _BatchSum(torch.autograd.Function):
    """Sum over the data axes forward (a no-op where every data group's rows
    are already in the batch), identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.data_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """Tensor parallelism over ``axes`` (the mesh's ``model`` axis) of a
    communicator's ranks.

    **Layout.** A tensor *sharded* over the model axis carries a leading axis
    of the model ranks this program holds, in model order: ``[M, ...]`` on
    simulated ranks (the :class:`Communicator` holds every rank),
    ``[1, ...]`` under a ``DistCommunicator`` (this process's rank). A
    *replicated* tensor has no such axis: on simulated ranks one copy stands
    for the M identical ones (so autograd sees it, and the loss, once);
    under ``torch.distributed`` every process holds its own. The same model
    code runs on both.

    **Rows.** The data axes split the batch. With ``group=None`` the batch
    holds the rows of every data group the communicator holds (all of them
    on simulated ranks, the process's own under ``torch.distributed``): a
    collective's per-rank bytes are its buffer's bytes over the number of
    groups folded in. ``group=g`` holds data group ``g``'s rows alone (the
    butterfly step runs each data rank in turn); only the first group's
    calls are recorded in ``collectives``, as every group runs the same
    program, and each rank's ``bytes_sent`` counts its own group's calls.

    **Collectives**, each differentiable and recorded (in :attr:`stats`,
    :attr:`bytes_sent` and the communicator's record) under its HLO kind,
    with one rank's buffer as its operand bytes and the ``(M - 1)`` buffers
    a rank sends as its wire bytes (as :func:`xla_allreduce`):

    * :meth:`copy` — identity forward, all-reduce backward: a replicated
      tensor entering sharded compute;
    * :meth:`reduce` — all-reduce forward, identity backward: the partial
      sums of row-parallel compute;
    * :meth:`gather` — an all-gather along a dimension (backward keeps the
      rank's own block);
    * :meth:`split` — the rank's own block (backward all-gathers);
    * :meth:`max` — a max all-reduce, no gradient (the vocab-parallel
      log-sum-exp's shift)."""

    def __init__(self, comm: Communicator, axes: Axes = ("model",), *,
                 group: Optional[int] = None):
        axes = _as_axes(axes)
        missing = [a for a in axes if a not in comm.mesh.axis_names]
        if missing:
            raise ValueError(f"mesh {comm.mesh.axis_names} has no axis {missing}")
        self.comm, self.axes = comm, axes
        self.size = comm.group_size(axes)
        self.rest = tuple(a for a in comm.mesh.axis_names if a not in axes)
        model_idx = comm.mesh.group_index(comm.ranks, axes)
        data_idx = comm.mesh.group_index(comm.ranks, self.rest)
        held = sorted(set(int(g) for g in data_idx))
        if group is not None and group not in held:
            raise ValueError(f"data group {group} is not held (held: {held})")
        self.mask = np.ones(len(comm.ranks), bool) if group is None else data_idx == group
        self.local = np.unique(model_idx[self.mask])
        self.n_local = len(self.local)
        self.rows = len(held) if group is None else 1
        self.recording = group is None or group == held[0]
        # the batch is one share of the global batch's rows: other processes
        # hold the other data groups' (under torch.distributed)
        self.split_rows = group is None and len(held) < comm.p // self.size
        self.stats = empty_stats()
        self.calls: List[Tuple[str, int]] = []  # (kind, operand bytes) in order
        self.bytes_sent = np.zeros(len(comm.ranks), dtype=np.int64)
        if hasattr(comm, "subgroup"):
            comm.subgroup(axes)
            if self.rest:
                comm.subgroup(self.rest)

    def for_group(self, group: int) -> "TensorParallel":
        """The same axes with data group ``group``'s rows alone, sharing this
        object's record."""
        tp = TensorParallel(self.comm, self.axes, group=group)
        tp.stats, tp.calls, tp.bytes_sent = self.stats, self.calls, self.bytes_sent
        return tp

    def for_batch(self, batch: int) -> "TensorParallel":
        """This object, or, where ``batch`` rows do not split over the data
        groups it folds in (fewer rows than groups: the reference's spec
        then replicates the batch over the data axes), a view that counts
        the whole batch on every data group, sharing this object's
        record."""
        if batch % self.rows == 0:
            return self
        tp = copy.copy(self)
        tp.rows = 1
        return tp

    def reset(self) -> None:
        """Zero the record (:attr:`stats`, :attr:`calls`, :attr:`bytes_sent`)."""
        self.stats.update(empty_stats())
        self.calls.clear()
        self.bytes_sent[:] = 0

    # -- parameters --------------------------------------------------------

    @property
    def model_mesh(self) -> SimMesh:
        """The model axes alone: a parameter's blocks are its ``place``
        on this mesh."""
        return SimMesh(tuple(self.comm.mesh.shape[a] for a in self.axes), self.axes)

    def split_dim(self, pd: shd.PD) -> Optional[int]:
        """The dimension of ``pd`` split over the model axes (the rules'
        divisibility fallback applied), or None: replicated."""
        spec = shd.spec_for(pd, shd.MeshRules(model=self.axes), self.comm.mesh)
        for i, entry in enumerate(spec):
            if entry is not None:
                return i
        return None

    def param_shape(self, pd: shd.PD) -> Tuple[int, ...]:
        """The held blocks of ``pd``: ``[n_local, *block]`` when split, else
        its shape."""
        d = self.split_dim(pd)
        if d is None:
            return tuple(pd.shape)
        block = list(pd.shape)
        block[d] //= self.size
        return (self.n_local,) + tuple(block)

    def _spec(self, ndim: int, dim: int) -> shd.Spec:
        axes = self.axes[0] if len(self.axes) == 1 else self.axes
        return (None,) * dim + (axes,) + (None,) * (ndim - dim - 1)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A global tensor split along ``dim`` -> the held blocks
        ``[n_local, *block]``: :func:`~repro_torch.dist.sharding.place` on
        the model axes, the held ranks kept."""
        blocks = shd.place(x, self._spec(x.dim(), dim), self.model_mesh)
        if self.n_local == self.size:
            return blocks
        return blocks[torch.as_tensor(self.local, device=x.device)]

    def unshard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The inverse of :meth:`shard`: the global tensor, by
        :func:`~repro_torch.dist.sharding.gather` when every block is held,
        else by an all-gather over the model axes (unrecorded: it moves a
        checkpoint, not a step)."""
        if self.n_local == self.size:
            return shd.gather(t, self._spec(t.dim() - 1, dim), self.model_mesh)
        return self.comm.axis_cat(t.contiguous(), self.axes, dim)

    def local_index(self, device) -> torch.Tensor:
        """int64[n_local]: the model rank of each held block."""
        return torch.as_tensor(self.local, dtype=torch.int64, device=device)

    # -- recording ---------------------------------------------------------

    def _record(self, kind: str, nbytes: int, wire: int) -> None:
        if self.recording:
            self.calls.append((kind, nbytes))
            rec = self.stats[kind]
            rec["count"] += 1
            rec["operand_bytes"] += float(nbytes)
            rec["wire_bytes"] += float(wire)
            self.comm.record(kind, nbytes, wire)
        self.bytes_sent[self.mask] += wire
        self.comm.bytes_sent[self.mask] += wire

    def _rank_bytes(self, numel: int, itemsize: int, rows: bool) -> int:
        n = numel * itemsize
        if rows:
            if n % self.rows:
                raise ValueError(f"{n} bytes do not split over {self.rows} data groups")
            n //= self.rows
        return n

    # -- primitives (differentiable wrappers below) ------------------------

    def _sum(self, t: torch.Tensor, rows: bool) -> torch.Tensor:
        nbytes = self._rank_bytes(t[0].numel(), t.element_size(), rows)
        self._record("all-reduce", nbytes, (self.size - 1) * nbytes)
        return self.comm.axis_sum(t, self.axes)

    def _cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        nbytes = self._rank_bytes(t[0].numel(), t.element_size(), True)
        self._record("all-gather", nbytes, (self.size - 1) * nbytes)
        return self.comm.axis_cat(t, self.axes, dim)

    def _own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        blocks = _sim_split(x, self.size, dim)
        if self.n_local == self.size:
            return blocks
        return blocks[torch.as_tensor(self.local, device=x.device)]

    # -- the collectives ---------------------------------------------------

    def copy(self, x: torch.Tensor, rows: bool = True) -> torch.Tensor:
        """Replicated ``x`` -> ``[n_local, *x.shape]``; all-reduce backward
        (``rows=False``: ``x`` holds no batch rows, e.g. a parameter)."""
        return _Copy.apply(x, self, rows)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``[n_local, ...]`` partial sums -> their replicated sum."""
        return _Reduce.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``[n_local, ..., n, ...]`` blocks -> replicated ``[..., M * n, ...]``."""
        return _Gather.apply(t, self, dim)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Replicated ``x`` -> each held rank's block along ``dim``."""
        return _Split.apply(x, self, dim)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``[n_local, ...]`` -> the replicated elementwise max (no gradient)."""
        t = t.detach()
        nbytes = self._rank_bytes(t[0].numel(), t.element_size(), True)
        self._record("all-reduce", nbytes, (self.size - 1) * nbytes)
        return self.comm.axis_max(t, self.axes)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated scalar summed over the data axes where other
        processes hold other groups' rows (identity backward); else ``x``."""
        return _BatchSum.apply(x, self)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axes where other processes hold the
        other data groups' rows (the GSPMD step's gradient and loss
        all-reduces), recorded in the communicator's record only (not a
        model-axis call); else ``t``."""
        if not self.split_rows:
            return t
        nbytes = t.numel() * t.element_size()
        groups = self.comm.group_size(self.rest)
        self.comm.record("all-reduce", nbytes, (groups - 1) * nbytes)
        self.comm.bytes_sent[self.mask] += (groups - 1) * nbytes
        return self.comm.axis_sum(t.unsqueeze(0), self.rest)

    def sum_stat(self, t: torch.Tensor, dim: int, ranks: int = 1) -> torch.Tensor:
        """An optimizer statistic ``t`` (the model axis at ``dim``, size
        ``n_local``) summed over the model ranks, every rank's copy kept:
        an all-reduce of one rank's slice, recorded without rows (``ranks``:
        how many ranks' statistics one slice holds, e.g. the held data
        ranks of an FSDP leaf)."""
        return _sum_stat(self, t, dim, ranks)


def _sum_stat(par, t: torch.Tensor, dim: int, ranks: int) -> torch.Tensor:
    """``t`` summed over ``par``'s axes along its held axis ``dim``, every
    rank's copy kept; one all-reduce of a rank's share of a slice."""
    moved = t.movedim(dim, 0).contiguous()
    nbytes = moved[0].numel() * moved.element_size() // ranks
    par._record("all-reduce", nbytes, (par.size - 1) * nbytes)
    total = par.comm.axis_sum(moved, par.axes)
    return total.unsqueeze(0).expand_as(moved).movedim(0, dim)


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) over the data axes
# ---------------------------------------------------------------------------


class _FsdpGather(torch.autograd.Function):
    """All-gather forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, t, fs, dim, ranks):
        ctx.fs, ctx.dim, ctx.ranks = fs, dim, ranks
        return fs._gather(t, dim, ranks)

    @staticmethod
    def backward(ctx, g):
        return ctx.fs._reduce_scatter(g.contiguous(), ctx.dim, ctx.ranks), None, None, None


class FullyShardedData:
    """FSDP (ZeRO-3) over ``axes`` (the rules' ``fsdp`` axes, the batch
    axes) of a communicator's ranks.

    **Layout.** A parameter leaf whose ``embed`` dimension the spec splits
    over the data axes (``shd.held_block``) holds a leading axis of the
    data ranks this program holds: ``[D, ...]`` on simulated ranks,
    ``[1, ...]`` under a ``DistCommunicator``; each entry is that rank's
    block of what the model axis's :class:`TensorParallel` would hold (the
    leaf's ``[n_local, *block]`` when it is split over the model axis too,
    else its global shape), cut along the ``embed`` dimension. A leaf the
    spec leaves whole over the data axes (no ``embed`` dimension, or one
    that does not divide) is held as without FSDP.

    **Collectives**, recorded (in :attr:`stats`, :attr:`calls`,
    :attr:`bytes_sent` and the communicator's record) under the HLO's
    kinds and byte conventions (``hlo_stats``): :meth:`gather` is an
    all-gather (operand one rank's block, wire ``(D - 1)`` blocks) whose
    backward is the gradient's reduce-scatter (operand the whole gradient,
    wire ``(D - 1)`` blocks). On simulated ranks the batch of every data
    rank passes at once, so the gradient autograd hands the reduce-scatter
    is already the sum over the data ranks: it keeps each rank's block.
    Under ``torch.distributed`` each process's gradient is its own rows',
    and ``axis_reduce_scatter`` sums them.

    **Rows.** Where other processes hold the other data ranks
    (:attr:`split_rows`) the train step takes this rank's rows, and
    :meth:`data_sum` / :meth:`batch_sum` sum what the whole-batch step
    sums (a leaf held whole, the loss's sums) over the data axes."""

    def __init__(self, comm: Communicator, axes: Axes):
        axes = _as_axes(axes)
        missing = [a for a in axes if a not in comm.mesh.axis_names]
        if missing:
            raise ValueError(f"mesh {comm.mesh.axis_names} has no axis {missing}")
        self.comm, self.axes = comm, axes
        self.size = comm.group_size(axes)
        self.local = np.unique(comm.mesh.group_index(comm.ranks, axes))
        self.n_local = len(self.local)
        self.split_rows = self.n_local < self.size
        self.stats = empty_stats()
        self.calls: List[Tuple[str, int]] = []  # (kind, operand bytes) in order
        self.bytes_sent = np.zeros(len(comm.ranks), dtype=np.int64)
        if hasattr(comm, "subgroup"):
            comm.subgroup(axes)

    def reset(self) -> None:
        """Zero the record (:attr:`stats`, :attr:`calls`, :attr:`bytes_sent`)."""
        self.stats.update(empty_stats())
        self.calls.clear()
        self.bytes_sent[:] = 0

    # -- parameters --------------------------------------------------------

    def split_dim(self, pd: shd.PD) -> Optional[int]:
        """The dimension of ``pd`` split over the data axes (the rules'
        divisibility fallback applied), or None: held whole."""
        return shd.held_block(pd, shd.MeshRules(fsdp=self.axes), self.comm.mesh)[1]

    def param_shape(self, pd: shd.PD, tp=None) -> Tuple[int, ...]:
        """The held blocks of ``pd``: ``[n_local, *block]`` of ``tp``'s
        held form when split over the data axes, else ``tp``'s held form."""
        shape = tuple(pd.shape) if tp is None else tp.param_shape(pd)
        d = self.split_dim(pd)
        if d is None:
            return shape
        out = list(shape)
        out[d + len(shape) - len(pd.shape)] //= self.size
        return (self.n_local,) + tuple(out)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` (a leaf's global or model-held form) -> the held data
        ranks' blocks along ``dim``: ``[n_local, *block]``, a new tensor."""
        blocks = _sim_split(x, self.size, dim)
        if self.n_local == self.size:
            return blocks.clone(memory_format=torch.contiguous_format)
        return blocks[torch.as_tensor(self.local, device=x.device)]

    def unshard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The inverse of :meth:`shard` (``dim`` of the result): laid end to
        end when every block is held, else all-gathered over the data axes
        (unrecorded: it moves a checkpoint, not a step)."""
        if self.n_local == self.size:
            return _sim_cat(t, dim)
        return self.comm.axis_cat(t.contiguous(), self.axes, dim)

    def gather_param(self, prm: torch.Tensor) -> torch.Tensor:
        """A held parameter (``prm.fsdp_dim`` its split dimension of the
        global leaf) -> what the model axis alone would hold, through
        :meth:`gather`; the result carries the parameter's ``tp_dim``."""
        tp = prm.tp_dim is not None
        out = self.gather(prm, prm.fsdp_dim + int(tp), prm.shape[1] if tp else 1)
        out.tp_dim, out.fsdp_dim = prm.tp_dim, None
        return out

    # -- recording ---------------------------------------------------------

    def _record(self, kind: str, nbytes: int, wire: int) -> None:
        self.calls.append((kind, nbytes))
        rec = self.stats[kind]
        rec["count"] += 1
        rec["operand_bytes"] += float(nbytes)
        rec["wire_bytes"] += float(wire)
        self.comm.record(kind, nbytes, wire)
        self.bytes_sent += wire
        self.comm.bytes_sent += wire

    # -- the collectives ---------------------------------------------------

    def _gather(self, t: torch.Tensor, dim: int, ranks: int) -> torch.Tensor:
        block = t.numel() * t.element_size() // (self.n_local * ranks)
        self._record("all-gather", block, (self.size - 1) * block)
        return self.comm.axis_cat(t, self.axes, dim)

    def _reduce_scatter(self, g: torch.Tensor, dim: int, ranks: int) -> torch.Tensor:
        full = g.numel() * g.element_size() // ranks
        self._record("reduce-scatter", full, (self.size - 1) * (full // self.size))
        if not self.split_rows:  # autograd already summed every data rank's rows
            return _sim_split(g, self.size, dim)
        return self.comm.axis_reduce_scatter(g.unsqueeze(0), self.axes, dim)

    def gather(self, t: torch.Tensor, dim: int, ranks: int = 1) -> torch.Tensor:
        """``[n_local, ..., n, ...]`` blocks -> ``[..., D * n, ...]`` (``dim``
        of the result); the gradient reduce-scattered back. ``ranks``: how
        many model ranks' blocks one data rank's entry holds."""
        return _FsdpGather.apply(t, self, dim, ranks)

    def sum_stat(self, t: torch.Tensor, dim: int, ranks: int = 1) -> torch.Tensor:
        """As :meth:`TensorParallel.sum_stat`, over the data axes."""
        return _sum_stat(self, t, dim, ranks)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a leaf held whole) summed over the data axes where other
        processes hold the other data ranks' rows, recorded in the
        communicator's record only; else ``t``."""
        if not self.split_rows:
            return t
        nbytes = t.numel() * t.element_size()
        self.comm.record("all-reduce", nbytes, (self.size - 1) * nbytes)
        self.comm.bytes_sent += (self.size - 1) * nbytes
        return self.comm.axis_sum(t.unsqueeze(0), self.axes)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar summed over the data axes where other processes hold
        other data ranks' rows (identity backward); else ``x``."""
        return _BatchSum.apply(x, self)
