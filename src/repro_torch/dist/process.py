"""The collectives over ``torch.distributed``: one process a rank.

:class:`DistCommunicator` has the simulated
:class:`~repro_torch.core.collectives.Communicator`'s interface, so every
sync of :mod:`repro_torch.core.collectives` runs unchanged over a process
group: each process holds its own rank's row as a leading axis of 1
(``comm.ranks == [rank]``), and :meth:`DistCommunicator.ppermute` sends
that row to ``perm[rank]`` and receives from the rank whose ``perm`` entry
is ``rank``, with ``dist.batch_isend_irecv``.  ``bytes_sent`` and
``sends`` count what this rank put on the wire, as the simulated counter
counts each rank's.

Backends:

* **gloo**, CPU tensors: sent as they are (the tests' backend).
* **gloo**, CUDA tensors: gloo's send and receive take host tensors only,
  so each message is staged explicitly through pinned host memory (copied
  off the card, sent, received, copied back); ``stage_s`` times those
  copies.  This is gloo's documented behaviour, never a fallback.
* **nccl**: CUDA tensors on the wire, one card a process (NCCL refuses two
  ranks on one card).

The tensor-parallel collectives (``core.collectives.TensorParallel``) run
over the process subgroup of each model group (:meth:`DistCommunicator.subgroup`,
every group made once by every process): ``axis_sum`` and ``axis_max`` are
``dist.all_reduce``, ``axis_cat`` is ``dist.all_gather``, staged through
the host under gloo with CUDA tensors. FSDP's gradient
(``core.collectives.FullyShardedData``) is ``axis_reduce_scatter`` over
the data axes' subgroup: ``dist.reduce_scatter_tensor`` under nccl, an
all-reduce that keeps this rank's block under gloo (which has no
reduce-scatter).

:func:`run_group` starts ``world`` processes with the ``spawn`` method (CUDA
in a child needs it), joins them into one group through a file
rendezvous, and joins them with a deadline: the first process that fails
ends the others, and the deadline kills every one.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import Communicator, route
from repro_torch.dist.sharding import SimMesh


class DistCommunicator(Communicator):
    """This process's rank of the default process group, on ``device``.

    ``mesh`` names the group's axes (its ranks row-major, as the
    simulated mesh's); by default one ``data`` axis of the world size."""

    def __init__(self, device, mesh: Optional[SimMesh] = None):
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = SimMesh(world) if mesh is None else mesh
        if mesh.ranks != world:
            raise ValueError(f"a mesh of {mesh.ranks} ranks over a group of {world}")
        super().__init__(mesh, device)
        self.rank = rank
        self.ranks = np.array([rank], dtype=np.int64)
        self.bytes_sent = np.zeros(1, dtype=np.int64)
        self.sends = np.zeros(1, dtype=np.int64)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stage_s = 0.0  # host time of the pinned staging copies
        self.wire_s = 0.0  # host time from posting a message to its arrival
        self._subgroups = {}

    def subgroup(self, axes) -> "dist.ProcessGroup":
        """This rank's process group over ``axes``: the ranks that differ
        from it only on those axes. The first call for an axis tuple
        creates every group of the mesh (``dist.new_group`` is collective:
        every process makes the same calls in the same order)."""
        axes = tuple(axes)
        if axes not in self._subgroups:
            rest = tuple(a for a in self.mesh.axis_names if a not in axes)
            every = np.arange(self.p, dtype=np.int64)
            gid = self.mesh.group_index(every, rest)
            order = np.argsort(self.mesh.group_index(every, axes), kind="stable")
            mine = None
            for g in range(int(gid.max()) + 1):
                members = [int(r) for r in every[order] if gid[r] == g]
                pg = dist.new_group(members)
                if self.rank in members:
                    mine = pg
            self._subgroups[axes] = mine
        return self._subgroups[axes]

    def _on_wire(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op(t')`` on the tensor the backend takes: a host copy under
        gloo with a CUDA tensor (staged, as :meth:`ppermute`), the result
        brought back to ``t``'s device."""
        if not self.staged:
            t0 = time.perf_counter()
            out = op(t)
            self.wire_s += time.perf_counter() - t0
            return out
        t0 = time.perf_counter()
        host = t.detach().to("cpu")
        self.stage_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = op(host)
        self.wire_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = out.to(t.device)
        self.stage_s += time.perf_counter() - t0
        return out

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        if t.shape[0] != 1:
            raise ValueError(f"buffer has {t.shape[0]} rows, expected this rank's 1")
        group = self.subgroup(axes)

        def run(x):
            x = x[0].clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, op=op, group=group)
            return x

        return self._on_wire(t, run)

    def axis_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``dist.all_reduce`` (sum) of this rank's block over ``axes``."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def axis_max(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def axis_cat(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``dist.all_gather`` of this rank's block over ``axes``, the
        blocks concatenated along ``dim`` in group order."""
        if t.shape[0] != 1:
            raise ValueError(f"buffer has {t.shape[0]} rows, expected this rank's 1")
        group = self.subgroup(axes)
        n = dist.get_world_size(group)

        def run(x):
            x = x[0].contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts, dim=dim)

        return self._on_wire(t, run)

    def axis_reduce_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of this rank's ``t[0]`` summed
        over ``axes`` (the blocks in group order): ``[1, *block]``. nccl
        reduce-scatters; gloo, which has no reduce-scatter, all-reduces
        and keeps the block (the same sum)."""
        if t.shape[0] != 1:
            raise ValueError(f"buffer has {t.shape[0]} rows, expected this rank's 1")
        group = self.subgroup(axes)
        n = dist.get_world_size(group)
        k = int(self.mesh.group_index([self.rank], tuple(axes))[0])
        d = dim % (t.dim() - 1)

        def run(x):
            x = x[0].movedim(d, 0).contiguous()
            if self.backend == "nccl":
                out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, group=group)
            else:
                dist.all_reduce(x, group=group)
                out = x.unflatten(0, (n, -1))[k]
            return out.movedim(0, d).contiguous().unsqueeze(0)

        return self._on_wire(t, run)

    def pmean(self, values: torch.Tensor) -> torch.Tensor:
        total = values.detach().sum().to(torch.float64)
        if self.backend != "nccl":  # gloo reduces host tensors
            total = total.cpu()
        dist.all_reduce(total)
        return (total / self.p).to(values.device, values.dtype)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Optional[int]],
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``recv[perm[src]] = x[src]`` across the processes: this rank's
        row goes to ``perm[rank]`` (nothing for ``None``/``-1``), and the
        row of the rank that names this one arrives (zeros if none does).
        Not differentiable."""
        if x.shape[0] != 1:
            raise ValueError(f"buffer has {x.shape[0]} rows, expected this rank's 1")
        key = route(perm, self.p)
        nbytes = x[0].numel() * x.element_size()
        self.record("collective-permute", nbytes, nbytes)
        dst = key[self.rank]
        src = key.index(self.rank) if self.rank in key else -1
        if out is None:
            recv = torch.empty_like(x) if src >= 0 else torch.zeros_like(x)
        else:
            recv = out if src >= 0 else out.zero_()
        if dst == self.rank:  # a rank that sends to itself: no wire
            recv[0].copy_(x[0])
        elif dst >= 0 or src >= 0:
            target = recv[0] if src >= 0 else None
            send = x[0].contiguous() if dst >= 0 else None
            into = target
            if self.staged:
                t0 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                if send is not None:
                    send = torch.empty(send.shape, dtype=send.dtype,
                                       pin_memory=True).copy_(send)
                if target is not None:
                    into = torch.empty(target.shape, dtype=target.dtype, pin_memory=True)
                self.stage_s += time.perf_counter() - t0
            elif target is not None and not target.is_contiguous():
                into = torch.empty_like(target)
            ops = []
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send, dst))
            if into is not None:
                ops.append(dist.P2POp(dist.irecv, into, src))
            t0 = time.perf_counter()
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.wire_s += time.perf_counter() - t0
            if into is not target:
                t0 = time.perf_counter()
                target.copy_(into)
                if self.staged:
                    torch.cuda.synchronize(self.device)
                self.stage_s += time.perf_counter() - t0
        if dst >= 0:
            self.bytes_sent[0] += nbytes
            self.sends[0] += 1
        return recv


def _entry(fn: Callable, rank: int, world: int, init_method: str, backend: str,
           timeout_s: float, args: tuple) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_group(fn: Callable, world: int, args: tuple = (), *, timeout_s: float,
              backend: str = "gloo") -> List[int]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    into one ``backend`` group (``fn`` must be importable by name: a
    module's top-level function).  Returns the exit codes (0 each when all
    succeed).  The first process to exit non-zero ends the others (killed:
    a negative code); at ``timeout_s`` every process still running is
    killed and ``TimeoutError`` raised.  No process outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, backend, timeout_s, args))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            running = [p.sentinel for p, c in zip(procs, codes) if c is None]
            if not running or any(c not in (None, 0) for c in codes):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} processes still running after {timeout_s} s")
            multiprocessing.connection.wait(running, timeout=left)
    finally:
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [p.exitcode for p in procs]
