"""Frontier merges over simulated ranks (BFS phase 2).

The port of the dense OR merges of ``repro.core.collectives``.  The P
ranks are the leading axis of a ``[P, W]`` tensor on one device, and a
:class:`Communicator` plays the network: :meth:`Communicator.ppermute`
is an explicit copy of every rank's buffer to its partner, and it counts
the bytes each rank sends.

* :func:`butterfly_or` — the paper's butterfly (Alg. 2 phase 2): every
  round ships the full accumulator to ``digit - 1`` partners and merges
  the ``digit`` buffers with one ``bitmap_or_reduce`` launch.
* :func:`all_to_all_merge` — the baseline the paper replaces: ``P - 1``
  ring shifts, each merged with ``|``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import butterfly
from repro_torch.kernels import bitmap_merge, ref


class Communicator:
    """P simulated ranks on one device, with a per-rank send counter.

    ``bytes_sent[r]`` counts the bytes rank ``r`` has put on the wire; the
    butterfly's count must equal ``butterfly.bytes_per_node_allreduce``."""

    def __init__(self, p: int, device):
        self.p = int(p)
        self.device = torch.device(device)
        self.bytes_sent = np.zeros(self.p, dtype=np.int64)
        self._perms: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._schedules: Dict[int, butterfly.Schedule] = {}

    def schedule(self, fanout: int) -> butterfly.Schedule:
        if fanout not in self._schedules:
            self._schedules[fanout] = butterfly.build_schedule(self.p, fanout)
        return self._schedules[fanout]

    def _perm(self, perm: Sequence[int]) -> torch.Tensor:
        key = tuple(int(d) for d in perm)
        if key not in self._perms:
            if sorted(key) != list(range(self.p)):
                raise ValueError(f"{key} is not a permutation of {self.p} ranks")
            self._perms[key] = torch.tensor(key, dtype=torch.int64,
                                            device=self.device)
        return self._perms[key]

    def ppermute(self, x: torch.Tensor, perm: Sequence[int],
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``recv[perm[src]] = x[src]`` for every rank ``src``: the wire.

        ``out`` (a ``[P, ...]`` view, e.g. one slot of a receive stack)
        takes the copy in place of a fresh buffer."""
        if x.shape[0] != self.p:
            raise ValueError(f"buffer has {x.shape[0]} ranks, expected {self.p}")
        recv = torch.empty_like(x) if out is None else out
        recv.index_copy_(0, self._perm(perm), x)
        self.bytes_sent += x[0].numel() * x.element_size()
        return recv


def butterfly_or(x: torch.Tensor, comm: Communicator, *, fanout: int = 2,
                 use_kernels: bool = True) -> torch.Tensor:
    """OR-merge ``x[P, W]`` across all ranks with the butterfly schedule.

    Round by round (``butterfly.build_schedule(P, fanout).rounds``), each
    rank's accumulator and the ``digit - 1`` buffers it receives are
    stacked into ``[P, digit, W]`` and merged in one ``bitmap_or_reduce``
    (the CUDA kernel; its plain version when ``use_kernels`` is False)."""
    merge = bitmap_merge.bitmap_or_reduce if use_kernels else ref.bitmap_or_reduce
    for rnd in comm.schedule(fanout).rounds:
        stack = x.new_empty((x.shape[0], rnd.digit) + tuple(x.shape[1:]))
        stack[:, 0] = x
        for j, perm in enumerate(rnd.perms, start=1):
            comm.ppermute(x, perm, out=stack[:, j])
        x = merge(stack)
    return x


def all_to_all_merge(x: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """All-to-all broadcast-merge: ``P - 1`` ring shifts, each rank ships
    its ORIGINAL buffer to every peer.  O(P^2) messages."""
    ring = [(i + 1) % comm.p for i in range(comm.p)]
    shifted = x
    for _ in range(comm.p - 1):
        shifted = comm.ppermute(shifted, ring)
        x = x | shifted
    return x
