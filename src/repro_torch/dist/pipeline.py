"""GPipe pipeline parallelism on a ``stage`` mesh axis (DESIGN.md §11).

The port of ``repro.dist.pipeline`` on simulated devices.  The stacked
per-layer weights ``(L, ...)`` are split into ``S = |stage|`` contiguous
stage slices; microbatches ``(M, mb, d)`` stream through the stages with
one handoff per tick, a :meth:`Communicator.ppermute` ``(s -> s + 1)`` on
the stage axis (the last stage sends nothing; stage 0 receives zeros).
The schedule runs ``M + S - 1`` ticks (the GPipe bubble); stage ``s``
computes microbatch ``t - s`` at tick ``t``, and on zeros where there is
none, as the reference's scan does.  The rows of a microbatch are split
over the non-stage axes (row-major over them).  The result is the last
stage's outputs, what the reference's masked ``psum`` over ``stage``
(the last stage's outputs plus the others' zeros) gives every stage.
Every step is a PyTorch op, so autograd differentiates the
whole pipeline; the handoff's copy carries the gradient back along the
reverse handoff, as ``ppermute`` transposes in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.collectives import Communicator
from repro_torch.dist.sharding import SimMesh


def build_pipelined_apply(mesh: SimMesh, stage_fn: Callable) -> Callable:
    """Returns ``f(stacked_params, microbatches, comm=None) -> outputs``.

    * ``stacked_params``: ``(L, ...)`` per-layer weights, ``L % S == 0``;
      stage ``s`` runs layers ``[s*L/S, (s+1)*L/S)`` via
      ``stage_fn(stage_params, x)``.
    * ``microbatches``: ``(M, mb, d)``; the rows of each are split over
      the non-stage mesh axes.
    * ``comm``: the :class:`Communicator` over ``mesh`` whose counters take
      the handoffs (a fresh one by default): each stage but the last sends
      ``M + S - 1`` messages of one device's ``(mb / D, d)`` block.
    """
    s_total = mesh.shape["stage"]
    data_axes = tuple(a for a in mesh.axis_names if a != "stage")
    ranks = np.arange(mesh.ranks)
    stage = mesh.group_index(ranks, ("stage",))
    block = mesh.group_index(ranks, data_axes)
    n_blocks = mesh.ranks // s_total
    # each stage hands its block to the next stage's device of the same block
    at = {(int(s), int(b)): int(r) for r, s, b in zip(ranks, stage, block)}
    handoff = [at[(int(s) + 1, int(b))] if s + 1 < s_total else None
               for s, b in zip(stage, block)]
    last = [at[(s_total - 1, b)] for b in range(n_blocks)]

    def apply(stacked: torch.Tensor, mbs: torch.Tensor,
              comm: Optional[Communicator] = None) -> torch.Tensor:
        if stacked.shape[0] % s_total:
            raise ValueError(f"{stacked.shape[0]} layers do not split into {s_total} stages")
        m, mb = mbs.shape[:2]
        if mb % n_blocks:
            raise ValueError(f"a microbatch of {mb} rows does not split {n_blocks} ways")
        comm = Communicator(mesh, mbs.device) if comm is None else comm
        lps = stacked.shape[0] // s_total
        weights = [stacked[s * lps:(s + 1) * lps] for s in range(s_total)]
        rows = mb // n_blocks
        feed = mbs.reshape((m, n_blocks, rows) + tuple(mbs.shape[2:]))
        carry = mbs.new_zeros((mesh.ranks, rows) + tuple(mbs.shape[2:]))
        outs = []
        for t in range(m + s_total - 1):
            ys = []
            for r in range(mesh.ranks):
                if stage[r] == 0:  # stage 0 consumes the feed (zeros in the bubble)
                    x_in = feed[t, block[r]] if t < m else torch.zeros_like(carry[r])
                else:
                    x_in = carry[r]
                ys.append(stage_fn(weights[stage[r]], x_in))
            y = torch.stack(ys)
            carry = comm.ppermute(y, handoff)
            if t >= s_total - 1:
                # the masked psum over stage: the last stage's blocks
                outs.append(torch.stack([y[last[b]] for b in range(n_blocks)]))
        return torch.stack(outs).reshape(mbs.shape[:1] + (mb,) + tuple(y.shape[2:]))

    return apply
