"""K-way OR of packed bitmaps: the wrapper of the CUDA kernel that
replaces ``repro.kernels.bitmap_merge``.

The butterfly merge of :mod:`repro_torch.core.collectives` calls it once
per round, on the accumulator stacked with the ``digit - 1`` buffers the
round received.  A tensor on the CPU goes to the plain version in
:mod:`.ref`; a CUDA tensor goes to ``csrc/bitmap_merge.cu``.  Each call
runs in a ``kernels.or_reduce`` span (:mod:`repro_torch.core.tracing`).
"""

from __future__ import annotations

import torch

from repro_torch.core.tracing import span
from repro_torch.kernels import bounds, build, ref


def bitmap_or_reduce(stack: torch.Tensor) -> torch.Tensor:
    """OR-reduce ``int32[B, K, W]`` along K -> ``int32[B, W]``."""
    dev = stack.device
    build.check(stack, "stack", torch.int32, 3, dev)
    b, k, w = stack.shape
    if k < 1:
        raise ValueError("nothing to merge: K == 0")
    bounds.tally("bitmap_or_reduce", lambda: bounds.or_reduce_bytes(stack))
    with span("kernels.or_reduce"):
        if build.route(stack) == "plain":
            return ref.bitmap_or_reduce(stack)
        out = torch.empty((b, w), dtype=torch.int32, device=dev)
        if out.numel():
            build.launch("bitmap_or_reduce", dev, stack.data_ptr(), out.data_ptr(),
                         b, k, w)
        return out
