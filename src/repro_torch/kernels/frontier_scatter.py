"""Frontier scatter-OR: the wrapper of the CUDA kernel that replaces
``repro.kernels.frontier_scatter``.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor goes to the kernel in ``csrc/frontier_scatter.cu``, which takes the
whole ``[P, ...]`` rank stack in one launch.  The reference's
``block_first`` flags are not an input: the kernel zero-fills the output
and every warp ORs its window tile into it atomically.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bounds, build, ref

#: The widest window: a warp's tile of ``ww`` words lives in shared memory,
#: and a CTA may take 48 KB of it without opting in.
MAX_WINDOW_WORDS = 48 * 1024 // 4


def frontier_scatter(active: torch.Tensor, block_win: torch.Tensor,
                     dst_local: torch.Tensor, *, n_windows: int,
                     ww: int) -> torch.Tensor:
    """Scatter-OR ``active`` bool[P, NB, EB] into ``int32[P, n_windows*ww]``.

    ``block_win`` int32[P, NB] is the output window of each block and
    ``dst_local`` int32[P, NB, EB] the bit offset in it; ``ww*32`` marks a
    padding slot.  Windows that no block covers are zero."""
    dev = active.device
    build.check(active, "active", torch.bool, 3, dev)
    build.check(block_win, "block_win", torch.int32, 2, dev)
    build.check(dst_local, "dst_local", torch.int32, 3, dev)
    p, nb, eb = active.shape
    if tuple(dst_local.shape) != (p, nb, eb) or tuple(block_win.shape) != (p, nb):
        raise ValueError(f"active {tuple(active.shape)}, block_win "
                         f"{tuple(block_win.shape)} and dst_local "
                         f"{tuple(dst_local.shape)} disagree")
    if not 0 < ww <= MAX_WINDOW_WORDS:
        raise ValueError(f"window of {ww} words does not fit shared memory")
    bounds.tally("frontier_scatter", lambda: bounds.scatter_least_bytes(
        active, block_win, dst_local, p * n_windows * ww))
    if build.route(active) == "plain":
        return ref.frontier_scatter(active, block_win, dst_local, n_windows, ww)
    n_out = n_windows * ww
    if not (active.numel() and n_out):
        return torch.zeros((p, n_out), dtype=torch.int32, device=dev)
    out = torch.empty((p, n_out), dtype=torch.int32, device=dev)  # zero-filled by the kernel
    build.launch("frontier_scatter", dev, active.data_ptr(), block_win.data_ptr(),
                 dst_local.data_ptr(), out.data_ptr(), p, nb, eb, n_out, ww,
                 build.vectorizable(eb, active, dst_local))
    return out
