"""Plain PyTorch versions of the four frontier kernels.

The counterparts of ``repro.kernels.ref``: the path a wrapper takes for a
tensor on the CPU, and the oracle each CUDA kernel is held against on the
card.  Every function takes the whole ``[P, ...]`` stack of simulated
ranks; words are int32 bit patterns (see :mod:`repro_torch.core.frontier`).
"""

from __future__ import annotations

import torch

from repro_torch.core import frontier as fr


def bitmap_or_reduce(stack: torch.Tensor) -> torch.Tensor:
    """OR-reduce ``int32[..., K, W]`` along K -> ``int32[..., W]``."""
    out = stack[..., 0, :]
    for k in range(1, stack.shape[-2]):
        out = out | stack[..., k, :]
    return out


def frontier_gather(words: torch.Tensor, block_ws: torch.Tensor,
                    src_local: torch.Tensor, ww: int) -> torch.Tensor:
    """Windowed bit-gather: ``words[P, W]``, ``block_ws[P, NB]``,
    ``src_local[P, NB, EB]`` (bit offset inside window ``block_ws * ww``
    words) -> bool[P, NB, EB]."""
    gsrc = block_ws[..., None].long() * (ww * 32) + src_local.long()
    p = words.shape[0]
    return fr.get_bits(words, gsrc.reshape(p, -1)).reshape(src_local.shape)


def frontier_gather_full(words: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Bits of ``words[P, W]`` at vertex ids ``src[P, ...]`` -> bool."""
    p = words.shape[0]
    return fr.get_bits(words, src.reshape(p, -1)).reshape(src.shape)


def frontier_scatter(active: torch.Tensor, block_win: torch.Tensor,
                     dst_local: torch.Tensor, n_windows: int,
                     ww: int) -> torch.Tensor:
    """Windowed scatter-OR -> ``int32[P, n_windows * ww]``.

    ``active[P, NB, EB]``, ``block_win[P, NB]`` (window of each block),
    ``dst_local[P, NB, EB]`` (bit offset in the window; ``ww*32`` marks a
    padding slot).  Windows that no block covers are zero."""
    bits = ww * 32
    valid = (dst_local < bits) & active.bool()
    gdst = block_win[..., None].long() * bits + torch.clamp(dst_local, max=bits - 1)
    p = active.shape[0]
    return fr.scatter_or(n_windows * ww, gdst.reshape(p, -1), valid.reshape(p, -1))
