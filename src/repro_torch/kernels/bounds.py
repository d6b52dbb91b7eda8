"""The least bytes each kernel call must move, tallied on request.

What a launch of each kernel must move at the least: every input read
once and the output written once, but a gather reads only the distinct
bitmap words its indices reach, and the scatter only the 32-byte sectors
of its offsets that hold an active slot (the least the memory delivers).
These are the bytes the kernels' bounds are computed from (over the
card's memory rate), and what the cost-model profiler
(:mod:`repro_torch.core.profiler`) models a run's memory traffic by.

The wrappers call :func:`tally` on both routes, the kernel's and the
plain version's, so a run on the CPU counts what the same run on the card
does.  Counting costs a sort of the indices a call, so it happens only
inside :func:`tallying`, and only for the calls of the thread that
entered it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict

import torch
import torch.nn.functional as F

SECTOR_BYTES = 32  # the least the device memory delivers

_LOCAL = threading.local()


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct_word_bytes(word_idx: torch.Tensor) -> int:
    """Bytes of the distinct bitmap words ``word_idx[P, ...]`` reads, each
    rank's words counted apart: what a gather must read at the least."""
    p = word_idx.shape[0]
    rank = torch.arange(p, device=word_idx.device).view(p, *[1] * (word_idx.dim() - 1))
    keys = rank * (int(word_idx.max()) + 1) + word_idx.long()
    return 4 * torch.unique(keys).numel()


def gather_full_bytes(src: torch.Tensor) -> int:
    """``frontier_gather_full``: the distinct words, the ids, the bool out."""
    return distinct_word_bytes(src >> 5) + nbytes(src) + src.numel()


def gather_window_bytes(block_ws: torch.Tensor, src_local: torch.Tensor, ww: int) -> int:
    """The windowed ``frontier_gather``: the distinct words of the blocks'
    windows, the window indices, the offsets, the bool out."""
    words = (block_ws.long() * ww)[..., None] + torch.arange(ww, device=block_ws.device)
    return distinct_word_bytes(words) + nbytes(block_ws, src_local) + src_local.numel()


def scatter_least_bytes(active: torch.Tensor, block_win: torch.Tensor,
                        dst_local: torch.Tensor, out_words: int) -> int:
    """``frontier_scatter``: ``active``, ``block_win`` and the ``out_words``
    int32 output words whole, and of ``dst_local`` the sectors that hold an
    active slot (an inactive slot's offset need not be read)."""
    per = SECTOR_BYTES // dst_local.element_size()
    flat = active.reshape(-1)
    flat = F.pad(flat, (0, -flat.numel() % per))
    sectors = int(flat.view(-1, per).any(dim=1).sum())
    return nbytes(active, block_win) + 4 * out_words + SECTOR_BYTES * sectors


def or_reduce_bytes(stack: torch.Tensor) -> int:
    """``bitmap_or_reduce``: the ``[B, K, W]`` stack read, ``[B, W]`` written."""
    k = stack.shape[1]
    return nbytes(stack) // k * (k + 1)


def tally(name: str, least_bytes: Callable[[], int]) -> None:
    """Add ``least_bytes()`` to kernel ``name``'s count when this thread is
    inside :func:`tallying`; otherwise compute nothing."""
    counts = getattr(_LOCAL, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + int(least_bytes())
        counts["calls:" + name] = counts.get("calls:" + name, 0) + 1


@contextlib.contextmanager
def tallying():
    """Count the least bytes of every kernel call this thread makes inside
    the block.  Yields a dict: kernel name -> bytes, and
    ``"calls:<name>"`` -> calls (on either route)."""
    if getattr(_LOCAL, "counts", None) is not None:
        raise RuntimeError("tallying() does not nest")
    counts: Dict[str, int] = {}
    _LOCAL.counts = counts
    try:
        yield counts
    finally:
        _LOCAL.counts = None


def total_bytes(counts: Dict[str, int]) -> int:
    """The bytes of a :func:`tallying` dict, over every kernel."""
    return sum(v for k, v in counts.items() if not k.startswith("calls:"))
