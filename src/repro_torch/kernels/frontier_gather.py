"""Frontier bit-gather: the wrappers of the CUDA kernels that replace
``repro.kernels.frontier_gather`` (``frontier_gather_full`` and the
windowed ``frontier_gather``).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor goes to the kernel in ``csrc/frontier_gather.cu``, which takes the
whole ``[P, ...]`` rank stack in one launch.  The full gather has two
routes; :func:`plan_gather_full` picks one from the ids' order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bounds, build, ref

#: The widest window of the windowed gather (48 KB of words).
MAX_WINDOW_WORDS = 48 * 1024 // 4


def plan_gather_full(ids_sorted: bool) -> str:
    """The route of :func:`frontier_gather_full` for ids in sorted (or
    random) order.  Both read the words through L1 and L2.  Sorted ids,
    whose neighbours share words, take ``"walk"``: 4 slots a lane, a
    persistent grid.  Random ids take ``"probe"``: one slot a lane, a warp
    for every 32 slots, which measured faster on them (PERF.md)."""
    return "walk" if ids_sorted else "probe"


def frontier_gather_full(words: torch.Tensor, src: torch.Tensor, *,
                         ids_sorted: bool = False) -> torch.Tensor:
    """Bits of ``words`` int32[P, W] at vertex ids ``src`` int32[P, NB, EB]
    -> bool[P, NB, EB].  Ids outside the bitmap read as 0 on the card.

    ``ids_sorted`` says whether each rank's ids are in ascending order; it
    picks the kernel's route (:func:`plan_gather_full`), and only the speed
    depends on it."""
    dev = words.device
    build.check(words, "words", torch.int32, 2, dev)
    build.check(src, "src", torch.int32, 3, dev)
    p, w = words.shape
    if src.shape[0] != p:
        raise ValueError(f"src has {src.shape[0]} ranks, words {p}")
    bounds.tally("frontier_gather_full", lambda: bounds.gather_full_bytes(src))
    if build.route(words) == "plain":
        return ref.frontier_gather_full(words, src)
    out = torch.empty(src.shape, dtype=torch.bool, device=dev)
    if out.numel():
        build.launch("frontier_gather_full", dev, words.data_ptr(),
                     src.data_ptr(), out.data_ptr(), p, w, src[0].numel(),
                     int(plan_gather_full(ids_sorted) == "walk"),
                     build.vectorizable(src.shape[2], src, out))
    return out


def frontier_gather(words: torch.Tensor, block_ws: torch.Tensor,
                    src_local: torch.Tensor, *, ww: int) -> torch.Tensor:
    """Windowed bit-gather: ``words`` int32[P, W] (W % ww == 0),
    ``block_ws`` int32[P, NB] (window index of each block, in units of
    ``ww`` words), ``src_local`` int32[P, NB, EB] (bit offset inside the
    window) -> bool[P, NB, EB]."""
    dev = words.device
    build.check(words, "words", torch.int32, 2, dev)
    build.check(block_ws, "block_ws", torch.int32, 2, dev)
    build.check(src_local, "src_local", torch.int32, 3, dev)
    p, w = words.shape
    nb, eb = src_local.shape[1:]
    if w % ww:
        raise ValueError(f"bitmap of {w} words is not a multiple of ww={ww}")
    if tuple(block_ws.shape) != (p, nb) or src_local.shape[0] != p:
        raise ValueError(f"block_ws {tuple(block_ws.shape)} and src_local "
                         f"{tuple(src_local.shape)} disagree with P={p}")
    if not 0 < ww <= MAX_WINDOW_WORDS:
        raise ValueError(f"window of {ww} words is over {MAX_WINDOW_WORDS}")
    bounds.tally("frontier_gather", lambda: bounds.gather_window_bytes(block_ws, src_local, ww))
    if build.route(words) == "plain":
        return ref.frontier_gather(words, block_ws, src_local, ww)
    out = torch.empty(src_local.shape, dtype=torch.bool, device=dev)
    if out.numel():
        build.launch("frontier_gather", dev, words.data_ptr(),
                     block_ws.data_ptr(), src_local.data_ptr(), out.data_ptr(),
                     p, w, nb, eb, ww, build.vectorizable(eb, src_local, out))
    return out
