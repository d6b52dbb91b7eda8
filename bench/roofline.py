"""The least bytes a call of each of the port's four kernels must move, and the
table of peaks: the yardstick of the ``<kernel>_roofline`` metrics.

A frozen copy of the byte model of ``repro_torch/kernels/bounds.py``, so
that the yardstick does not move with the program: every input read once
and the output written once, but a gather reads only the distinct bitmap
words its indices reach, and the scatter only the 32-byte sectors of its
offsets that hold an active slot.  The functions take a call's own
arguments, as the port's kernel entry points receive them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

#: The published peaks of each card, by ``torch.cuda.get_device_name``
#: (NVIDIA's data sheet, H100 SXM5: 80 GB of HBM3 at 3.35 TB/s).
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}

SECTOR_BYTES = 32  # the least the device memory delivers


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct_word_bytes(word_idx: torch.Tensor) -> int:
    """Bytes of the distinct bitmap words ``word_idx[P, ...]`` reads, each
    rank's words counted apart."""
    p = word_idx.shape[0]
    rank = torch.arange(p, device=word_idx.device).view(p, *[1] * (word_idx.dim() - 1))
    keys = rank * (int(word_idx.max()) + 1) + word_idx.long()
    return 4 * torch.unique(keys).numel()


def gather_full(words, src, **_) -> int:
    """``frontier_gather_full(words, src)``: the distinct words, the ids,
    the bool output."""
    return distinct_word_bytes(src >> 5) + nbytes(src) + src.numel()


def gather_window(words, block_ws, src_local, *, ww, **_) -> int:
    """``frontier_gather(words, block_ws, src_local, ww=)``: the distinct
    words of the blocks' windows, the window indices, the offsets, the
    bool output."""
    idx = (block_ws.long() * ww)[..., None] + torch.arange(ww, device=block_ws.device)
    return distinct_word_bytes(idx) + nbytes(block_ws, src_local) + src_local.numel()


def scatter(active, block_win, dst_local, *, n_windows, ww, **_) -> int:
    """``frontier_scatter(active, block_win, dst_local, n_windows=, ww=)``:
    ``active``, ``block_win`` and the int32 output whole, and the sectors
    of ``dst_local`` that hold an active slot."""
    per = SECTOR_BYTES // dst_local.element_size()
    flat = active.reshape(-1)
    flat = F.pad(flat, (0, -flat.numel() % per))
    sectors = int(flat.view(-1, per).any(dim=1).sum())
    out_words = active.shape[0] * n_windows * ww
    return nbytes(active, block_win) + 4 * out_words + SECTOR_BYTES * sectors


def or_reduce(stack) -> int:
    """``bitmap_or_reduce(stack)``: the ``[B, K, W]`` stack read, ``[B, W]``
    written."""
    return nbytes(stack) // stack.shape[1] * (stack.shape[1] + 1)


#: Each kernel entry point's byte function; the gathers' planes are static,
#: so their counts are kept by the plane's address.
LEAST_BYTES = {"frontier_gather_full": gather_full, "frontier_gather": gather_window,
               "frontier_scatter": scatter, "bitmap_or_reduce": or_reduce}
STATIC_PLANE = {"frontier_gather_full": 1, "frontier_gather": 2}


class Tally:
    """Least bytes and calls of each kernel, over the calls it is shown."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self._planes: Dict[tuple, int] = {}

    def add(self, name: str, args, kwargs) -> None:
        pos = STATIC_PLANE.get(name)
        if pos is not None:
            plane = args[pos]
            key = (name, plane.data_ptr(), tuple(plane.shape), kwargs.get("ww"))
            if key not in self._planes:
                self._planes[key] = LEAST_BYTES[name](*args, **kwargs)
            b = self._planes[key]
        else:
            b = LEAST_BYTES[name](*args, **kwargs)
        self.bytes[name] = self.bytes.get(name, 0) + int(b)
        self.calls[name] = self.calls.get(name, 0) + 1


def share(run, kernel: str) -> Optional[float]:
    """``kernel``'s least bytes over the traced segment, moved at the card's
    published HBM rate, as a % of its device time there; nothing where the
    kernel did not run, the card has no peak in :data:`PEAKS`, or the calls
    counted do not match the calls traced."""
    t = run.traced
    peak = PEAKS.get(run.device_kind)
    if t is None or peak is None or not t.kernel_s.get(kernel):
        return None
    if t.calls.get(kernel) != t.kernel_calls.get(kernel):
        return None
    return 100.0 * t.kernel_bytes[kernel] / peak["hbm_bytes_per_s"] / t.kernel_s[kernel]
