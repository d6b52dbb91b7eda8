"""Packed-bitmap frontier words on torch tensors (DESIGN.md Sec. 3).

The port of ``repro.core.frontier`` for vertex-packed bitmaps: bit
``v & 31`` of word ``v >> 5`` is vertex ``v``.  Every function takes
optional leading dimensions, so one call serves a ``[P, W]`` stack of
per-rank bitmaps.

Words are stored as ``int32`` and hold the reference's ``uint32`` bit
patterns (compare through ``.view(torch.uint32)``): on the CPU, torch
lacks ``>>``, ``~``, ``nonzero`` and scatter reductions for ``uint32``.
``>>`` on ``int32`` is arithmetic, so every shift is masked before its
bits are used, and no word is compared or reduced as a signed number — the
reference's "scatter-max == scatter-OR" shortcut breaks on a word whose
bit 31 is set, so it has no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.graph.csr import WORD_BITS

__all__ = ["WORD_BITS", "pack", "unpack", "get_bits", "set_bit", "popcount",
           "scatter_or"]
_BYTE_SHIFTS = (0, 1, 2, 3, 4, 5, 6, 7)


def _byte_weights(device) -> torch.Tensor:
    return torch.tensor([1 << s for s in _BYTE_SHIFTS], dtype=torch.uint8,
                        device=device)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., n] -> int32[..., n/32] (n must be a multiple of 32).

    Packs eight bits to a byte and views four little-endian bytes as one
    word, so bit ``b`` of byte ``j`` is bit ``8 j + b`` of the word."""
    n = bits.shape[-1]
    if n % WORD_BITS:
        raise ValueError(f"bit count {n} is not a multiple of {WORD_BITS}")
    octets = bits.reshape(*bits.shape[:-1], n // 8, 8).to(torch.uint8)
    packed = (octets * _byte_weights(bits.device)).sum(-1, dtype=torch.uint8)
    return packed.contiguous().view(torch.int32)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """int32[..., w] -> bool[..., w*32]: inverse of :func:`pack`."""
    octets = words.contiguous().view(torch.uint8)
    shifts = torch.tensor(_BYTE_SHIFTS, dtype=torch.uint8, device=words.device)
    bits = (octets.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).bool()


def get_bits(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bits at vertex ids ``idx``: ``words[..., W]`` and ``idx[..., E]``
    share their leading dimensions; returns bool[..., E]."""
    idx = idx.long()
    w = torch.gather(words, -1, idx >> 5)
    return ((w >> (idx & 31)) & 1).bool()


def set_bit(words: torch.Tensor, idx: int) -> torch.Tensor:
    """Copy of ``words[..., W]`` with bit ``idx`` set in every row."""
    idx = int(idx)
    if not 0 <= idx < words.shape[-1] * WORD_BITS:
        raise IndexError(f"bit {idx} outside a {words.shape[-1]}-word bitmap")
    mask = 1 << (idx & 31)
    if mask >= 1 << 31:  # the int32 pattern of 0x80000000
        mask -= 1 << 32
    out = words.clone()
    out[..., idx >> 5] |= mask
    return out


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits (int64).

    SWAR bit count on each word widened to int64 and masked to its 32 bits,
    so no step overflows or sign-extends."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum()


def scatter_or(n_words: int, idx: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Bitmap ``int32[..., n_words]`` with bit ``idx[..., i]`` set where
    ``active[..., i]``; indices outside the bitmap are dropped.

    Plain path: scatter-max the 0/1 activity into a dense byte vector per
    row, then pack.  The CUDA kernel ``kernels/frontier_scatter`` replaces
    this on the card."""
    n_bits = n_words * WORD_BITS
    lead = idx.shape[:-1]
    rows = idx.reshape(-1, idx.shape[-1]).long()
    act = active.reshape(rows.shape) & (rows >= 0) & (rows < n_bits)
    offset = torch.arange(rows.shape[0], device=idx.device)[:, None] * n_bits
    flat = (rows.clamp(0, n_bits - 1) + offset).reshape(-1)
    dense = torch.zeros(rows.shape[0] * n_bits, dtype=torch.uint8,
                        device=idx.device)
    dense.scatter_reduce_(0, flat, act.reshape(-1).to(torch.uint8), "amax")
    return pack(dense.view(rows.shape[0], n_bits)).reshape(*lead, n_words)
