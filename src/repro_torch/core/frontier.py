"""Packed-bitmap frontier words on torch tensors (DESIGN.md Sec. 3).

The port of ``repro.core.frontier``.  Two packings share these
primitives:

* **vertex-packed** (single-source BFS): bit ``v & 31`` of word ``v >> 5``
  is vertex ``v``;
* **lane-packed** (multi-source BFS): row ``v`` of ``[n, B/32]`` is vertex
  ``v`` and bit ``b & 31`` of lane-word ``b >> 5`` is search lane ``b``.

Every function takes optional leading dimensions, so one call serves a
``[P, W]`` stack of per-rank bitmaps; the sparse wire format's
compactions (:func:`compact_changed`) give each rank its own pairs.

Words are stored as ``int32`` and hold the reference's ``uint32`` bit
patterns (compare through ``.view(torch.uint32)``): on the CPU, torch
lacks ``>>``, ``~``, ``nonzero`` and scatter reductions for ``uint32``.
``>>`` on ``int32`` is arithmetic, so every shift is masked before its
bits are used, and no word is compared or reduced as a signed number — the
reference's "scatter-max == scatter-OR" shortcut breaks on a word whose
bit 31 is set, so it has no counterpart here.

:func:`pack` and :func:`unpack` copy a small table of constants from the
host to the words' device on each call.  On a card PyTorch ends that copy
by synchronising the stream, so the host waits there for the work queued
before it: the copy runs in a ``frontier.upload`` span
(:mod:`repro_torch.core.tracing`), where the host's waits are counted.
"""

from __future__ import annotations

import torch

from repro_torch.core import monoid
from repro_torch.core.tracing import span
from repro_torch.graph.csr import WORD_BITS

__all__ = ["WORD_BITS", "pack", "unpack", "lane_pack", "lane_unpack", "get_bits",
           "set_bit", "popcount", "popcount_lanes", "count_nonzero",
           "compact_words", "changed_count", "compact_changed", "scatter_combine",
           "expand_words", "scatter_or_words", "scatter_or_lanes", "scatter_or"]
_BYTE_SHIFTS = (0, 1, 2, 3, 4, 5, 6, 7)


def _upload(values, device) -> torch.Tensor:
    """uint8 ``values`` copied to ``device`` (a wait on a card)."""
    with span("frontier.upload"):
        return torch.tensor(values, dtype=torch.uint8, device=device)


def _byte_weights(device) -> torch.Tensor:
    return _upload([1 << s for s in _BYTE_SHIFTS], device)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """bool (or 0/1 uint8) [..., n] -> int32[..., n/32] (n a multiple of 32).

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
    shifts = _upload(_BYTE_SHIFTS, words.device)
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


def popcount(words: torch.Tensor, dim=None) -> torch.Tensor:
    """Set bits (int64): in total, or summed over ``dim`` only (``dim=-1``
    counts each rank of a ``[P, W]`` stack apart).

    SWAR bit count on each word widened to int64 and masked to its 32 bits,
    so no step overflows or sign-extends."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum() if dim is None else x.sum(dim)


def count_nonzero(words: torch.Tensor) -> torch.Tensor:
    """Nonzero words of each row of ``words[..., W]`` (int32[...])."""
    return (words != 0).sum(-1, dtype=torch.int32)


def lane_pack(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., k*32] -> int32[..., k]: pack the LAST axis, bit ``b & 31``
    of word ``b >> 5`` <- position ``b`` (the lane-mask wire layout; the
    same packing as :func:`pack`)."""
    return pack(bits)


def lane_unpack(words: torch.Tensor) -> torch.Tensor:
    """int32[..., k] -> bool[..., k*32]: inverse of :func:`lane_pack`."""
    return unpack(words)


def popcount_lanes(words: torch.Tensor) -> torch.Tensor:
    """Per-lane set bits of a lane-packed buffer: ``int32[..., k] ->
    int32[k*32]``, entry ``b`` counting over every leading position how
    often lane bit ``b`` is set (per-search frontier sizes of a wave)."""
    bits = lane_unpack(words)
    return bits.reshape(-1, bits.shape[-1]).sum(0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Sparse wire format: fixed-capacity (word_index, word) pairs per rank
# ---------------------------------------------------------------------------


def changed_count(words: torch.Tensor, ref) -> torch.Tensor:
    """Words of each row of ``words[..., W]`` that differ from ``ref``
    (a ``[W]`` buffer shared by every rank, or one per row): int32[...]."""
    return (words != ref).sum(-1, dtype=torch.int32)


def compact_changed(words: torch.Tensor, ref, capacity: int, m: "monoid.Monoid"):
    """The first ``capacity`` words of each row of ``words[..., W]`` that
    differ from ``ref``, in ascending index order, padded with
    ``(0, identity of m)`` pairs: the wire format of the sparse exchange.

    Returns ``(idx int32[..., capacity], vals [..., capacity], count
    int32[...], overflow bool[...])``.  When ``count > capacity`` the tail
    words are truncated; callers consult ``overflow`` (or pre-check the
    count) before trusting the pairs.

    Fixed shape on the device, with no host read: a cumulative sum of the
    changed mask gives each changed word its slot, and words whose slot is
    ``>= capacity`` go to a spare slot that is dropped."""
    diff = words != ref
    count = diff.sum(-1, dtype=torch.int32)
    slot = torch.cumsum(diff, -1, dtype=torch.int32) - 1
    slot = torch.where(diff & (slot < capacity), slot, capacity).long()
    lead = words.shape[:-1]
    pos = torch.arange(words.shape[-1], dtype=torch.int32, device=words.device)
    idx = torch.zeros((*lead, capacity + 1), dtype=torch.int32, device=words.device)
    idx = idx.scatter(-1, slot, pos.expand(words.shape))[..., :capacity]
    real = torch.arange(capacity, device=words.device) < count[..., None]
    vals = torch.where(real, words.gather(-1, idx.long()), m.identity_like(words))
    return idx, vals, count, count > capacity


def compact_words(words: torch.Tensor, capacity: int):
    """Fixed-capacity sparse view of a bitmap: the first ``capacity``
    nonzero ``(word_index, word)`` pairs of each row, padded with
    ``(0, 0)``; the OR-monoid case of :func:`compact_changed` (reference
    all-zeros).  Returns ``(idx, vals, count, overflow)``."""
    return compact_changed(words, 0, capacity, monoid.OR_U32)


def scatter_combine(words: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    m: "monoid.Monoid") -> torch.Tensor:
    """The receive side of the sparse exchange: combine the compact
    ``(idx, vals)`` pairs of each row into ``words[..., W]`` over monoid
    ``m``; identity pads are no-ops (see :meth:`Monoid.scatter_into` for
    duplicates)."""
    expanded = m.scatter_into(m.full(words.shape, words.dtype, words.device), idx, vals)
    return m.combine(words, expanded)


def expand_words(n_words: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compact_words`: OR the pairs of each row into an
    empty ``int32[..., n_words]`` bitmap (a true OR: a word with bit 31 set
    at index 0 survives the ``(0, 0)`` pads)."""
    zeros = torch.zeros((*idx.shape[:-1], n_words), dtype=torch.int32,
                        device=idx.device)
    return monoid.OR_U32.scatter_into(zeros, idx, vals)


def scatter_or_words(words: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """OR compact ``(idx, vals)`` pairs into an existing bitmap."""
    return words | expand_words(words.shape[-1], idx, vals)


def scatter_or_lanes(n_rows: int, idx: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Lane-packed buffer ``int32[..., n_rows, k]`` with lane mask
    ``masks[..., i, :]`` OR-ed into row ``idx[..., i]``; duplicate rows OR
    together and rows outside ``[0, n_rows)`` are dropped.

    Plain path: every mask unpacked to one byte per lane and reduced into
    its row with ``index_reduce_`` (``amax`` of 0/1 bytes is their OR,
    whatever the order), then packed; a row of a dropped index goes to a
    spare row.  The unpacked bytes take ``32 * k`` bytes per slot, and
    :func:`pack` takes the 0/1 bytes as they are."""
    lead = idx.shape[:-1]
    k = masks.shape[-1]
    rows = idx.reshape(-1, idx.shape[-1]).long()
    rows = torch.where((rows >= 0) & (rows < n_rows), rows, n_rows)
    base = torch.arange(rows.shape[0], device=idx.device)[:, None] * (n_rows + 1)
    dense = torch.zeros((rows.shape[0] * (n_rows + 1), k * WORD_BITS),
                        dtype=torch.uint8, device=idx.device)
    bits = lane_unpack(masks).reshape(-1, k * WORD_BITS).to(torch.uint8)
    dense.index_reduce_(0, (rows + base).reshape(-1), bits, "amax")
    dense = dense.view(rows.shape[0], n_rows + 1, k * WORD_BITS)[:, :n_rows]
    return lane_pack(dense).reshape(*lead, n_rows, k)


def scatter_or(n_words: int, idx: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Bitmap ``int32[..., n_words]`` with bit ``idx[..., i]`` set where
    ``active[..., i]``; indices outside the bitmap are dropped.

    Plain path: scatter-max the 0/1 activity into a dense byte vector per
    row, then pack.  The CUDA kernel ``kernels/frontier_scatter`` replaces
    this on the card.  A bitmap of more than 64 bits per index (the
    triangle count's adjacency) takes :func:`_scatter_or_words` instead,
    which never holds a byte per bit."""
    n_bits = n_words * WORD_BITS
    if n_bits > 64 * idx.shape[-1]:
        return _scatter_or_words(n_words, idx, active)
    lead = idx.shape[:-1]
    rows = idx.reshape(-1, idx.shape[-1]).long()
    act = active.reshape(rows.shape) & (rows >= 0) & (rows < n_bits)
    offset = torch.arange(rows.shape[0], device=idx.device)[:, None] * n_bits
    flat = (rows.clamp(0, n_bits - 1) + offset).reshape(-1)
    dense = torch.zeros(rows.shape[0] * n_bits, dtype=torch.uint8,
                        device=idx.device)
    dense.scatter_reduce_(0, flat, act.reshape(-1).to(torch.uint8), "amax")
    return pack(dense.view(rows.shape[0], n_bits)).reshape(*lead, n_words)


def _scatter_or_words(n_words: int, idx: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_or` word by word: the active in-range bits of each
    row, deduplicated, each added as ``1 << (i & 31)`` into its int64 word
    (distinct bits of a word add up to their OR), then cut to 32 bits."""
    n_bits = n_words * WORD_BITS
    lead = idx.shape[:-1]
    rows = idx.reshape(-1, idx.shape[-1]).long()
    act = active.reshape(rows.shape) & (rows >= 0) & (rows < n_bits)
    offset = torch.arange(rows.shape[0], device=idx.device)[:, None] * n_bits
    bits = torch.unique((rows + offset)[act])
    words = torch.zeros(rows.shape[0] * n_words, dtype=torch.int64, device=idx.device)
    words.scatter_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return (words & 0xFFFFFFFF).to(torch.int32).reshape(*lead, n_words)
