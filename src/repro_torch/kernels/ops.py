"""BFS-facing expansion ops over the kernel layouts of :mod:`.blocks`.

The counterparts of ``repro.kernels.ops.expand_push_pallas`` and
``expand_pull_pallas``, wired the same way, over the whole ``[P, ...]``
rank stack.  Between the kernels, the permutation from gather order to
scatter order is a plain ``torch.gather``.  Each gather call runs in a
``kernels.gather`` span, the permutation in ``kernels.permute`` and the
scatter in ``kernels.scatter`` (:mod:`repro_torch.core.tracing`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.tracing import span
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_full
from repro_torch.kernels.frontier_scatter import frontier_scatter


def _pad_words(words: torch.Tensor, words_pad: int) -> torch.Tensor:
    w = words.shape[-1]
    if w == words_pad:
        return words
    if w > words_pad:
        return words[:, :words_pad].contiguous()
    return F.pad(words, (0, words_pad - w))


def _permute(flat_bits: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``flat_bits[P, N]`` taken at ``perm[P, NB, EB]`` (int64)."""
    p = perm.shape[0]
    with span("kernels.permute"):
        return torch.gather(flat_bits, 1, perm.reshape(p, -1)).reshape(perm.shape)


def _scatter(active, arrays, meta, prefix, n_words):
    with span("kernels.scatter"):
        out = frontier_scatter(
            active, arrays[prefix + "_win"], arrays[prefix + "_dst"],
            n_windows=meta["scatter_windows"], ww=meta["scatter_ww"],
        )
    return out[:, :n_words]


def expand_push(frontier: torch.Tensor, arrays: Dict, meta: Dict,
                n_words: int) -> torch.Tensor:
    """Top-down: gather (full or windowed) -> permute -> scatter."""
    words = _pad_words(frontier, meta["gather_words_pad"])
    with span("kernels.gather"):
        if meta["gather_full"]:
            active = frontier_gather_full(words, arrays["tdg_src"],
                                          ids_sorted="tdg_src" in meta["sorted_planes"])
        else:
            active = frontier_gather(words, arrays["tdg_ws"], arrays["tdg_src"],
                                     ww=meta["gather_ww"])
    p = active.shape[0]
    blocked = _permute(active.reshape(p, -1), arrays["tds_perm"])
    return _scatter(blocked, arrays, meta, "tds", n_words)


def expand_pull(frontier: torch.Tensor, visited: torch.Tensor, arrays: Dict,
                meta: Dict, n_words: int) -> torch.Tensor:
    """Bottom-up: parent probe (full gather over unsorted ``in_src``) AND
    NOT the visited mask (gather over sorted ``in_dst``) -> permute ->
    scatter."""
    fwords = _pad_words(frontier, meta["gather_words_pad"])
    with span("kernels.gather"):
        parent = frontier_gather_full(fwords, arrays["in_src_blocks"],
                                      ids_sorted="in_src_blocks" in meta["sorted_planes"])
    vwords = _pad_words(visited, meta["pull_gather_words_pad"])
    with span("kernels.gather"):
        if meta["pull_gather_full"]:
            vis = frontier_gather_full(vwords, arrays["pug_dst"],
                                       ids_sorted="pug_dst" in meta["sorted_planes"])
        else:
            vis = frontier_gather(vwords, arrays["pug_ws"], arrays["pug_dst"],
                                  ww=meta["pull_gather_ww"])
    # both are in-edge flat order; lengths may differ by block padding, and
    # every real edge index < count <= the shorter length.
    p = parent.shape[0]
    m = min(parent[0].numel(), vis[0].numel())
    found = parent.reshape(p, -1)[:, :m] & ~vis.reshape(p, -1)[:, :m]
    blocked = _permute(found, arrays["pus_perm"])
    return _scatter(blocked, arrays, meta, "pus", n_words)
