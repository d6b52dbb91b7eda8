"""The plain reference, in plain torch, from the generated edge tuples alone.

It imports nothing of the port and takes nothing the port made: its own
symmetric CSR, its own level-synchronous BFS and its own connected
components, built on whatever device holds the tuples.  Graph500 counts a
search's work as the input tuples inside the searched component,
self-loops and repeated tuples included (:meth:`Reference.tuples_in`).
"""

from __future__ import annotations

import torch

#: The depth of an unreached vertex (the port marks it the same way).
INF = 2**31 - 1


def components(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n]: a component label for every vertex, the same for two
    vertices exactly when the tuples join them.  Each round hooks the
    larger root of every split tuple onto the smaller, then points every
    vertex at its root; parents only fall, so the rounds end."""
    parent = torch.arange(n, device=src.device)
    while True:
        pu, pv = parent[src], parent[dst]
        split = pu != pv
        if not bool(split.any()):
            return parent
        hi, lo = torch.maximum(pu, pv)[split], torch.minimum(pu, pv)[split]
        parent.scatter_reduce_(0, hi, lo, reduce="amin")
        while True:
            grand = parent[parent]
            if torch.equal(grand, parent):
                break
            parent = grand


class Reference:
    """BFS depths and Graph500's edge count over ``n`` vertices and the
    int64 tuples ``src``, ``dst`` (self-loops and repeats allowed)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        self.n = n
        keep = src != dst
        tails = torch.cat([src[keep], dst[keep]])
        heads = torch.cat([dst[keep], src[keep]])
        tails, order = torch.sort(tails)
        self.heads = heads[order]
        self.offsets = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
        self.offsets[1:] = torch.cumsum(torch.bincount(tails, minlength=n), 0)
        del tails, heads, order
        self.labels = components(src, dst, n)
        self.tuples_by_label = torch.bincount(self.labels[src], minlength=n)

    def tuples_in(self, roots) -> torch.Tensor:
        """int64 per root: the generated tuples inside its component."""
        roots = torch.as_tensor(roots, dtype=torch.int64, device=self.labels.device)
        return self.tuples_by_label[self.labels[roots]]

    def depths(self, root: int) -> torch.Tensor:
        """int32[n]: hops from ``root``, ``INF`` where unreached; one level
        at a time, each expanding the whole frontier's rows of the CSR."""
        dev = self.heads.device
        depth = torch.full((self.n,), INF, dtype=torch.int32, device=dev)
        depth[root] = 0
        frontier = torch.tensor([root], dtype=torch.int64, device=dev)
        level = 0
        while frontier.numel():
            starts = self.offsets[frontier]
            lens = self.offsets[frontier + 1] - starts
            total = int(lens.sum())
            if total == 0:
                break
            first = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens), lens)
            nbr = self.heads[first + torch.arange(total, device=dev)]
            nbr = nbr[depth[nbr] == INF]
            depth[nbr] = level + 1
            level += 1
            frontier = torch.nonzero(depth == level).flatten()
        return depth
