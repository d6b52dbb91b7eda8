"""The Graph500 Kronecker generator, a frozen copy in plain torch.

It follows the specification's reference code (``kronecker_generator.m``):
for each of ``scale`` bits, one draw picks the row half with probability
``C + D`` and a second the column half, conditioned on the first; then the
vertex labels are permuted and so is the order of the tuples.  Self-loops
and repeated tuples are kept: they are the generator's output, and
Graph500 counts them.
"""

from __future__ import annotations

import torch


def edges(config: dict, gen: torch.Generator, device: torch.device):
    """``(n, src, dst)``: ``n = 2**scale`` vertices and ``edge_factor * n``
    int64 tuples on ``device``, drawn from ``gen``."""
    scale, edge_factor = int(config["scale"]), int(config["edge_factor"])
    a, b, c = float(config["A"]), float(config["B"]), float(config["C"])
    n = 1 << scale
    m = edge_factor * n
    ab = a + b
    # the column draw's threshold after a row bit of 0 (a_norm) or 1 (c_norm)
    norm = torch.tensor([a / ab, c / (1.0 - ab)], dtype=torch.float64, device=device)
    ij = torch.zeros((2, m), dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device, dtype=torch.float64) > ab
        jj = (torch.rand(m, generator=gen, device=device, dtype=torch.float64)
              > norm[ii.long()])
        ij[0] |= ii.long() << bit
        ij[1] |= jj.long() << bit
    ij = torch.randperm(n, generator=gen, device=device)[ij]
    ij = ij[:, torch.randperm(m, generator=gen, device=device)]
    return n, ij[0].contiguous(), ij[1].contiguous()
