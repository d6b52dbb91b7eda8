"""The GAP Benchmark Suite's uniform-random graph (``urand``), a frozen copy
in plain torch.

GAP's ``MakeUniformEL`` draws ``degree * n`` tuples whose two ends are
uniform over the ``n = 2**scale`` vertices; its builder then symmetrizes
them and drops self-loops and repeats, as the port's ETL does.
"""

from __future__ import annotations

import torch


def edges(config: dict, gen: torch.Generator, device: torch.device):
    """``(n, src, dst)``: ``n = 2**scale`` vertices and ``degree * n``
    uniform int64 tuples on ``device``, drawn from ``gen``."""
    n = 1 << int(config["scale"])
    m = int(config["degree"]) * n
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    return n, src, dst
