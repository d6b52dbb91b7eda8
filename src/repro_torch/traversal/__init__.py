"""Weighted traversals on the monoid-generalized butterfly.

The port of ``repro.traversal``:

* :mod:`repro_torch.traversal.sssp` — single-source shortest paths:
  level-synchronous relaxation with delta-stepping-style bucket frontiers,
  distances synchronized by a ``MIN_U32`` reduce (dense, sparse
  changed-word, or density-adaptive wire format).
* :mod:`repro_torch.traversal.bc` — Brandes betweenness centrality riding
  the MS-BFS bit-lanes: the forward wave counts shortest paths with a dense
  ADD reduce on ``sigma``; the backward pass replays levels in reverse
  accumulating dependencies with the same exchange.
"""

from repro_torch.traversal.sssp import (  # noqa: F401
    SSSPConfig,
    UNREACHED,
    build_sssp_fn,
    distributed_sssp,
    sssp_reference,
)
from repro_torch.traversal.bc import (  # noqa: F401
    bc_reference,
    betweenness_centrality,
    build_bc_fn,
)
