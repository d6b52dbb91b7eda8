"""Graph analytics on the butterfly sync (DESIGN.md §13).

* :mod:`repro_torch.analytics.msbfs` — bit-parallel multi-source BFS: B
  searches per wave, one bit-lane per root, phase 2 reuses the frontier
  syncs unchanged.
* :mod:`repro_torch.analytics.measures` — closeness centrality,
  reachability counts, connected components, all driven by MS-BFS waves.
* :mod:`repro_torch.analytics.engine` — batched query engine: packs root
  streams into fixed-width waves against a cached program; also serves the
  §14 weighted traversals (``sssp``, ``betweenness``) and the §19 vertex
  programs from the same placed arrays and program cache.
"""

from repro_torch.analytics.msbfs import build_msbfs_fn, multi_source_bfs  # noqa: F401
from repro_torch.analytics.measures import (  # noqa: F401
    closeness_centrality,
    connected_components,
    reachability_counts,
)
from repro_torch.analytics.engine import BFSQueryEngine  # noqa: F401
