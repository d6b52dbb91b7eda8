"""Graph analytics on the butterfly sync (DESIGN.md §13).

* :mod:`repro_torch.analytics.msbfs` — bit-parallel multi-source BFS: B
  searches per wave, one bit-lane per root, phase 2 reuses the frontier
  syncs unchanged.

The reference's ``measures`` and ``engine`` (closeness, reachability,
components, the batched query engine) are not ported yet.
"""

from repro_torch.analytics.msbfs import build_msbfs_fn, multi_source_bfs  # noqa: F401
