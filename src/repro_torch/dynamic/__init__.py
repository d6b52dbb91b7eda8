"""Streaming graph mutations with incremental butterfly repair (DESIGN.md §16).

The port of ``repro.dynamic``.  The partitioned CSR becomes cheaply
mutable without losing the bitmap / butterfly machinery:

* :mod:`repro_torch.dynamic.delta`      — partition-aligned delta overlay
  on :class:`repro_torch.graph.csr.Graph` (per-shard insert/delete buffers
  with the ETL's min-dedup/symmetrize/weight semantics) + compaction into
  a fresh CSR,
* :mod:`repro_torch.dynamic.repair`     — incremental BFS/SSSP repair
  seeded at the endpoints of changed edges (monotone min-relaxation under
  the MIN monoid; deletions taint affected subtrees and re-relax them),
  host-driven loops over the simulated ranks,
* :mod:`repro_torch.dynamic.versioning` — ``(epoch, delta_seq)`` graph
  versions and the partial-invalidation protocol that lets untouched
  cached rows survive a mutation batch.
"""

from repro_torch.dynamic.delta import (  # noqa: F401
    AppliedUpdate,
    DeltaOverlay,
    EdgeBatch,
    apply_update_to_partition,
    read_update_stream,
    write_update_stream,
)
from repro_torch.dynamic.repair import (  # noqa: F401
    build_repair_fn,
    build_repair_wave_fn,
    compiled_repair_fn,
    compiled_repair_wave_fn,
    repair_row,
    repair_rows,
    repair_seeds,
)
from repro_torch.dynamic.versioning import (  # noqa: F401
    GraphVersion,
    InvalidationStats,
    migrate_cache,
    partitions_equivalent,
)
