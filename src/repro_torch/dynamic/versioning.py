"""Graph versioning + partial cache invalidation (DESIGN.md §16).

A copy of ``repro.dynamic.versioning`` (NumPy only).  :func:`migrate_cache`
is duck-typed on the cache (``enabled``, ``items_snapshot``, ``put``).

The §15 epoch — one integer, bumped on every graph change, making every
cached result structurally unreachable — becomes a two-level
:class:`GraphVersion` ``(epoch, delta_seq)``:

* ``epoch`` still bumps on FULL swaps (new partition object, possibly new
  shapes: compaction, reload, resize) — everything cold-starts, as before;
* ``delta_seq`` bumps on in-place mutation batches — and instead of
  dropping the whole cache, :func:`migrate_cache` re-keys each cached row
  individually: rows the repair machinery PROVES unchanged (empty seeds,
  zero device work) or repairs to their new exact value carry over to the
  new version; only rows it cannot vouch for (budget exhausted,
  non-liftable config, Brandes dependency vectors whose path COUNTS may
  shift even when distances don't) cold-start.

Ordering is lexicographic, so the §15 cache's ``drop_stale`` works
unchanged on versioned keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class GraphVersion:
    """``(epoch, delta_seq)``: which graph, and how many mutation batches
    deep into it.  Hashable (cache-key component) and totally ordered
    (``drop_stale`` compatible)."""

    epoch: int = 0
    delta_seq: int = 0

    def bump_epoch(self) -> "GraphVersion":
        """A full swap: new epoch, delta sequence resets."""
        return GraphVersion(self.epoch + 1, 0)

    def bump_delta(self) -> "GraphVersion":
        """An in-place mutation batch on the same partition."""
        return GraphVersion(self.epoch, self.delta_seq + 1)

    def json(self) -> List[int]:
        return [self.epoch, self.delta_seq]

    def __str__(self) -> str:
        return f"{self.epoch}.{self.delta_seq}"


def partitions_equivalent(a, b) -> bool:
    """True iff two partitions describe the SAME graph cut the same way:
    identical boundaries and identical per-shard edge multisets (weights
    included, duplicate weight-lowering slots collapsed to their min).
    The identity-swap fast path: swapping in an equivalent partition must
    not cold-start the cache (§16)."""
    from repro_torch.dynamic.delta import partition_edge_multiset

    if a is b:
        return True
    if (a.p, a.n, a.weighted) != (b.p, b.n, b.weighted):
        return False
    if not (
        np.array_equal(a.v_start, b.v_start)
        and np.array_equal(a.v_count, b.v_count)
    ):
        return False
    ka, wa = partition_edge_multiset(a)
    kb, wb = partition_edge_multiset(b)
    if not np.array_equal(ka, kb):
        return False
    return wa is None or np.array_equal(wa, wb)


@dataclasses.dataclass
class InvalidationStats:
    """Outcome of one :func:`migrate_cache` pass."""

    rows_before: int = 0
    kept: int = 0  # proven unchanged (host seeds empty / device touched 0)
    repaired: int = 0  # device-repaired to the new exact value
    dropped: int = 0  # no vouching path: cold-starts under the new version
    touched_vertices: int = 0
    repair_iters: int = 0

    @property
    def survival_rate(self) -> float:
        if not self.rows_before:
            return 1.0
        return (self.kept + self.repaired) / self.rows_before


# a repairer maps cached rows to per-row (new_row, touched, iters)
# outcomes — None for a row it declines (budget exhausted / unrepairable):
# that row then drops.  Batched so lane-packed repair can share waves.
Repairer = Callable[
    [List[np.ndarray]], List[Optional[Tuple[np.ndarray, int, int]]]
]


def migrate_cache(
    cache,
    old_version: GraphVersion,
    new_version: GraphVersion,
    *,
    repairers: Dict[str, Repairer],
    derive_closeness: Optional[Callable[[np.ndarray], float]] = None,
) -> InvalidationStats:
    """Carry cached rows across a mutation batch (§16 partial invalidation).

    Walks every entry keyed under ``old_version`` and re-keys it under
    ``new_version`` when the algo's batch ``repairer`` vouches for it —
    ``touched == 0`` keeps the original value, otherwise the repaired row
    replaces it.  Each algo's rows go to its repairer in ONE batch, so
    suspects share lane-packed repair waves.  ``closeness`` entries ride
    their root's BFS row: kept when it was proven unchanged, re-derived
    (``derive_closeness``) when it was repaired, dropped otherwise.
    ``bc`` entries always drop: an edge change can shift Brandes path
    counts without moving any distance, so distances cannot vouch for
    them.  Old-version keys are left for ``drop_stale`` (they are already
    structurally unreachable)."""
    stats = InvalidationStats()
    if not getattr(cache, "enabled", False):
        return stats
    entries = [
        (key, value)
        for key, value in cache.items_snapshot()
        if key[0] == old_version
    ]
    stats.rows_before = len(entries)
    # root -> True iff the root's distance row was proven unchanged;
    # repaired rows land here too (False) so closeness can re-derive
    bfs_rows: Dict[int, Tuple[bool, np.ndarray]] = {}

    deferred = []
    groups: Dict[str, list] = {}
    for key, value in entries:
        algo = key[1]
        if algo == "closeness":
            deferred.append((key, value))
        else:
            groups.setdefault(algo, []).append((key, value))

    for algo, group in groups.items():
        repairer = repairers.get(algo)
        outcomes = (
            repairer([value for _, value in group])
            if repairer is not None else [None] * len(group)
        )
        for (key, value), outcome in zip(group, outcomes):
            if outcome is None:
                stats.dropped += 1
                continue
            new_row, touched, iters = outcome
            stats.touched_vertices += touched
            stats.repair_iters += iters
            if touched == 0:
                stats.kept += 1
                kept_value = value
            else:
                stats.repaired += 1
                kept_value = new_row
            cache.put((new_version, algo, key[2], key[3]), kept_value)
            if algo == "bfs":
                bfs_rows[key[3]] = (touched == 0, kept_value)

    for key, value in deferred:
        _, algo, cfg, root = key
        ride = bfs_rows.get(root)
        if ride is None:
            stats.dropped += 1
            continue
        unchanged, row = ride
        if unchanged:
            stats.kept += 1
            cache.put((new_version, algo, cfg, root), value)
        elif derive_closeness is not None:
            stats.repaired += 1
            cache.put((new_version, algo, cfg, root), derive_closeness(row))
        else:
            stats.dropped += 1
    return stats
