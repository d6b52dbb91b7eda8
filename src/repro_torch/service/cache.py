"""Bounded LRU result cache, keyed by graph epoch (DESIGN.md §15).

Every entry's key embeds the graph epoch under which the result was
computed: ``(graph_epoch, algo, cfg, root)``.  Correctness therefore never
depends on eviction — bumping the epoch makes every old key unreachable by
construction, so a mutated or reloaded graph CANNOT serve stale levels even
if its entries are still resident.  :meth:`drop_stale` exists purely to
return the memory early; the LRU bound exists purely to keep a long-lived
service process from growing without limit.

``capacity == 0`` disables the cache entirely (every probe is a miss and
nothing is stored) — the load generator uses this to measure raw engine
throughput without cache pollution.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Tuple

from repro_torch.core.events import NULL_EVENTS

# sentinel distinguishing "cached None" from "absent"
_MISS = object()


def result_key(
    epoch, algo: str, cfg: Hashable, root: int
) -> Tuple[Hashable, str, Hashable, int]:
    """The canonical cache key: ``(graph_epoch, algo, cfg, root)``.
    ``epoch`` is any hashable, ordered version marker — a plain int (the
    §15 epoch) or a :class:`repro_torch.dynamic.versioning.GraphVersion`."""
    try:
        epoch = int(epoch)  # normalize int-like (np integers included)
    except TypeError:
        pass  # GraphVersion and friends key as themselves
    return (epoch, algo, cfg, int(root))


class ResultCache:
    """Thread-safe bounded LRU over epoch-keyed query results."""

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_dropped = 0
        # §21 event-log binding (off until bind_events); eviction and
        # stale-drop sweeps emit ``kind="cache"`` events when bound
        self._events = NULL_EVENTS
        self._subsystem = ""

    def bind_events(self, events, subsystem: str) -> None:
        """Attach the §21 event log this cache reports evictions to."""
        self._events = events
        self._subsystem = subsystem

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def get(self, key: Tuple) -> Tuple[bool, Any]:
        """``(hit, value)``; a hit refreshes the entry's LRU position."""
        with self._lock:
            value = self._data.get(key, _MISS)
            if value is _MISS:
                self.misses += 1
                return False, None
            self._data.move_to_end(key)
            self.hits += 1
            return True, value

    def peek(self, key: Tuple) -> bool:
        """Membership probe that touches no counters and no LRU order."""
        with self._lock:
            return key in self._data

    def items_snapshot(self):
        """Point-in-time ``[(key, value), ...]`` copy (LRU order, coldest
        first) — the §16 partial-invalidation walk reads this without
        holding the lock across repairs."""
        with self._lock:
            return list(self._data.items())

    def put(self, key: Tuple, value: Any) -> None:
        if not self.enabled:
            return
        evicted = []
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            while len(self._data) >= self.capacity:
                old_key, _ = self._data.popitem(last=False)
                self.evictions += 1
                evicted.append(old_key)
            self._data[key] = value
        for old_key in evicted:  # emit outside the lock
            self._events.emit(
                "cache", "evict", subsystem=self._subsystem,
                args={"algo": str(old_key[1]), "root": int(old_key[3]),
                      "epoch": str(old_key[0])})

    def drop_stale(self, current_epoch: int) -> int:
        """Free every entry computed under an epoch < ``current_epoch``.

        Purely a memory optimization: stale keys can never be requested
        again (probes always embed the current epoch)."""
        with self._lock:
            stale = [k for k in self._data if k[0] < current_epoch]
            for k in stale:
                del self._data[k]
            self.stale_dropped += len(stale)
        if stale:
            self._events.emit(
                "cache", "stale-drop", subsystem=self._subsystem,
                args={"dropped": len(stale), "epoch": str(current_epoch)})
        return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable counter snapshot (telemetry embeds this)."""
        with self._lock:
            probes = self.hits + self.misses
            return {
                "size": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / probes) if probes else 0.0,
                "evictions": self.evictions,
                "stale_dropped": self.stale_dropped,
            }
