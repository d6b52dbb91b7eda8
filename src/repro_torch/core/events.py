"""Structured, typed event log for the ops plane (DESIGN.md §21).

Traces (§18) answer *where the time went* inside one request; metrics
(§20) answer *how much of everything* is happening; this module answers
*what happened, in order* — admission rejects, scheduler dispatch
decisions, engine waves, replica state transitions, chaos injections,
repair sweeps, cache evictions — as a bounded in-memory ring plus an
optional append-only JSONL sink.  Every event is stamped with the §18
``trace_id`` when one is in scope, so logs, spans, and metric exemplars
share ONE correlation key: given a p99 exemplar's trace_id you can pull
the request's spans from the trace file AND its event slice from here
(``/debug/events?trace_id=`` on the ops console).

Same design rules as :mod:`repro_torch.core.tracing`:

* **stdlib-only** — importable anywhere the service runs;
* **thread-safe, allocation-light** — one lock, plain dicts, a
  ``deque(maxlen=capacity)`` ring so a long-lived server never grows
  without bound (the JSONL sink, when attached, keeps the full stream);
* **typed** — ``kind`` must be one of :data:`KINDS`; free-form detail
  goes in ``name`` and ``args``.  The shape is schema-checked by
  ``tests/event_schema.json`` exactly like trace documents::

      python -m repro_torch.core.events events.jsonl --schema tests/event_schema.json
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.core.tracing import validate_schema

#: schema tag for exported event streams (stamped per line)
EVENT_SCHEMA = "ops_events/v1"

#: the closed set of event types; one entry per emitting subsystem class.
KINDS = (
    "request",    # front-door lifecycle: submitted / completed / failed / cache-hit
    "admission",  # admission-control rejects (queue_full, overload, ...)
    "sched",      # scheduler decisions: wave dispatch trigger + coalesce width
    "wave",       # an engine wave ran (class, width, engine waves consumed)
    "replica",    # replica state transitions (HEALTHY→SUSPECT→DEAD→RECOVERING)
    "chaos",      # fault injections (kill-replica, stall-wave, batch faults)
    "retry",      # degraded serves: retry / hedge / failover / stale-serve
    "repair",     # §16 repair sweeps, compactions, §17 catch-up batches
    "cache",      # result-cache evictions and stale-epoch drops
    "slo",        # §21 alert state transitions (PENDING/FIRING/RESOLVED)
)


class EventLog:
    """Bounded ring of typed events with an optional JSONL sink."""

    def __init__(self, capacity: int = 4096, *, clock=time.time):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._seq = 0
        self._sink = None
        self._sink_path: Optional[str] = None
        self._dropped = 0  # ring overwrites (sink, if attached, keeps all)

    enabled = True

    # --- recording --------------------------------------------------------

    def emit(
        self,
        kind: str,
        name: str,
        *,
        subsystem: str = "",
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Append one typed event; returns the recorded dict.

        ``kind`` must come from :data:`KINDS` — the closed set is what
        makes the log *typed* rather than printf-with-extra-steps."""
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; use one of {KINDS}")
        ev = {
            "schema": EVENT_SCHEMA,
            "seq": 0,  # assigned under the lock
            "ts": self._clock(),
            "kind": kind,
            "name": name,
            "subsystem": subsystem,
            "trace_id": trace_id,
            "args": dict(args or {}),
        }
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)
            if self._sink is not None:
                self._sink.write(json.dumps(ev) + "\n")
                self._sink.flush()
        return ev

    # --- sink -------------------------------------------------------------

    def attach_sink(self, path: str) -> None:
        """Append every future event to ``path`` as one JSON line each
        (the ring stays bounded; the sink keeps the full stream)."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = open(path, "a")
            self._sink_path = path

    def close_sink(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
                self._sink_path = None

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    # --- access -----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot copy of the ring, oldest first (dicts are shared —
        treat them as read-only)."""
        with self._lock:
            return list(self._ring)

    def query(
        self,
        *,
        trace_id: Optional[str] = None,
        kind: Optional[str] = None,
        subsystem: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Filtered slice (oldest first); ``limit`` keeps the NEWEST n
        matches — this is what ``/debug/events?trace_id=`` serves."""
        out = [
            ev for ev in self.events()
            if (trace_id is None or ev["trace_id"] == trace_id)
            and (kind is None or ev["kind"] == kind)
            and (subsystem is None or ev["subsystem"] == subsystem)
        ]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def last(self, *, kind: Optional[str] = None,
             with_trace: bool = False) -> Optional[Dict[str, Any]]:
        """Newest matching event (or None).  ``with_trace=True`` skips
        events without a trace_id — the SLO exemplar picker uses this to
        attach a *navigable* trace to a firing alert."""
        for ev in reversed(self.events()):
            if kind is not None and ev["kind"] != kind:
                continue
            if with_trace and not ev["trace_id"]:
                continue
            return ev
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe counters: total emitted, ring occupancy, per-kind
        counts over the resident window."""
        events = self.events()
        by_kind: Dict[str, int] = {}
        for ev in events:
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
        with self._lock:
            return {
                "emitted": self._seq,
                "resident": len(events),
                "capacity": self.capacity,
                "dropped_from_ring": self._dropped,
                "by_kind": by_kind,
                "sink": self._sink_path,
            }


class _NullEventLog:
    """No-op stand-in mirroring :data:`repro_torch.core.tracing.NULL_TRACER`."""

    enabled = False
    capacity = 0
    sink_path = None

    def emit(self, kind: str, name: str, **kw) -> Dict[str, Any]:
        return {}

    def attach_sink(self, path: str) -> None:
        pass

    def close_sink(self) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def query(self, **kw) -> List[Dict[str, Any]]:
        return []

    def last(self, **kw) -> Optional[Dict[str, Any]]:
        return None

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def snapshot(self) -> Dict[str, Any]:
        return {"emitted": 0, "resident": 0, "capacity": 0,
                "dropped_from_ring": 0, "by_kind": {}, "sink": None}


#: process-wide disabled log; ``events or NULL_EVENTS`` at wiring sites
NULL_EVENTS = _NullEventLog()

# module-default log: subsystems with no injection point (the scheduler
# inside a service, the result cache) emit here, exactly as they record
# to the default metrics registry.  serve_graph attaches the JSONL sink.
_DEFAULT = EventLog()


def default_event_log() -> EventLog:
    return _DEFAULT


def emit(kind: str, name: str, *, subsystem: str = "", trace_id: str = "",
         args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Record into the module-default log (the common call site form)."""
    return _DEFAULT.emit(kind, name, subsystem=subsystem,
                         trace_id=trace_id, args=args)


# ---------------------------------------------------------------------------
# JSONL validation CLI (tier-2 CI gate, like repro_torch.core.tracing's)
# ---------------------------------------------------------------------------


def validate_events_file(path: str, schema: Dict[str, Any]) -> List[str]:
    """Validate every line of an exported JSONL stream against the
    per-event ``schema``; returns human-readable violations."""
    errs: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {lineno}: not JSON ({e})")
                continue
            errs.extend(validate_schema(ev, schema, path=f"line {lineno}"))
    return errs


def main(argv=None) -> int:
    """``python -m repro_torch.core.events EVENTS.jsonl --schema SCHEMA.json
    [--require-kind KIND] [--trace-id ID]`` — validate an exported event
    stream; ``--require-kind`` fails unless at least one event of that
    kind is present, ``--trace-id`` fails unless the slice for that id
    is non-empty (CI's correlation gate)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("events", help="exported JSONL event stream")
    ap.add_argument("--schema", required=True, help="per-event JSON schema")
    ap.add_argument("--require-kind", action="append", default=[],
                    metavar="KIND", help="fail unless KIND appears")
    ap.add_argument("--trace-id", default=None,
                    help="fail unless this trace's slice is non-empty")
    args = ap.parse_args(argv)
    with open(args.schema) as f:
        schema = json.load(f)
    errs = validate_events_file(args.events, schema)
    if errs:
        for e in errs[:50]:
            print(f"SCHEMA VIOLATION: {e}")
        return 1
    with open(args.events) as f:
        events = [json.loads(l) for l in f if l.strip()]
    kinds = {ev["kind"] for ev in events}
    missing = [k for k in args.require_kind if k not in kinds]
    if missing:
        print(f"INVALID: required kinds missing: {missing}")
        return 1
    if args.trace_id is not None:
        n = sum(1 for ev in events if ev["trace_id"] == args.trace_id)
        if n == 0:
            print(f"INVALID: no events for trace_id {args.trace_id}")
            return 1
        print(f"trace {args.trace_id}: {n} correlated events")
    print(f"OK: {len(events)} events, {len(kinds)} kinds, schema OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
