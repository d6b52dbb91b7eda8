"""Cross-stack request tracing for the serving tier (DESIGN.md §18).

One :class:`Tracer` collects timestamped events from every layer a request
crosses — submit → admission → queue wait → coalesce → wave dispatch →
engine wave → (repair | replica hop | hedged retry | chaos fault) — and
exports them as a Perfetto/Chrome ``trace_event`` JSON (load the file at
``ui.perfetto.dev`` or ``chrome://tracing``) or as a line-per-event JSONL
stream.

Design constraints, in order:

* **stdlib-only** — telemetry must stay importable anywhere the service
  runs (the same rule :mod:`repro_torch.service.telemetry` follows); no numpy,
  no torch, no third-party JSON-schema library.
* **thread-safe, allocation-light** — events are plain dicts appended
  under one lock; all timestamps come from ONE monotonic clock so spans
  recorded by different threads order correctly on a shared timeline.
* **zero cost when disabled** — :data:`NULL_TRACER` implements the same
  surface as no-ops; call sites write ``tracer.span(...)`` unconditionally
  and pay nothing when tracing is off.

Event model (deliberately smaller than OpenTelemetry):

* a **span** is a completed ``[t0, t1]`` interval on a *track* (one
  Perfetto row: ``"queue"``, ``"scheduler"``, ``"engine"``,
  ``"replica-0"``, ``"router"``, ...) with a name, a category, an
  optional ``trace_id`` correlating every event of one request, and a
  free-form ``args`` dict (JSON-safe values only);
* an **instant** is a point event on a track (hedge fired, chaos fault
  injected, replica killed);
* ``trace_id`` is a 16-hex string minted per request at the front door
  (:meth:`Tracer.new_trace_id`); every downstream span carries it in
  ``args["trace_id"]`` after export, so Perfetto's query/filter box finds
  a request's full path across tracks;
* every recorded event additionally carries a ``span_id`` — an 8-hex id
  unique within the tracer — so two same-named events on one trace (the
  original attempt and its hedged retry, say) stay distinguishable after
  export (``args["span_id"]``);
* a span opened as a context (:meth:`Tracer.span`, :func:`span`) also
  carries ``parent_id``, the ``span_id`` of the innermost span of the same
  tracer open on the same thread when it opened (omitted at the top), so
  each name's self time can be read (:func:`span_times`).

**Spans inside the program.**  :func:`recording` sets a process-wide
current tracer (:data:`NULL_TRACER` otherwise) and :func:`span` opens a
span on it without the call site holding a tracer.  While a
``torch.profiler`` session records, :func:`span` also opens a
``record_function`` range of the same name on the calling thread, tracer
or not, so the program's spans sit in the device trace on the profiler's
own clock beside the device operations they launched.  torch is looked up
in ``sys.modules`` and never imported here.  Off (no tracer, no profiler),
:func:`span` reads the current tracer, asks torch whether a profiler
records, and returns a shared null context.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional

#: schema tag stamped on every exported trace document
CHROME_SCHEMA = "request_trace/v1"


class _SpanHandle:
    """Mutable handle yielded by :meth:`Tracer.span`: mutate ``.args``
    inside the ``with`` block and the final dict lands on the event;
    ``t0`` and ``t1`` are the span's two clock points (tracer-clock
    seconds), ``t1`` set when the block exits."""

    __slots__ = ("args", "t0", "t1")

    def __init__(self, args: Dict[str, Any]):
        self.args = args


class _OpenSpan:
    """Context manager measuring one span's wall interval.  On a recording
    tracer it takes its ``span_id`` and ``parent_id`` when it opens; on
    :data:`NULL_TRACER` it only reads the clock (:func:`clocked`)."""

    __slots__ = ("_tracer", "_name", "_track", "_cat", "_trace_id",
                 "_handle", "_ids")

    def __init__(self, tracer, name, track, cat, trace_id, args):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self._trace_id = trace_id
        self._handle = _SpanHandle(dict(args or {}))

    def __enter__(self) -> _SpanHandle:
        if self._tracer.enabled:
            self._ids = self._tracer._open()
        self._handle.t0 = self._tracer.now()
        return self._handle

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = self._handle.t1 = self._tracer.now()
        if not self._tracer.enabled:
            return
        self._tracer._close()
        if exc_type is not None:
            self._handle.args.setdefault("error", exc_type.__name__)
        self._tracer.add_span(
            self._name, self._handle.t0, t1, track=self._track,
            cat=self._cat, trace_id=self._trace_id, args=self._handle.args,
            ids=self._ids,
        )


class Tracer:
    """Thread-safe in-memory event collector (see module docstring)."""

    def __init__(self, *, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._t0 = clock()
        self._next_span = 0  # span_id allocator (8-hex, unique per tracer)
        self._local = threading.local()  # each thread's open context spans

    enabled = True

    # --- clock / ids ------------------------------------------------------

    def now(self) -> float:
        """Monotonic seconds; the timebase every span must use."""
        return self._clock()

    @staticmethod
    def new_trace_id() -> str:
        """16-hex request correlation id."""
        return uuid.uuid4().hex[:16]

    def _us(self, t: float) -> int:
        return int(round((t - self._t0) * 1e6))

    def _new_span_id(self) -> str:
        # caller holds self._lock
        self._next_span += 1
        return f"{self._next_span:08x}"

    def _open(self):
        """A context span opens: its ``(span_id, parent_id)``, the parent
        the innermost span open on this thread ("" at the top)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            span_id = self._new_span_id()
        ids = (span_id, stack[-1] if stack else "")
        stack.append(span_id)
        return ids

    def _close(self) -> None:
        self._local.stack.pop()

    # --- recording --------------------------------------------------------

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        track: str = "main",
        cat: str = "",
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
        ids: Optional[tuple] = None,
    ) -> None:
        """Record a completed ``[t0, t1]`` interval (tracer-clock seconds);
        ``ids`` is the ``(span_id, parent_id)`` a context span took when it
        opened."""
        ev = {
            "kind": "span",
            "name": name,
            "cat": cat,
            "track": track,
            "ts_us": self._us(t0),
            "dur_us": max(self._us(t1) - self._us(t0), 0),
            "trace_id": trace_id,
            "args": dict(args or {}),
        }
        if ids is not None:
            ev["span_id"] = ids[0]
            if ids[1]:
                ev["parent_id"] = ids[1]
        with self._lock:
            if ids is None:
                ev["span_id"] = self._new_span_id()
            self._events.append(ev)

    def span(
        self,
        name: str,
        *,
        track: str = "main",
        cat: str = "",
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> _OpenSpan:
        """``with tracer.span("engine-wave", track="engine") as sp: ...`` —
        measures the block's wall interval; ``sp.args`` is mutable and an
        exception inside the block annotates ``args["error"]``."""
        return _OpenSpan(self, name, track, cat, trace_id, args)

    def instant(
        self,
        name: str,
        *,
        track: str = "main",
        cat: str = "",
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
        t: Optional[float] = None,
    ) -> None:
        """Record a point event (hedge fired, fault injected, ...)."""
        ev = {
            "kind": "instant",
            "name": name,
            "cat": cat,
            "track": track,
            "ts_us": self._us(self.now() if t is None else t),
            "dur_us": 0,
            "trace_id": trace_id,
            "args": dict(args or {}),
        }
        with self._lock:
            ev["span_id"] = self._new_span_id()
            self._events.append(ev)

    # --- access / export --------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot copy of every recorded event (dicts are shared —
        treat them as read-only)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` document.  Tracks map to small
        integer ``tid``\\ s under one ``pid`` with ``"M"`` thread-name
        metadata records, which is what makes Perfetto render one named
        row per track."""
        events = self.events()
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []
        for ev in events:
            tid = tids.setdefault(ev["track"], len(tids) + 1)
            args = dict(ev["args"])
            if ev["trace_id"]:
                args["trace_id"] = ev["trace_id"]
            if ev.get("span_id"):
                args["span_id"] = ev["span_id"]
            if ev.get("parent_id"):
                args["parent_id"] = ev["parent_id"]
            rec = {
                "name": ev["name"],
                "cat": ev["cat"] or "serve",
                "pid": 1,
                "tid": tid,
                "ts": ev["ts_us"],
                "args": args,
            }
            if ev["kind"] == "span":
                rec["ph"] = "X"
                rec["dur"] = ev["dur_us"]
            else:
                rec["ph"] = "i"
                rec["s"] = "t"  # thread-scoped instant
            out.append(rec)
        meta = [
            {
                "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": track},
            }
            for track, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {"schema": CHROME_SCHEMA},
        }

    def write_chrome(self, path: str) -> int:
        """Write the Perfetto-loadable JSON; returns the event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return len(self)

    def write_jsonl(self, path: str) -> int:
        """One raw event per line (stream-appendable form)."""
        events = self.events()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        return len(events)


class _NullTracer:
    """No-op stand-in: the disabled path of every call site."""

    enabled = False

    def now(self) -> float:  # real clock: callers may compute durations
        return time.monotonic()

    @staticmethod
    def new_trace_id() -> str:
        return ""

    def add_span(self, *a, **kw) -> None:
        pass

    def span(self, *a, **kw) -> "_NullSpan":
        return _NullSpan()

    def instant(self, *a, **kw) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


class _NullSpan:
    __slots__ = ("args",)

    def __enter__(self) -> _SpanHandle:
        self.args = {}
        return self  # duck-types _SpanHandle: has .args

    def __exit__(self, *exc) -> None:
        pass


#: process-wide disabled tracer; ``tracer or NULL_TRACER`` at wiring sites
NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# Spans inside the program: the process-wide current tracer
# ---------------------------------------------------------------------------

_current = NULL_TRACER


class _Off:
    """The shared context of a span nothing records: yields ``None``."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Mirrored:
    """A span inside a ``torch.profiler.record_function`` range of its
    name; yields the span's handle."""

    __slots__ = ("_inner", "_range")

    def __init__(self, inner, name: str):
        self._inner = inner
        self._range = sys.modules["torch"].profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc) -> None:
        try:
            self._inner.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording(tracer):
    """``with recording(Tracer()) as tr: ...``: inside the block
    :func:`span` records on ``tracer`` (the process-wide current tracer,
    restored on exit)."""
    global _current
    before, _current = _current, tracer
    try:
        yield tracer
    finally:
        _current = before


def span(name: str, **args):
    """``with span("bfs.expand", pull=True): ...``: a span on the current
    tracer, ``args`` its arguments, and a profiler range of ``name`` while
    a ``torch.profiler`` session records.  Yields the span's handle when
    a tracer records it, ``None`` otherwise."""
    tracer = _current
    inner = tracer.span(name, args=args) if tracer.enabled else _OFF
    return _Mirrored(inner, name) if _profiling() else inner


def clocked(name: str, **args):
    """:func:`span` whose handle is always yielded with its two clock
    points (``t0``, ``t1``), for a caller that times the block whether a
    tracer records or not."""
    inner = _OpenSpan(_current, name, "main", "", "", args)
    return _Mirrored(inner, name) if _profiling() else inner


def span_times(events: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Each span name's ``count``, ``total_s`` (the spans' durations
    summed) and ``self_s`` (each span's duration less the part its
    children cover: the spans whose ``parent_id`` is its ``span_id``)."""
    spans = [ev for ev in events if ev["kind"] == "span"]
    covered: Dict[str, int] = {}
    for ev in spans:
        if ev.get("parent_id"):
            covered[ev["parent_id"]] = covered.get(ev["parent_id"], 0) + ev["dur_us"]
    out: Dict[str, Dict[str, float]] = {}
    for ev in spans:
        row = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += ev["dur_us"] / 1e6
        row["self_s"] += max(ev["dur_us"] - covered.get(ev["span_id"], 0), 0) / 1e6
    return out


# ---------------------------------------------------------------------------
# Minimal JSON-schema validation (the container has no ``jsonschema``)
# ---------------------------------------------------------------------------


def validate_schema(doc: Any, schema: Dict[str, Any], path: str = "$") -> List[str]:
    """Validate ``doc`` against the JSON-Schema SUBSET the repo's trace
    schemas use: ``type``, ``required``, ``properties``,
    ``additionalProperties`` (bool), ``items``, ``enum``, ``minimum``,
    ``const``.  Returns a list of human-readable violations (empty =
    valid).  NOT a general validator — exactly enough for
    ``tests/trace_schema.json`` and ``tests/torch_trace_schema.json``, kept
    in-repo because the image has no ``jsonschema`` package."""
    errs: List[str] = []
    typ = schema.get("type")
    if typ is not None:
        checkers = {
            "object": lambda d: isinstance(d, dict),
            "array": lambda d: isinstance(d, list),
            "string": lambda d: isinstance(d, str),
            "integer": lambda d: isinstance(d, int) and not isinstance(d, bool),
            "number": lambda d: (isinstance(d, (int, float))
                                 and not isinstance(d, bool)),
            "boolean": lambda d: isinstance(d, bool),
            "null": lambda d: d is None,
        }
        types = typ if isinstance(typ, list) else [typ]
        if not any(checkers[t](doc) for t in types):
            return [f"{path}: expected type {typ}, got {type(doc).__name__}"]
    if "const" in schema and doc != schema["const"]:
        errs.append(f"{path}: expected const {schema['const']!r}, got {doc!r}")
    if "enum" in schema and doc not in schema["enum"]:
        errs.append(f"{path}: {doc!r} not in enum {schema['enum']}")
    if "minimum" in schema and isinstance(doc, (int, float)) \
            and not isinstance(doc, bool) and doc < schema["minimum"]:
        errs.append(f"{path}: {doc} < minimum {schema['minimum']}")
    if isinstance(doc, dict):
        for key in schema.get("required", ()):
            if key not in doc:
                errs.append(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in doc:
                errs.extend(validate_schema(doc[key], sub, f"{path}.{key}"))
        if schema.get("additionalProperties") is False:
            for key in doc:
                if key not in props:
                    errs.append(f"{path}: unexpected key {key!r}")
    if isinstance(doc, list) and "items" in schema:
        for i, item in enumerate(doc):
            errs.extend(validate_schema(item, schema["items"], f"{path}[{i}]"))
    return errs


def main(argv=None) -> int:
    """``python -m repro_torch.core.tracing TRACE.json --schema SCHEMA.json`` —
    validate an exported trace file (CI's trace-smoke gate)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("trace", help="exported Chrome/Perfetto trace JSON")
    ap.add_argument("--schema", required=True, help="JSON schema file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    with open(args.schema) as f:
        schema = json.load(f)
    errs = validate_schema(doc, schema)
    if errs:
        for e in errs[:50]:
            print(f"SCHEMA VIOLATION: {e}")
        return 1
    n = len(doc.get("traceEvents", doc if isinstance(doc, list) else []))
    print(f"{args.trace}: {n} events, schema OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
