"""Stdlib-only pull-based metrics registry (DESIGN.md §20).

A copy of ``repro.core.metrics`` (it imports nothing of JAX, but the port
keeps its own copy).  The port's query engine counts its program-cache
events, builds, waves and folded roots here; the serving stack will
register its series in the same registry.

* :class:`Counter` — monotone `float`; ``inc()`` only.
* :class:`Gauge` — settable point-in-time value, or a pull callback
  evaluated at scrape time (``set_function``).
* :class:`Histogram` — fixed buckets chosen at registration; cumulative
  bucket counts plus ``_sum``/``_count`` in the Prometheus convention.

The registry is **pull-based**: writers only mutate in-memory series
(one ``threading.Lock`` per family, so concurrent ``inc()`` from several
threads lose no updates), and readers render on demand —
:meth:`MetricsRegistry.expose_text` emits Prometheus text exposition
format 0.0.4 and :meth:`MetricsRegistry.write_jsonl` appends one JSON
object per series for offline analysis.  A tiny :class:`MetricsServer`
(stdlib ``http.server`` on a daemon thread) serves ``/metrics`` and
``/healthz``.

``parse_exposition`` is a hand-rolled validator for the text format,
exposed as a CLI::

    python -m repro_torch.core.metrics metrics_scrape.txt
    python -m repro_torch.core.metrics http://127.0.0.1:8765/metrics

Instrumentation is host-side only: no series touches a tensor.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default buckets for latency histograms (milliseconds — the service
# telemetry records ms end to end) and for small-integer width/occupancy
# histograms (coalesce width, lanes per wave)
LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)
WIDTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    parts = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    parts += [f'{n}="{_escape_label(str(v))}"' for n, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """Base for one named metric family holding labeled child series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, kwargs: Dict[str, str]) -> Tuple[str, ...]:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kwargs)}")
        return tuple(str(kwargs[ln]) for ln in self.labelnames)

    def labels(self, **kwargs):
        key = self._key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Family):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        return self._value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        self.labels(**labels).set_function(fn)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, lock: threading.Lock, buckets: Sequence[float],
                 exemplars: bool = False):
        self._lock = lock
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        # one slot per bucket INCLUDING the +Inf overflow bucket; each
        # holds the most recent (value, trace_id, ts) observed there
        self._exemplars: Optional[List[Optional[Dict[str, object]]]] = (
            [None] * (len(buckets) + 1) if exemplars else None)

    def observe(self, value: float, trace_id: str = "") -> None:
        i = bisect.bisect_left(self._buckets, value)
        with self._lock:
            if i < len(self._counts):
                self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._exemplars is not None and trace_id:
                self._exemplars[i] = {"value": float(value),
                                      "trace_id": trace_id,
                                      "ts": time.time()}

    @property
    def value(self) -> Dict[str, object]:
        with self._lock:
            return {"buckets": list(self._counts), "sum": self._sum,
                    "count": self._count}

    def exemplars(self) -> Optional[List[Optional[Dict[str, object]]]]:
        """Per-bucket exemplar slots (last slot = +Inf overflow), or
        ``None`` when the family was registered without exemplars."""
        with self._lock:
            return None if self._exemplars is None else list(self._exemplars)

    def exemplar_near_quantile(self, q: float) -> Optional[Dict[str, object]]:
        """The retained exemplar closest (from below) to the bucket the
        ``q``-quantile falls in — ``exemplar_near_quantile(0.99)`` is the
        'show me a p99 request' hook the ops console uses."""
        with self._lock:
            if self._exemplars is None or self._count == 0:
                return None
            target = q * self._count
            cum = 0
            idx = len(self._counts)  # default: +Inf overflow bucket
            for i, n in enumerate(self._counts):
                cum += n
                if cum >= target:
                    idx = i
                    break
            for i in range(idx, -1, -1):
                if self._exemplars[i] is not None:
                    ex = dict(self._exemplars[i])
                    ex["bucket_le"] = (self._buckets[i]
                                       if i < len(self._buckets)
                                       else math.inf)
                    return ex
            return None


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                 exemplars: bool = False):
        super().__init__(name, help, labelnames)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(b)
        # exemplars (§21): when on, each bucket retains the trace_id of a
        # recent sample so a latency spike links to a concrete request
        # trace.  Raw counts/sums are untouched, exposition text is
        # byte-identical, and the write path adds one slot assignment
        # under the same family lock — the §20 exact-total contention
        # contract (tests/test_metrics.py hammer) holds unchanged.
        self.exemplars_enabled = bool(exemplars)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self.buckets,
                               exemplars=self.exemplars_enabled)

    def observe(self, value: float, trace_id: str = "", **labels) -> None:
        self.labels(**labels).observe(value, trace_id=trace_id)


class MetricsRegistry:
    """Thread-safe collection of metric families, rendered on demand."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  exemplars: bool = False) -> Histogram:
        # register-or-get: the FIRST registration fixes buckets and the
        # exemplar setting; later callers get the existing family.
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, exemplars=exemplars)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def reset(self) -> None:
        """Drop every child series (families stay registered).  Used by
        the load generators' warmup-reset contract."""
        for fam in self.families():
            fam.clear()

    # -- exposition ------------------------------------------------------
    def expose_text(self) -> str:
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            series = fam._series()
            if not series and not fam.labelnames:
                # unlabeled families expose a zero-valued default series
                # so scrapes see every registered metric
                fam.labels()
                series = fam._series()
            for key, child in series:
                if fam.kind == "histogram":
                    v = child.value
                    cum = 0
                    for bound, n in zip(fam.buckets, v["buckets"]):
                        cum += n
                        lbl = _render_labels(fam.labelnames, key,
                                             [("le", _fmt(bound))])
                        out.append(f"{fam.name}_bucket{lbl} {cum}")
                    lbl = _render_labels(fam.labelnames, key,
                                         [("le", "+Inf")])
                    out.append(f"{fam.name}_bucket{lbl} {v['count']}")
                    lbl = _render_labels(fam.labelnames, key)
                    out.append(f"{fam.name}_sum{lbl} {_fmt(v['sum'])}")
                    out.append(f"{fam.name}_count{lbl} {v['count']}")
                else:
                    lbl = _render_labels(fam.labelnames, key)
                    out.append(f"{fam.name}{lbl} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    # -- JSONL snapshot --------------------------------------------------
    def snapshot(self) -> List[Dict[str, object]]:
        """One dict per series: ``{name, type, labels, value}`` (histogram
        value is ``{buckets, bounds, sum, count}``)."""
        rows: List[Dict[str, object]] = []
        for fam in self.families():
            for key, child in fam._series():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    v = child.value
                    v["bounds"] = list(fam.buckets)
                    if fam.exemplars_enabled:
                        v["exemplars"] = child.exemplars()
                    value: object = v
                else:
                    value = child.value
                rows.append({"name": fam.name, "type": fam.kind,
                             "labels": labels, "value": value})
        return rows

    def write_jsonl(self, path: str) -> int:
        """Append one timestamped JSON line per series; returns the
        number of lines written."""
        ts = time.time()
        rows = self.snapshot()
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps({"ts": ts, **row}) + "\n")
        return len(rows)


# module-default registry: subsystems with no natural injection point
# (the engine's module-level program cache) record here, and the CLIs
# expose it
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


# ---------------------------------------------------------------------------
# /metrics + /healthz HTTP server (stdlib http.server, daemon thread)
# ---------------------------------------------------------------------------

class MetricsServer:
    """Serves ``GET /metrics`` (Prometheus text 0.0.4) and ``GET
    /healthz`` (JSON from ``health_fn``; HTTP 503 unless the payload's
    ``"status"`` is ``"ok"``) on a daemon thread.  ``port=0`` binds an
    ephemeral port, reported by :attr:`port` after :meth:`start`.

    Extra endpoints (the §21 ops console) register through ``routes`` /
    :meth:`add_route`: ``fn(query) -> payload`` where ``query`` maps
    parameter name to a list of values.  A payload that is a
    ``(content_type, bytes_or_str)`` pair is sent verbatim (how
    ``/dashboard`` serves HTML); anything else is JSON-encoded.  A route
    that raises returns HTTP 500 with a JSON error body — never a
    traceback page.  Unknown paths 404.  :meth:`stop` is idempotent and
    joins the serving thread with a bounded timeout."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Dict[str, object]]] = None,
                 routes: Optional[Dict[str, Callable]] = None):
        self.registry = registry if registry is not None else _DEFAULT
        self.health_fn = health_fn
        self._routes: Dict[str, Callable] = dict(routes or {})
        self._host = host
        self._port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()  # start/stop idempotence

    def add_route(self, path: str, fn: Callable) -> None:
        """Register (or replace) an extra GET endpoint; safe to call
        after :meth:`start` — the handler reads the table per request."""
        if not path.startswith("/"):
            raise ValueError(f"route path must start with '/': {path!r}")
        self._routes[path] = fn

    def start(self) -> "MetricsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                path = parts.path
                if path == "/metrics":
                    body = server.registry.expose_text().encode()
                    self._send(200, "text/plain; version=0.0.4", body)
                elif path == "/healthz":
                    payload = {"status": "ok"}
                    if server.health_fn is not None:
                        try:
                            payload = server.health_fn()
                        except Exception as e:  # surface, don't crash
                            payload = {"status": "error", "error": repr(e)}
                    code = 200 if payload.get("status") == "ok" else 503
                    self._send(code, "application/json",
                               json.dumps(payload).encode())
                elif path in server._routes:
                    try:
                        payload = server._routes[path](parse_qs(parts.query))
                    except Exception as e:
                        self._send(500, "application/json",
                                   json.dumps({"error": repr(e)}).encode())
                        return
                    if (isinstance(payload, tuple) and len(payload) == 2):
                        ctype, body = payload
                        if isinstance(body, str):
                            body = body.encode()
                        self._send(200, ctype, body)
                    else:
                        self._send(200, "application/json",
                                   json.dumps(payload).encode())
                else:
                    self._send(404, "text/plain", b"not found\n")

        with self._lifecycle:
            if self._httpd is not None:
                return self  # already serving
            self._httpd = ThreadingHTTPServer(
                (self._host, self._port), Handler)
            self._httpd.daemon_threads = True
            self._port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="metrics-server")
            self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    def stop(self) -> None:
        with self._lifecycle:
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None


# ---------------------------------------------------------------------------
# hand-rolled exposition-format parser / validator (tier-2 CI scrape check)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^ ]+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_PAIR_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"')


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)  # raises ValueError on garbage


def _parse_labels(s: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(s):
        m = _LABEL_PAIR_RE.match(s, pos)
        if not m:
            raise ValueError(f"malformed label pair at {s[pos:]!r}")
        raw = m.group("value")
        labels[m.group("name")] = (
            raw.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))
        pos = m.end()
        if pos < len(s):
            if s[pos] != ",":
                raise ValueError(f"expected ',' in labels at {s[pos:]!r}")
            pos += 1
    return labels


def parse_exposition(text: str) -> Dict[str, Dict[str, object]]:
    """Parse + validate Prometheus text exposition format 0.0.4.

    Returns ``{family: {"type", "help", "samples": [(name, labels,
    value), ...]}}``.  Raises ``ValueError`` on any malformed line,
    samples for undeclared families, histogram bucket counts that are
    not cumulative, or a missing ``+Inf`` bucket.
    """
    families: Dict[str, Dict[str, object]] = {}

    def _family_for(sample_name: str) -> Optional[str]:
        if sample_name in families:
            return sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[: -len(suffix)] if sample_name.endswith(
                suffix) else None
            if base and base in families and \
                    families[base]["type"] == "histogram":
                return base
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            if line.startswith("# HELP "):
                _, _, rest = line.partition("# HELP ")
                name, _, help_text = rest.partition(" ")
                if not _NAME_RE.match(name):
                    raise ValueError(f"bad metric name {name!r}")
                families.setdefault(
                    name, {"type": "untyped", "help": "", "samples": []})
                families[name]["help"] = help_text
            elif line.startswith("# TYPE "):
                _, _, rest = line.partition("# TYPE ")
                name, _, kind = rest.partition(" ")
                if not _NAME_RE.match(name):
                    raise ValueError(f"bad metric name {name!r}")
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    raise ValueError(f"bad metric type {kind!r}")
                fam = families.setdefault(
                    name, {"type": kind, "help": "", "samples": []})
                if fam["samples"]:
                    raise ValueError(
                        f"TYPE for {name!r} after its samples")
                fam["type"] = kind
            elif line.startswith("#"):
                continue  # comment
            else:
                m = _SAMPLE_RE.match(line)
                if not m:
                    raise ValueError("malformed sample line")
                name = m.group("name")
                labels = _parse_labels(m.group("labels") or "")
                value = _parse_value(m.group("value"))
                fam = _family_for(name)
                if fam is None:
                    raise ValueError(
                        f"sample {name!r} has no # TYPE declaration")
                families[fam]["samples"].append((name, labels, value))
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e} — {line!r}") from None

    # histogram invariants: per-series buckets cumulative, +Inf == _count
    for fname, fam in families.items():
        if fam["type"] != "histogram":
            continue
        by_series: Dict[Tuple[Tuple[str, str], ...], Dict[str, object]] = {}
        for sname, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            st = by_series.setdefault(key, {"buckets": [], "count": None})
            if sname == f"{fname}_bucket":
                if "le" not in labels:
                    raise ValueError(f"{fname}: bucket sample missing le")
                st["buckets"].append(
                    (_parse_value(labels["le"]), value))
            elif sname == f"{fname}_count":
                st["count"] = value
        for key, st in by_series.items():
            buckets = sorted(st["buckets"])
            if not buckets or not math.isinf(buckets[-1][0]):
                raise ValueError(f"{fname}{dict(key)}: missing +Inf bucket")
            counts = [c for _, c in buckets]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(
                    f"{fname}{dict(key)}: bucket counts not cumulative")
            if st["count"] is not None and st["count"] != counts[-1]:
                raise ValueError(
                    f"{fname}{dict(key)}: _count != +Inf bucket")
    return families


def _fetch(source: str) -> str:
    if source.startswith("http://") or source.startswith("https://"):
        from urllib.request import urlopen

        with urlopen(source, timeout=10) as resp:
            return resp.read().decode()
    with open(source) as f:
        return f.read()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Prometheus text-format scrape "
        "(file path or http URL)")
    ap.add_argument("source", help="scrape file or /metrics URL")
    ap.add_argument("--require", action="append", default=[],
                    metavar="FAMILY", help="fail unless FAMILY is present")
    args = ap.parse_args(argv)
    text = _fetch(args.source)
    try:
        families = parse_exposition(text)
    except ValueError as e:
        print(f"INVALID exposition: {e}")
        return 1
    missing = [r for r in args.require if r not in families]
    if missing:
        print(f"INVALID: required families missing: {missing}")
        return 1
    n_samples = sum(len(f["samples"]) for f in families.values())
    print(f"OK: {len(families)} families, {n_samples} samples")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
