"""Service telemetry: latency percentiles, QPS, wave occupancy (DESIGN.md §15).

The counters are **registry-backed series** (DESIGN.md §20):
every ``record_*`` call increments a labeled series in a
:class:`repro_torch.core.metrics.MetricsRegistry` (the module default unless
one is injected), so a live ``/metrics`` scrape and the JSON
:meth:`Telemetry.snapshot` read the same numbers.  The snapshot API —
shape, collision check, warmup-reset contract — is unchanged.

Latency reservoirs use :class:`PercentileReservoir`, a documented
estimator:

* **exact mode** — the first ``exact_limit`` (default 1024) samples are
  kept verbatim and quantiles use the same linear interpolation as
  :func:`percentiles` (numpy's default ``linear`` method), so small
  windows are *exact*;
* **sketch mode** — past the limit, samples fold into log-spaced
  buckets with ratio ``gamma = (1+alpha)/(1-alpha)`` (the DDSketch
  construction): any reported quantile is within ``alpha`` relative
  error (default 1%) of an actual sample at that rank.  ``count`` and
  ``mean`` stay exact in both modes.

Everything in the snapshot is plain ``int``/``float``/``str`` —
``json.dumps`` safe by construction (``launch/serve_graph.py
--stats-json`` and the load generator persist it verbatim).
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Any, Dict, Optional, Sequence

from repro_torch.core import metrics as metrics_mod


def percentiles(values, points=(50.0, 95.0, 99.0)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` via linear interpolation
    (numpy-free so telemetry stays importable anywhere)."""
    out = {f"p{int(p) if float(p).is_integer() else p}": 0.0 for p in points}
    if not values:
        return out
    xs = sorted(values)
    n = len(xs)
    for p in points:
        rank = (p / 100.0) * (n - 1)
        lo = int(rank)
        hi = min(lo + 1, n - 1)
        frac = rank - lo
        key = f"p{int(p) if float(p).is_integer() else p}"
        out[key] = xs[lo] * (1.0 - frac) + xs[hi] * frac
    return out


class PercentileReservoir:
    """Exact-then-sketch quantile estimator (see module docstring).

    Unsynchronized on purpose: callers (``Telemetry`` /
    ``RouterTelemetry``) already serialize access under their own lock.
    """

    _TINY = 1e-12  # values at or below this land in the zero bucket

    __slots__ = ("exact_limit", "alpha", "_gamma", "_lg", "_exact",
                 "_buckets", "_zero", "_count", "_sum")

    def __init__(self, exact_limit: int = 1024, alpha: float = 0.01):
        if exact_limit < 1:
            raise ValueError(f"exact_limit must be >= 1: {exact_limit}")
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1): {alpha}")
        self.exact_limit = int(exact_limit)
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._exact: Optional[list] = []
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0

    def __len__(self) -> int:
        return self._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def exact(self) -> bool:
        """True while every sample is still stored verbatim."""
        return self._exact is not None

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def _fold(self, v: float) -> None:
        if v <= self._TINY:
            self._zero += 1
        else:
            k = math.ceil(math.log(v) / self._lg)
            self._buckets[k] = self._buckets.get(k, 0) + 1

    def add(self, value: float) -> None:
        v = float(value)
        self._count += 1
        self._sum += v
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) > self.exact_limit:
                for x in self._exact:
                    self._fold(x)
                self._exact = None
            return
        self._fold(v)

    def quantile(self, q: float) -> float:
        """The q-th percentile (``q`` in [0, 100]).  Exact mode: linear
        interpolation between order statistics.  Sketch mode:
        nearest-rank lookup into the gamma buckets; the returned bucket
        midpoint is within ``alpha`` relative error of the sample at
        that rank."""
        if self._count == 0:
            return 0.0
        if self._exact is not None:
            xs = sorted(self._exact)
            n = len(xs)
            rank = (q / 100.0) * (n - 1)
            lo = int(rank)
            hi = min(lo + 1, n - 1)
            frac = rank - lo
            return xs[lo] * (1.0 - frac) + xs[hi] * frac
        rank = round((q / 100.0) * (self._count - 1))
        if rank < self._zero:
            return 0.0
        cum = self._zero
        est = 0.0
        for k in sorted(self._buckets):
            cum += self._buckets[k]
            est = 2.0 * self._gamma ** k / (self._gamma + 1.0)
            if rank < cum:
                return est
        return est

    def summary(self, points: Sequence[float] = (50.0, 95.0, 99.0),
                scale: float = 1.0) -> Dict[str, float]:
        """The snapshot block shape: ``{"p50", "p95", "p99", "mean",
        "count"}`` with values multiplied by ``scale`` (relative-error
        bounds are scale-invariant)."""
        out = {}
        for p in points:
            key = f"p{int(p) if float(p).is_integer() else p}"
            out[key] = self.quantile(p) * scale
        out["mean"] = self.mean() * scale
        out["count"] = self._count
        return out


#: per-request lifecycle stages with their own latency reservoirs
#: (DESIGN.md §18): time spent queued before the scheduler drained the
#: request, linger inside the coalescing window, the engine-execution
#: window of its wave, and the device-repair portion of a mutation batch.
STAGES = ("queue_wait", "coalesce", "engine", "repair")

#: every counter a Telemetry carries, as events of ONE registry family
#: (``service_events_total{service=..., event=...}``)
_EVENTS = (
    "submitted", "completed", "rejected", "expired", "failed",
    "deadline_misses", "dispatches", "engine_waves", "lanes_used",
    "lanes_offered", "coalesced_roots", "epoch_bumps", "mutations",
    "compactions", "rows_kept", "rows_repaired", "rows_dropped",
)

_SVC_IDS = itertools.count()
_ROUTER_IDS = itertools.count()


def _service_families(reg: metrics_mod.MetricsRegistry):
    return (
        reg.counter("service_events_total",
                    "request/dispatch/mutation lifecycle events per "
                    "service instance", ("service", "event")),
        reg.counter("service_admission_rejects_total",
                    "admission-control rejections by structured reason",
                    ("service", "reason")),
        # exemplars on (§21): the "total" stage's buckets retain recent
        # trace_ids, so a p99 spike names a concrete request trace
        reg.histogram("service_latency_ms",
                      "end-to-end and per-stage request latency",
                      ("service", "stage"), exemplars=True),
        reg.histogram("service_wave_width",
                      "unique roots per dispatched engine wave",
                      ("service",), buckets=metrics_mod.WIDTH_BUCKETS),
    )


class Telemetry:
    """Counters + latency reservoirs for one :class:`GraphQueryService`,
    stored as labeled series in ``registry`` (module default when None).
    Each instance gets a fresh ``service="svc<N>"`` label, so the
    warmup-reset contract (replace the Telemetry wholesale) starts new
    series instead of diluting measured ones."""

    def __init__(self, *, latency_window: int = 65536, clock=time.monotonic,
                 registry: Optional[metrics_mod.MetricsRegistry] = None,
                 name: Optional[str] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self.registry = (registry if registry is not None
                         else metrics_mod.default_registry())
        self.name = name if name is not None else f"svc{next(_SVC_IDS)}"
        events, rejects, latency, width = _service_families(self.registry)
        self._events = {e: events.labels(service=self.name, event=e)
                        for e in _EVENTS}
        self._rejects = rejects
        self._lat_hist = {
            s: latency.labels(service=self.name, stage=s)
            for s in ("total",) + STAGES
        }
        self._width_hist = width.labels(service=self.name)
        # exact storage is bounded at 1024 regardless of the legacy
        # window size — beyond that the sketch's error bound takes over
        exact = max(1, min(int(latency_window), 1024))
        self._latencies = PercentileReservoir(exact_limit=exact)
        self._stages = {s: PercentileReservoir(exact_limit=exact)
                        for s in STAGES}

    def _count(self, event: str) -> int:
        return int(self._events[event].value)

    # --- submission path --------------------------------------------------

    def record_submit(self) -> None:
        self._events["submitted"].inc()

    def record_rejected(self, reason: str = "unspecified") -> None:
        self._events["rejected"].inc()
        self._rejects.inc(service=self.name, reason=reason)

    def record_expired(self) -> None:
        self._events["expired"].inc()

    def record_failed(self) -> None:
        self._events["failed"].inc()

    def record_completed(self, latency_s: float, deadline_met: bool,
                         trace_id: str = "") -> None:
        self._events["completed"].inc()
        self._lat_hist["total"].observe(latency_s * 1e3, trace_id=trace_id)
        with self._lock:
            self._latencies.add(latency_s)
        if not deadline_met:
            self._events["deadline_misses"].inc()

    def record_stage(self, stage: str, seconds: float) -> None:
        """Add one sample to a per-stage latency reservoir (§18 request
        breakdown); ``stage`` must be one of :data:`STAGES`."""
        if stage not in self._stages:
            raise ValueError(
                f"unknown stage {stage!r}; expected one of {STAGES}"
            )
        self._lat_hist[stage].observe(seconds * 1e3)
        with self._lock:
            self._stages[stage].add(seconds)

    # --- dispatch path ----------------------------------------------------

    def record_dispatch(
        self, *, engine_waves: int, lanes_used: int, lanes_offered: int,
        coalesced_roots: int = 0,
    ) -> None:
        self._events["dispatches"].inc()
        self._events["engine_waves"].inc(engine_waves)
        self._events["lanes_used"].inc(lanes_used)
        self._events["lanes_offered"].inc(lanes_offered)
        self._events["coalesced_roots"].inc(coalesced_roots)
        self._width_hist.observe(lanes_used)

    def record_epoch_bump(self) -> None:
        self._events["epoch_bumps"].inc()

    def record_mutation(self, stats) -> None:
        """Fold one :class:`~repro_torch.dynamic.versioning.InvalidationStats`
        (an ``apply_updates`` batch) into the counters."""
        self._events["mutations"].inc()
        self._events["rows_kept"].inc(stats.kept)
        self._events["rows_repaired"].inc(stats.repaired)
        self._events["rows_dropped"].inc(stats.dropped)

    def record_compaction(self) -> None:
        self._events["compactions"].inc()

    # --- reporting --------------------------------------------------------

    def snapshot(self, **extra: Any) -> Dict[str, Any]:
        """JSON-serializable state; keyword extras (e.g. ``cache=...``,
        ``pending=...``, ``epoch=...``) are merged in verbatim.  An extra
        whose name collides with a core snapshot key raises ``ValueError``
        — extras must never silently shadow measured telemetry.

        Warmup-reset contract: ``uptime_s`` (and so ``qps``) is measured
        from construction time; services replace their ``Telemetry``
        wholesale after warmup (``reset_telemetry``) so compile time never
        dilutes the rate.  An empty window — zero completions — reports
        ``qps: 0.0`` exactly, never a denormal from a near-zero uptime."""
        c = {e: self._count(e) for e in _EVENTS}
        with self._lock:
            elapsed = max(self._clock() - self._t0, 1e-9)
            lat_block = self._latencies.summary(scale=1e3)
            stage_blocks = {s: r.summary(scale=1e3)
                            for s, r in self._stages.items()}
        rows_total = (c["rows_kept"] + c["rows_repaired"]
                      + c["rows_dropped"])
        snap: Dict[str, Any] = {
            "uptime_s": elapsed,
            "submitted": c["submitted"],
            "completed": c["completed"],
            "rejected": c["rejected"],
            "expired": c["expired"],
            "failed": c["failed"],
            "deadline_misses": c["deadline_misses"],
            "qps": c["completed"] / elapsed if c["completed"] else 0.0,
            "latency_ms": lat_block,
            "stages_ms": stage_blocks,
            "dispatches": c["dispatches"],
            "engine_waves": c["engine_waves"],
            "wave_occupancy": (
                c["lanes_used"] / c["lanes_offered"]
                if c["lanes_offered"] else 0.0
            ),
            "coalesced_roots": c["coalesced_roots"],
            "epoch_bumps": c["epoch_bumps"],
            "mutations": {
                "batches": c["mutations"],
                "compactions": c["compactions"],
                "rows_kept": c["rows_kept"],
                "rows_repaired": c["rows_repaired"],
                "rows_dropped": c["rows_dropped"],
                # the §16 partial-invalidation hit-rate: cached rows
                # that stayed servable across mutation batches
                "survival_rate": (
                    (c["rows_kept"] + c["rows_repaired"]) / rows_total
                    if rows_total else 1.0
                ),
            },
        }
        collisions = sorted(set(snap) & set(extra))
        if collisions:
            raise ValueError(
                f"snapshot extras would overwrite core keys: {collisions}"
            )
        snap.update(extra)
        return snap

    # legacy attribute access (telemetry.submitted etc.) kept working
    def __getattr__(self, name: str) -> int:
        events = self.__dict__.get("_events")
        if events is not None and name in events:
            return int(events[name].value)
        raise AttributeError(name)
