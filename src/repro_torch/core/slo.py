"""Declarative SLOs with multi-window multi-burn-rate alerting (§21).

Google-SRE-workbook alerting, shrunk to fit a benchmark harness:

* an **objective** declares what fraction of requests must be good —
  ``availability`` (served cleanly: no failure, no retry/hedge, no stale
  fallback), ``latency`` (under a threshold in ms), or ``staleness``
  (not served from the §17 degraded stale-read path);
* the **error budget** is ``1 - target``;
* the **burn rate** over a window is the fraction of requests in that
  window that were bad, divided by the budget — burn 1.0 exhausts the
  budget exactly at the SLO period's end, burn 14.4 exhausts a 30-day
  budget in 2 days;
* an **alert rule** pairs a short and a long window (the short window
  makes the alert *reset fast* once the problem stops; the long window
  keeps one noisy second from paging) and fires only when BOTH exceed
  the rule's burn threshold.  The classic production setup is a fast
  page rule (5 m / 1 h at burn 14.4) plus a slow warn rule (6 h / 3 d at
  burn 1.0); a bench run lasting seconds declares ``time_scale`` in its
  ``--slo-config`` and every window (and ``for_s`` hold-down) is
  multiplied by it, so the SAME math that would page production is
  exercised by a 10-second chaos run in CI.

Evaluation is **pull-based and deterministic**: :meth:`SLOManager.tick`
takes an explicit ``now``, samples each objective's cumulative
``(good, total)`` source (bound to §20 registry series by the helpers
at the bottom), and steps a PENDING→FIRING→RESOLVED state machine per
rule.  No threads, no wall-clock reads — tests drive time by hand and
get byte-stable verdicts.

When an alert fires it captures an **exemplar**: a trace_id picked from
the §21 event log (most recent degraded-serve event) or from a §20
histogram bucket exemplar, so the verdict JSON names one concrete
request whose spans and event slice show *why* the budget burned —
metrics → exemplar → trace → events, one key end to end.

Stdlib-only, like every telemetry module in this repo.
"""

from __future__ import annotations

import json
import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.events import NULL_EVENTS
from repro_torch.core.tracing import validate_schema

CONFIG_SCHEMA = "slo_config/v1"
VERDICT_SCHEMA = "slo_verdict/v1"

OBJECTIVE_TYPES = ("availability", "latency", "staleness")
ALERT_STATES = ("INACTIVE", "PENDING", "FIRING", "RESOLVED")

#: the production-shaped default rules (REAL-time windows, seconds);
#: ``time_scale`` in the config multiplies every window for bench runs
DEFAULT_RULES = (
    {"name": "page", "short_s": 300.0, "long_s": 3600.0,
     "burn": 14.4, "severity": "page"},
    {"name": "warn", "short_s": 21600.0, "long_s": 259200.0,
     "burn": 1.0, "severity": "warn"},
)


class Objective:
    """One declarative SLO: ``type`` + ``target`` (+ ``threshold_ms``
    for latency objectives)."""

    def __init__(self, name: str, type: str, target: float,
                 threshold_ms: Optional[float] = None):
        if type not in OBJECTIVE_TYPES:
            raise ValueError(
                f"unknown SLO type {type!r}; use one of {OBJECTIVE_TYPES}")
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target}")
        if type == "latency" and (threshold_ms is None or threshold_ms <= 0):
            raise ValueError("latency objectives need threshold_ms > 0")
        self.name = name
        self.type = type
        self.target = float(target)
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "type": self.type,
                             "target": self.target}
        if self.threshold_ms is not None:
            d["threshold_ms"] = self.threshold_ms
        return d


class AlertRule:
    """Short+long window pair with a shared burn threshold."""

    def __init__(self, name: str, short_s: float, long_s: float,
                 burn: float, severity: str = "page", for_s: float = 0.0):
        if short_s <= 0 or long_s <= 0 or short_s > long_s:
            raise ValueError(
                f"need 0 < short_s <= long_s, got {short_s}/{long_s}")
        if burn <= 0:
            raise ValueError(f"burn threshold must be > 0, got {burn}")
        self.name = name
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.burn = float(burn)
        self.severity = severity
        self.for_s = float(for_s)  # hold-down before PENDING -> FIRING

    def scaled(self, time_scale: float) -> "AlertRule":
        return AlertRule(self.name, self.short_s * time_scale,
                         self.long_s * time_scale, self.burn,
                         self.severity, self.for_s * time_scale)


class _AlertState:
    """Deterministic per-(objective, rule) state machine."""

    def __init__(self, objective: Objective, rule: AlertRule):
        self.objective = objective
        self.rule = rule
        self.state = "INACTIVE"
        self.pending_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.fired_count = 0
        self.exemplar: Optional[Dict[str, Any]] = None
        self.burn_short = 0.0
        self.burn_long = 0.0

    def step(self, now: float, burn_short: float, burn_long: float
             ) -> Optional[str]:
        """Advance one tick; returns the new state name on a transition,
        else None."""
        self.burn_short = burn_short
        self.burn_long = burn_long
        cond = burn_short >= self.rule.burn and burn_long >= self.rule.burn
        before = self.state
        if self.state in ("INACTIVE", "RESOLVED"):
            if cond:
                self.state = "PENDING"
                self.pending_since = now
        if self.state == "PENDING":
            if not cond:
                self.state = "INACTIVE"
                self.pending_since = None
            elif now - self.pending_since >= self.rule.for_s:
                self.state = "FIRING"
                self.fired_at = now
                self.fired_count += 1
        elif self.state == "FIRING" and not cond:
            self.state = "RESOLVED"
            self.resolved_at = now
        return self.state if self.state != before else None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "slo": self.objective.name,
            "rule": self.rule.name,
            "severity": self.rule.severity,
            "state": self.state,
            "burn_short": round(self.burn_short, 6),
            "burn_long": round(self.burn_long, 6),
            "burn_threshold": self.rule.burn,
            "windows_s": [self.rule.short_s, self.rule.long_s],
            "fired_at": self.fired_at,
            "resolved_at": self.resolved_at,
            "fired_count": self.fired_count,
            "exemplar": self.exemplar,
        }


class SLOTracker:
    """One objective + its cumulative ``(good, total)`` source + the
    alert state machines over it."""

    def __init__(self, objective: Objective,
                 source: Callable[[], Tuple[float, float]],
                 rules: Sequence[AlertRule],
                 exemplar_fn: Optional[Callable[[], Optional[Dict]]] = None):
        self.objective = objective
        self.source = source
        self.rules = list(rules)
        self.exemplar_fn = exemplar_fn
        self.alerts = [_AlertState(objective, r) for r in self.rules]
        # (t, good, total) cumulative samples; pruned past the longest
        # window so a long-lived server stays bounded
        self._samples: "deque[Tuple[float, float, float]]" = deque()
        self._horizon = max(r.long_s for r in self.rules) * 2 + 1e-9

    def _burn(self, window_s: float, now: float) -> float:
        """Burn rate over the trailing window: bad-fraction / budget.

        The reference point is the newest sample at or before
        ``now - window_s``; a run younger than the window measures over
        its full history (exactly what a CI chaos run wants)."""
        if not self._samples:
            return 0.0
        ref = self._samples[0]
        for s in self._samples:
            if s[0] <= now - window_s:
                ref = s
            else:
                break
        t_now, good_now, total_now = self._samples[-1]
        d_total = total_now - ref[2]
        if d_total <= 0:
            return 0.0
        d_bad = (total_now - good_now) - (ref[2] - ref[1])
        return (d_bad / d_total) / self.objective.budget

    def tick(self, now: float) -> List[_AlertState]:
        """Sample the source, update burn rates, step every rule's state
        machine; returns the alerts that TRANSITIONED this tick."""
        good, total = self.source()
        self._samples.append((now, float(good), float(total)))
        while self._samples and self._samples[0][0] < now - self._horizon:
            self._samples.popleft()
        transitioned = []
        for alert in self.alerts:
            new = alert.step(now, self._burn(alert.rule.short_s, now),
                             self._burn(alert.rule.long_s, now))
            if new is not None:
                if new == "FIRING" and self.exemplar_fn is not None:
                    alert.exemplar = self.exemplar_fn()
                transitioned.append(alert)
        return transitioned

    def status(self) -> Dict[str, Any]:
        good, total = (self._samples[-1][1:] if self._samples
                       else (0.0, 0.0))
        compliance = (good / total) if total else 1.0
        return {
            **self.objective.to_dict(),
            "good": good,
            "total": total,
            "compliance": round(compliance, 6),
            "budget": round(self.objective.budget, 6),
            "budget_consumed": round(
                ((1.0 - compliance) / self.objective.budget)
                if total else 0.0, 6),
            "alerts": [a.to_dict() for a in self.alerts],
        }


class SLOManager:
    """Ticks every tracker and renders the machine-readable verdict.

    Alert transitions are emitted as ``kind="slo"`` events into the
    event log, carrying the exemplar trace_id when one was captured —
    the console's ``/debug/events`` shows alert history inline with the
    chaos/retry events that caused it."""

    def __init__(self, trackers: Sequence[SLOTracker], *, events=None):
        self.trackers = list(trackers)
        self.events = events if events is not None else NULL_EVENTS
        self.ticks = 0

    def tick(self, now: float) -> None:
        self.ticks += 1
        for tracker in self.trackers:
            for alert in tracker.tick(now):
                ex = alert.exemplar or {}
                self.events.emit(
                    "slo", f"alert-{alert.state.lower()}",
                    subsystem="slo",
                    trace_id=str(ex.get("trace_id", "")),
                    args={"slo": alert.objective.name,
                          "rule": alert.rule.name,
                          "severity": alert.rule.severity,
                          "state": alert.state,
                          "burn_short": round(alert.burn_short, 4),
                          "burn_long": round(alert.burn_long, 4)})

    def status(self) -> List[Dict[str, Any]]:
        return [t.status() for t in self.trackers]

    def alerts(self) -> List[Dict[str, Any]]:
        return [a.to_dict() for t in self.trackers for a in t.alerts]

    def verdict(self) -> Dict[str, Any]:
        """``slo_verdict/v1``: objective status + final alert states.
        ``ok`` is False while any alert is FIRING; ``any_fired`` records
        whether any rule fired at any point in the run (what the CI
        chaos gate asserts)."""
        alerts = self.alerts()
        return {
            "schema": VERDICT_SCHEMA,
            "ticks": self.ticks,
            "objectives": self.status(),
            "alerts": alerts,
            "ok": not any(a["state"] == "FIRING" for a in alerts),
            "any_fired": any(a["fired_count"] > 0 for a in alerts),
        }


# ---------------------------------------------------------------------------
# config loading (--slo-config)
# ---------------------------------------------------------------------------

_CONFIG_SCHEMA = {
    "type": "object",
    "required": ["schema", "objectives"],
    "properties": {
        "schema": {"const": CONFIG_SCHEMA},
        "time_scale": {"type": "number"},
        "for_s": {"type": "number", "minimum": 0},
        "objectives": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "type", "target"],
                "properties": {
                    "name": {"type": "string"},
                    "type": {"enum": list(OBJECTIVE_TYPES)},
                    "target": {"type": "number"},
                    "threshold_ms": {"type": "number"},
                },
            },
        },
        "rules": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "short_s", "long_s", "burn"],
                "properties": {
                    "name": {"type": "string"},
                    "short_s": {"type": "number"},
                    "long_s": {"type": "number"},
                    "burn": {"type": "number"},
                    "severity": {"enum": ["page", "warn"]},
                },
            },
        },
    },
}


def load_config(path: str) -> Dict[str, Any]:
    """Read + validate an ``slo_config/v1`` file; returns the dict."""
    with open(path) as f:
        doc = json.load(f)
    errs = validate_schema(doc, _CONFIG_SCHEMA)
    if errs:
        raise ValueError(f"{path}: invalid SLO config: " + "; ".join(errs))
    if doc.get("time_scale", 1.0) <= 0:
        raise ValueError(f"{path}: time_scale must be > 0")
    return doc


def build_from_config(
    config: Dict[str, Any],
    source_for: Callable[[Objective], Callable[[], Tuple[float, float]]],
    exemplar_for: Optional[
        Callable[[Objective], Optional[Callable]]] = None,
    *,
    events=None,
) -> SLOManager:
    """Wire a validated config to concrete registry sources.

    ``source_for(objective)`` returns the cumulative ``(good, total)``
    sampler for an objective; ``exemplar_for(objective)`` (optional)
    returns its exemplar picker.  Windows and hold-downs are scaled by
    ``config["time_scale"]`` here, once."""
    time_scale = float(config.get("time_scale", 1.0))
    for_s = float(config.get("for_s", 0.0))
    raw_rules = config.get("rules") or [dict(r) for r in DEFAULT_RULES]
    rules = [
        AlertRule(r["name"], r["short_s"], r["long_s"], r["burn"],
                  r.get("severity", "page"), for_s).scaled(time_scale)
        for r in raw_rules
    ]
    trackers = []
    for spec in config["objectives"]:
        obj = Objective(spec["name"], spec["type"], spec["target"],
                        spec.get("threshold_ms"))
        exemplar_fn = exemplar_for(obj) if exemplar_for is not None else None
        trackers.append(
            SLOTracker(obj, source_for(obj), rules, exemplar_fn))
    return SLOManager(trackers, events=events)


# ---------------------------------------------------------------------------
# registry source bindings
# ---------------------------------------------------------------------------


def _iter_series(registry, family_name: str, match: Optional[Dict] = None):
    fam = registry.get(family_name)
    if fam is None:
        return
    for key, child in fam._series():
        labels = dict(zip(fam.labelnames, key))
        if match and any(labels.get(k) != v for k, v in match.items()):
            continue
        yield fam, labels, child


def counter_events_source(registry, family: str, *, label: str = "event",
                          good: Sequence[str], bad: Sequence[str]):
    """(good, total) over a ``*_events_total{..., event=...}`` family:
    total counts only the listed outcomes, so unrelated events (e.g.
    ``submitted``) don't dilute the ratio."""
    good_set, bad_set = set(good), set(bad)

    def sample() -> Tuple[float, float]:
        g = b = 0.0
        for _, labels, child in _iter_series(registry, family):
            ev = labels.get(label)
            if ev in good_set:
                g += child.value
            elif ev in bad_set:
                b += child.value
        return g, g + b

    return sample


def latency_threshold_source(registry, family: str, threshold_ms: float,
                             match: Optional[Dict] = None):
    """(good, total) from histogram buckets: good = observations in
    buckets whose upper bound is <= threshold_ms (the conservative
    reading — a threshold between bounds rounds DOWN to the last
    covered bucket)."""

    def sample() -> Tuple[float, float]:
        g = t = 0.0
        for fam, _, child in _iter_series(registry, family, match):
            v = child.value
            cum = 0
            covered = 0
            for bound, n in zip(fam.buckets, v["buckets"]):
                cum += n
                if bound <= threshold_ms:
                    covered = cum
            g += covered
            t += v["count"]
        return g, t

    return sample


def event_log_exemplar(events, kinds: Sequence[str] = ("retry", "chaos")):
    """Exemplar picker: the most recent trace-stamped event of the given
    kinds — for availability/staleness alerts, that is the last degraded
    serve, whose trace contains the fault that caused it."""

    def pick() -> Optional[Dict[str, Any]]:
        for kind in kinds:
            ev = events.last(kind=kind, with_trace=True)
            if ev is not None:
                return {"trace_id": ev["trace_id"],
                        "source": f"event:{kind}:{ev['name']}"}
        return None

    return pick


def histogram_exemplar(registry, family: str, *, q: float = 0.99,
                       match: Optional[Dict] = None):
    """Exemplar picker: the §20 bucket exemplar nearest the q-quantile
    of the (first matching) histogram series."""

    def pick() -> Optional[Dict[str, Any]]:
        for _, _, child in _iter_series(registry, family, match):
            ex = child.exemplar_near_quantile(q)
            if ex is not None:
                out = {"trace_id": ex["trace_id"],
                       "source": f"histogram:{family}",
                       "value_ms": ex["value"]}
                if not math.isinf(ex["bucket_le"]):
                    out["bucket_le"] = ex["bucket_le"]
                return out
        return None

    return pick


# ---------------------------------------------------------------------------
# verdict assertion CLI (tier-2 CI gate)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m repro_torch.core.slo VERDICT.json --expect SLO=STATE
    [--expect-exemplar SLO]`` — assert final alert states in a verdict
    file: ``--expect availability=FIRING`` passes iff some alert for
    that objective is in that state (``FIRED`` accepts FIRING *or*
    RESOLVED with fired_count > 0); ``--expect-exemplar`` additionally
    requires a captured exemplar trace_id and prints it (CI feeds it to
    the event-log correlation check)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("verdict", help="slo_verdict/v1 JSON file")
    ap.add_argument("--expect", action="append", default=[],
                    metavar="SLO=STATE")
    ap.add_argument("--expect-exemplar", action="append", default=[],
                    metavar="SLO")
    args = ap.parse_args(argv)
    with open(args.verdict) as f:
        doc = json.load(f)
    if doc.get("schema") != VERDICT_SCHEMA:
        print(f"INVALID: schema {doc.get('schema')!r} != {VERDICT_SCHEMA!r}")
        return 1
    alerts = doc.get("alerts", [])
    rc = 0
    for spec in args.expect:
        slo, _, state = spec.partition("=")
        if state == "FIRED":
            ok = any(a["slo"] == slo and a["fired_count"] > 0
                     for a in alerts)
        else:
            ok = any(a["slo"] == slo and a["state"] == state
                     for a in alerts)
        if not ok:
            got = {a["rule"]: a["state"] for a in alerts
                   if a["slo"] == slo}
            print(f"FAIL: expected {spec}, got {got or 'no such SLO'}")
            rc = 1
        else:
            print(f"OK: {spec}")
    for slo in args.expect_exemplar:
        ex = next((a.get("exemplar") for a in alerts
                   if a["slo"] == slo and a.get("exemplar")), None)
        if not ex or not ex.get("trace_id"):
            print(f"FAIL: no exemplar trace for SLO {slo!r}")
            rc = 1
        else:
            print(f"EXEMPLAR {slo} {ex['trace_id']}")
    if rc == 0 and not args.expect and not args.expect_exemplar:
        print(f"OK: {len(alerts)} alerts, "
              f"{sum(1 for a in alerts if a['fired_count'])} fired")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
