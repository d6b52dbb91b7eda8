"""PyTorch port, SLO burn-rate alerting (§21): the same synthetic series
and windows through ``repro.core.slo`` and the port's copy give equal burn
rates, alert states and verdicts; then the reference's cases against the
port: math, state machine, config, CLI."""

import json

import pytest

from repro_torch.core import slo
from repro_torch.core.events import EventLog
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.slo import (
    DEFAULT_RULES,
    AlertRule,
    Objective,
    SLOManager,
    SLOTracker,
    build_from_config,
    counter_events_source,
    event_log_exemplar,
    histogram_exemplar,
    latency_threshold_source,
    load_config,
)


def _rule(short=10.0, long=100.0, burn=2.0, for_s=0.0, **kw):
    return AlertRule("r", short, long, burn, for_s=for_s, **kw)


class _Feed:
    """Hand-driven cumulative (good, total) source."""

    def __init__(self):
        self.good = 0.0
        self.total = 0.0

    def add(self, good=0, bad=0):
        self.good += good
        self.total += good + bad

    def __call__(self):
        return self.good, self.total


# ---------------------------------------------------------------------------
# parity with the reference module
# ---------------------------------------------------------------------------

# (good, bad) arrivals per tick: clean, a burst of failures, recovery
_SERIES = [(100, 0)] * 5 + [(40, 60)] * 6 + [(100, 1)] * 10 + [(10, 90)] * 3 + [(100, 0)] * 8


def _drive(mod, events_mod):
    """The same synthetic series through a config-built manager (the
    default multi-window rules scaled, a hold-down) and a hand-built
    tracker; returns the burn rates a tick, the alert states a tick and
    the final verdict, and the slo events emitted."""
    feeds = {"avail": _Feed(), "lat": _Feed()}
    log = events_mod.EventLog(clock=lambda: 5.0)
    exemplar = {"trace_id": "00000000000000ab"}
    mgr = mod.build_from_config(
        {"schema": "slo_config/v1", "time_scale": 0.01, "for_s": 0.02,
         "objectives": [
             {"name": "avail", "type": "availability", "target": 0.99},
             {"name": "lat", "type": "latency", "target": 0.9,
              "threshold_ms": 50.0}]},
        lambda obj: feeds[obj.name], lambda obj: (lambda: exemplar),
        events=log)
    hand = mod.SLOTracker(mod.Objective("hand", "availability", 0.95), feeds["avail"],
                          [mod.AlertRule("fast", 0.05, 0.2, 2.0, for_s=0.03)])
    burns, states = [], []
    for i, (good, bad) in enumerate(_SERIES):
        now = 0.01 * i
        feeds["avail"].add(good=good, bad=bad)
        feeds["lat"].add(good=good + bad // 2, bad=bad - bad // 2)
        mgr.tick(now)
        hand.tick(now)
        burns.append([t._burn(r.short_s, now) for t in mgr.trackers + [hand]
                      for r in t.rules] + [hand._burn(0.2, now)])
        states.append([a.state for t in mgr.trackers + [hand] for a in t.alerts])
    return burns, states, mgr.verdict(), hand.status(), log.events()


def test_burn_rates_states_and_verdicts_equal_the_reference():
    from repro.core import events as ref_events
    from repro.core import slo as ref_slo
    from repro_torch.core import events as port_events

    got = _drive(slo, port_events)
    want = _drive(ref_slo, ref_events)
    assert got == want
    verdict = got[2]
    assert verdict["schema"] == "slo_verdict/v1" and verdict["any_fired"]
    assert {"FIRING", "PENDING", "OK"} & {s for row in got[1] for s in row}
    assert any(e["kind"] == "slo" and e["trace_id"] for e in got[4])


# ---------------------------------------------------------------------------
# objective / rule validation
# ---------------------------------------------------------------------------


def test_objective_validation():
    with pytest.raises(ValueError, match="unknown SLO type"):
        Objective("x", "uptime", 0.99)
    with pytest.raises(ValueError, match="target"):
        Objective("x", "availability", 1.0)
    with pytest.raises(ValueError, match="threshold_ms"):
        Objective("x", "latency", 0.99)
    obj = Objective("x", "availability", 0.999)
    assert obj.budget == pytest.approx(0.001)


def test_rule_validation_and_scaling():
    with pytest.raises(ValueError):
        AlertRule("r", 100.0, 10.0, 1.0)  # short > long
    with pytest.raises(ValueError):
        AlertRule("r", 1.0, 2.0, 0.0)
    r = AlertRule("page", 300.0, 3600.0, 14.4, for_s=60.0)
    s = r.scaled(0.01)
    assert (s.short_s, s.long_s, s.for_s) == (3.0, 36.0, 0.6)
    assert s.burn == 14.4  # burn thresholds are dimensionless


# ---------------------------------------------------------------------------
# burn-rate math
# ---------------------------------------------------------------------------


def test_burn_is_bad_fraction_over_budget():
    feed = _Feed()
    tr = SLOTracker(Objective("avail", "availability", 0.99),
                    feed, [_rule()])
    tr.tick(0.0)               # baseline sample before traffic
    feed.add(good=90, bad=10)  # 10% bad, budget 1% -> burn 10x
    tr.tick(1.0)
    assert tr._burn(10.0, 1.0) == pytest.approx(10.0)


def test_burn_windows_use_reference_samples():
    feed = _Feed()
    tr = SLOTracker(Objective("avail", "availability", 0.9),
                    feed, [_rule(short=2.0, long=100.0)])
    tr.tick(0.0)
    feed.add(good=100)          # old history: clean
    tr.tick(1.0)
    feed.add(good=0, bad=10)    # recent: all bad
    tr.tick(5.0)
    # short window (2s) references the t=1 sample: only the bad delta
    assert tr._burn(2.0, 5.0) == pytest.approx(1.0 / 0.1)
    # long window falls back to the oldest sample: 10 bad / 110 total
    assert tr._burn(100.0, 5.0) == pytest.approx((10 / 110) / 0.1)


def test_burn_zero_cases():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.99), feed, [_rule()])
    assert tr._burn(10.0, 0.0) == 0.0  # no samples yet
    tr.tick(0.0)
    tr.tick(1.0)
    assert tr._burn(10.0, 1.0) == 0.0  # no traffic


# ---------------------------------------------------------------------------
# alert state machine (explicit time, no wall clock)
# ---------------------------------------------------------------------------


def test_alert_fires_when_both_windows_exceed():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(short=10.0, long=10.0, burn=2.0)])
    assert tr.tick(0.0) == []  # baseline, no traffic, no transitions
    feed.add(good=50, bad=50)  # burn = 0.5/0.1 = 5x
    # for_s=0: PENDING collapses into FIRING within the same tick
    assert [a.state for a in tr.tick(1.0)] == ["FIRING"]
    a = tr.alerts[0]
    assert a.fired_count == 1 and a.fired_at == 1.0


def test_for_s_holddown_delays_firing():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(burn=1.0, for_s=5.0)])
    tr.tick(0.0)
    feed.add(good=0, bad=10)
    tr.tick(1.0)
    assert tr.alerts[0].state == "PENDING"
    tr.tick(5.0)
    assert tr.alerts[0].state == "PENDING"  # held 4s < for_s
    tr.tick(6.0)
    assert tr.alerts[0].state == "FIRING"


def test_pending_clears_without_firing_on_recovery():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(short=2.0, long=2.0, burn=1.0, for_s=10.0)])
    tr.tick(0.0)
    feed.add(bad=10)
    tr.tick(1.0)
    assert tr.alerts[0].state == "PENDING"
    feed.add(good=1000)  # clean traffic; short window forgets the bad
    tr.tick(5.0)
    assert tr.alerts[0].state == "INACTIVE"
    assert tr.alerts[0].fired_count == 0


def test_firing_resolves_and_can_refire():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(short=2.0, long=2.0, burn=1.0)])
    tr.tick(0.0)
    feed.add(bad=10)
    tr.tick(1.0)
    assert tr.alerts[0].state == "FIRING"
    feed.add(good=1000)
    tr.tick(5.0)
    a = tr.alerts[0]
    assert a.state == "RESOLVED" and a.resolved_at == 5.0
    feed.add(bad=500)
    tr.tick(9.0)
    assert a.state == "FIRING" and a.fired_count == 2


def test_exemplar_captured_at_firing():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(burn=1.0)],
                    exemplar_fn=lambda: {"trace_id": "cafe"})
    tr.tick(0.0)
    feed.add(bad=5)
    tr.tick(1.0)
    assert tr.alerts[0].state == "FIRING"
    assert tr.alerts[0].exemplar == {"trace_id": "cafe"}


def test_manager_emits_slo_events_with_exemplar_trace():
    feed = _Feed()
    log = EventLog()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(burn=1.0)],
                    exemplar_fn=lambda: {"trace_id": "cafe"})
    mgr = SLOManager([tr], events=log)
    mgr.tick(0.0)
    feed.add(bad=5)
    mgr.tick(1.0)
    ev = log.last(kind="slo")
    assert ev["name"] == "alert-firing"
    assert ev["trace_id"] == "cafe"
    assert ev["args"]["slo"] == "a" and ev["args"]["state"] == "FIRING"


def test_verdict_shape_and_flags():
    feed = _Feed()
    tr = SLOTracker(Objective("a", "availability", 0.9), feed,
                    [_rule(burn=2.0)])
    mgr = SLOManager([tr])
    mgr.tick(0.0)
    feed.add(good=99, bad=1)  # burn 0.1x: compliant
    mgr.tick(1.0)
    v = mgr.verdict()
    assert v["schema"] == slo.VERDICT_SCHEMA
    assert v["ticks"] == 2
    assert v["objectives"][0]["compliance"] == pytest.approx(0.99)
    assert v["objectives"][0]["budget_consumed"] == pytest.approx(0.1)
    assert v["any_fired"] is False and v["ok"] is True
    feed.add(bad=50)
    mgr.tick(2.0)
    v = mgr.verdict()
    assert v["any_fired"] is True and v["ok"] is False
    json.dumps(v)  # verdicts must be plain-JSON serializable


# ---------------------------------------------------------------------------
# config loading + window scaling
# ---------------------------------------------------------------------------


def _config(**over):
    doc = {
        "schema": "slo_config/v1",
        "time_scale": 0.01,
        "objectives": [
            {"name": "avail", "type": "availability", "target": 0.999},
            {"name": "lat", "type": "latency", "target": 0.99,
             "threshold_ms": 100.0},
        ],
    }
    doc.update(over)
    return doc


def test_load_config_validates(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(_config()))
    assert load_config(str(path))["time_scale"] == 0.01

    path.write_text(json.dumps(_config(schema="slo_config/v999")))
    with pytest.raises(ValueError, match="invalid SLO config"):
        load_config(str(path))
    path.write_text(json.dumps(_config(time_scale=0.0)))
    with pytest.raises(ValueError, match="time_scale"):
        load_config(str(path))
    bad = _config()
    bad["objectives"][0]["type"] = "uptime"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="invalid SLO config"):
        load_config(str(path))


def test_build_from_config_scales_default_rules():
    feeds = {}

    def source_for(obj):
        feeds[obj.name] = _Feed()
        return feeds[obj.name]

    mgr = build_from_config(_config(), source_for)
    assert len(mgr.trackers) == 2
    rules = mgr.trackers[0].rules
    assert [r.name for r in rules] == [r["name"] for r in DEFAULT_RULES]
    # production 5m/1h page windows scaled by 0.01 -> 3s/36s
    assert (rules[0].short_s, rules[0].long_s) == (3.0, 36.0)
    assert rules[0].burn == 14.4  # dimensionless, untouched by scaling
    assert mgr.trackers[1].objective.threshold_ms == 100.0


def test_build_from_config_explicit_rules_and_for_s():
    cfg = _config(for_s=100.0, rules=[
        {"name": "fast", "short_s": 10.0, "long_s": 50.0, "burn": 2.0,
         "severity": "warn"},
    ])
    mgr = build_from_config(cfg, lambda obj: _Feed())
    r = mgr.trackers[0].rules[0]
    assert (r.short_s, r.long_s, r.for_s) == (0.1, 0.5, 1.0)
    assert r.severity == "warn"


# ---------------------------------------------------------------------------
# registry source bindings
# ---------------------------------------------------------------------------


def test_counter_events_source_counts_only_listed_outcomes():
    reg = MetricsRegistry()
    c = reg.counter("router_events_total", "events", ("router", "event"))
    c.inc(90, router="r0", event="completed")
    c.inc(5, router="r0", event="retries")
    c.inc(3, router="r0", event="submitted")  # unlisted: must not dilute
    c.inc(10, router="r1", event="completed")
    src = counter_events_source(reg, "router_events_total",
                                good=("completed",),
                                bad=("retries", "hedges"))
    assert src() == (100.0, 105.0)
    # a family that was never registered reads as dead-zero, not an error
    absent = counter_events_source(reg, "nope_total", good=("a",), bad=())
    assert absent() == (0.0, 0.0)


def test_latency_threshold_source_uses_covered_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms", "latency", ("svc",),
                      buckets=(10.0, 100.0, 1000.0))
    for v in (5.0, 50.0, 500.0, 5000.0):
        h.observe(v, svc="a")
    src = latency_threshold_source(reg, "lat_ms", 100.0)
    good, total = src()
    assert (good, total) == (2.0, 4.0)  # <=10 and <=100 buckets covered
    # a threshold between bounds rounds DOWN to the last covered bucket
    src199 = latency_threshold_source(reg, "lat_ms", 199.0)
    assert src199() == (2.0, 4.0)


def test_event_log_exemplar_prefers_first_listed_kind():
    log = EventLog()
    log.emit("chaos", "kill-replica", trace_id="aa")
    log.emit("retry", "hedge", trace_id="bb")
    pick = event_log_exemplar(log, kinds=("retry", "chaos"))
    assert pick() == {"trace_id": "bb", "source": "event:retry:hedge"}
    empty = event_log_exemplar(EventLog())
    assert empty() is None


def test_histogram_exemplar_binding():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0, 100.0),
                      exemplars=True)
    h.observe(0.5, trace_id="fast")
    h.observe(50.0, trace_id="slow")
    pick = histogram_exemplar(reg, "lat_ms", q=0.99)
    ex = pick()
    assert ex["trace_id"] == "slow"
    assert ex["source"] == "histogram:lat_ms"
    assert ex["value_ms"] == 50.0


# ---------------------------------------------------------------------------
# verdict CLI (the CI chaos gate)
# ---------------------------------------------------------------------------


def _verdict_file(tmp_path, *, fired: bool):
    feed = _Feed()
    tr = SLOTracker(Objective("availability", "availability", 0.9), feed,
                    [_rule(burn=1.0)],
                    exemplar_fn=lambda: {"trace_id": "feed1234"})
    mgr = SLOManager([tr])
    mgr.tick(0.0)
    feed.add(good=100, bad=100 if fired else 0)
    mgr.tick(1.0)
    path = tmp_path / f"verdict_{'fired' if fired else 'clean'}.json"
    path.write_text(json.dumps(mgr.verdict()))
    return str(path)


def test_cli_expectations(tmp_path, capsys):
    fired = _verdict_file(tmp_path, fired=True)
    clean = _verdict_file(tmp_path, fired=False)
    assert slo.main([fired, "--expect", "availability=FIRED"]) == 0
    assert slo.main([fired, "--expect", "availability=FIRING"]) == 0
    assert slo.main([clean, "--expect", "availability=FIRED"]) == 1
    assert slo.main([fired, "--expect", "nosuch=FIRED"]) == 1
    assert slo.main([fired, "--expect-exemplar", "availability"]) == 0
    assert slo.main([clean, "--expect-exemplar", "availability"]) == 1
    out = capsys.readouterr().out
    assert "EXEMPLAR availability feed1234" in out
