"""PyTorch port, the ops console (DESIGN.md §21): ``DASHBOARD_HTML``
byte-equal to the reference's and the ``/debug/*`` routes answering with
the reference's keys over a live server on 127.0.0.1; then the
reference's cases against the port: routes, feeds, dashboard, HTTP
integration, and the chaos showcase (metrics → exemplar → trace → events
end to end) through the port's ``serve_graph`` on the CPU."""

import json
import os
import urllib.error
import urllib.request

import pytest

from repro_torch.core.events import EventLog
from repro_torch.core.metrics import MetricsRegistry, MetricsServer
from repro_torch.service.console import (
    DASHBOARD_HTML,
    cache_feed,
    console_routes,
    install_console,
    replicas_feed,
    single_service_replicas_feed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# route table against toy feeds (no service, no HTTP)
# ---------------------------------------------------------------------------


def test_absent_feeds_answer_available_false_not_404():
    routes = console_routes(events=EventLog())
    assert set(routes) == {"/debug/requests", "/debug/replicas",
                           "/debug/cache", "/debug/slo", "/debug/events",
                           "/dashboard"}
    assert routes["/debug/requests"]({}) == {
        "available": False, "inflight": [], "recent": []}
    assert routes["/debug/replicas"]({})["available"] is False
    assert routes["/debug/cache"]({}) == {"available": False}
    slo = routes["/debug/slo"]({})
    assert slo == {"available": False, "objectives": [], "alerts": []}


def test_requests_route_parses_recent_param():
    seen = []

    def feed(recent):
        seen.append(recent)
        return {"inflight": [], "recent": []}

    routes = console_routes(events=EventLog(), debug_requests=feed)
    assert routes["/debug/requests"]({})["available"] is True
    routes["/debug/requests"]({"recent": ["7"]})
    routes["/debug/requests"]({"recent": ["junk"]})  # bad int -> default
    assert seen == [50, 7, 50]


def test_events_route_slices_by_query_params():
    log = EventLog()
    log.emit("chaos", "kill-replica", subsystem="router", trace_id="t1")
    log.emit("retry", "hedge", subsystem="router", trace_id="t1")
    log.emit("request", "completed", subsystem="svc", trace_id="t2")
    routes = console_routes(events=log)
    out = routes["/debug/events"]({"trace_id": ["t1"]})
    assert out["count"] == 2 and out["trace_id"] == "t1"
    assert [e["name"] for e in out["events"]] == ["kill-replica", "hedge"]
    out = routes["/debug/events"]({"kind": ["request"]})
    assert out["count"] == 1
    out = routes["/debug/events"]({"limit": ["1"]})
    assert [e["name"] for e in out["events"]] == ["completed"]


def test_slo_route_reflects_manager():
    class _Slo:
        def status(self):
            return [{"name": "avail"}]

        def alerts(self):
            return [{"state": "FIRING"}]

    out = console_routes(events=EventLog(), slo=_Slo())["/debug/slo"]({})
    assert out["available"] is True
    assert out["objectives"] == [{"name": "avail"}]
    assert out["alerts"] == [{"state": "FIRING"}]


# ---------------------------------------------------------------------------
# feeds over stub router / service
# ---------------------------------------------------------------------------


class _StubReplica:
    def __init__(self, id, state, applied_seq):
        self.id = id
        self._snap = {"id": id, "state": state, "applied_seq": applied_seq}

    def snapshot(self):
        return dict(self._snap)


def test_replicas_feed_computes_lag_and_serving():
    class _Router:
        latest_seq = 10
        replicas = [_StubReplica(0, "HEALTHY", 10),
                    _StubReplica(1, "RECOVERING", 7),
                    _StubReplica(2, "DEAD", 4)]

    out = replicas_feed(_Router())()
    assert out["head_seq"] == 10 and out["n_serving"] == 2
    assert [r["lag"] for r in out["replicas"]] == [0, 3, 6]


def test_single_service_feed_is_one_healthy_row():
    out = single_service_replicas_feed(object())()
    assert out["n_serving"] == 1
    assert out["replicas"][0]["state"] == "HEALTHY"


def test_cache_feed_single_and_replicated():
    class _Cache:
        def snapshot(self):
            return {"size": 3, "capacity": 8, "hit_rate": 0.5,
                    "evictions": 1, "stale_dropped": 0}

    class _Svc:
        cache = _Cache()

    out = cache_feed(svc=_Svc())()
    assert out["caches"] == [{"replica": 0, **_Cache().snapshot()}]

    class _Rep:
        def __init__(self, id):
            self.id = id
            self.svc = _Svc()

    class _Router:
        replicas = [_Rep(0), _Rep(1)]

    out = cache_feed(router=_Router())()
    assert [c["replica"] for c in out["caches"]] == [0, 1]


# ---------------------------------------------------------------------------
# dashboard document
# ---------------------------------------------------------------------------


def test_dashboard_is_fully_self_contained():
    # the whole point of one-file ops tooling: zero external fetches
    assert "http://" not in DASHBOARD_HTML
    assert "https://" not in DASHBOARD_HTML
    assert "<script src" not in DASHBOARD_HTML
    assert '<link rel="stylesheet" href' not in DASHBOARD_HTML
    # it polls exactly the JSON endpoints this module registers
    for ep in ("/debug/slo", "/debug/replicas", "/debug/requests",
               "/debug/cache", "/debug/events"):
        assert ep in DASHBOARD_HTML
    ctype, body = console_routes(events=EventLog())["/dashboard"]({})
    assert ctype.startswith("text/html") and body is DASHBOARD_HTML


# ---------------------------------------------------------------------------
# live MetricsServer integration (satellite: server hardening surface)
# ---------------------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_console_over_live_server():
    log = EventLog()
    log.emit("wave", "frontier", subsystem="engine", trace_id="t1")
    server = MetricsServer(MetricsRegistry(), port=0)
    install_console(server, events=log)
    server.add_route("/boom", lambda q: 1 / 0)
    server.start()
    try:
        assert server.port != 0  # ephemeral bind reported back
        code, ctype, body = _get(f"{server.url}/debug/events?trace_id=t1")
        assert code == 200 and ctype.startswith("application/json")
        doc = json.loads(body)
        assert doc["count"] == 1
        assert doc["events"][0]["name"] == "frontier"

        code, ctype, body = _get(f"{server.url}/dashboard")
        assert code == 200 and ctype.startswith("text/html")
        assert b"repro ops console" in body

        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{server.url}/debug/nosuch")
        assert exc.value.code == 404

        # a raising route answers JSON 500, never an HTML traceback page
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{server.url}/boom")
        assert exc.value.code == 500
        err = json.loads(exc.value.read())
        assert "ZeroDivisionError" in err["error"]
    finally:
        server.stop()
        server.stop()  # idempotent


# ---------------------------------------------------------------------------
# tier-2 showcase: seeded chaos -> burn-rate page -> exemplar -> trace/events
# ---------------------------------------------------------------------------


def test_chaos_showcase_alert_exemplar_navigates_to_fault(tmp_path):
    """The §21 acceptance recipe: a seeded kill+stall on the same op (3
    replicas, distinct victims under seed 0) forces a deterministic
    hedge, burning the availability budget.  The fired page alert must
    carry an exemplar trace_id whose event slice contains the chaos and
    retry events and whose trace contains the hedge instant — the
    metrics → exemplar → trace → events chain, machine-checked."""
    from repro_torch.core import events as events_mod
    from repro_torch.core import slo as slo_mod
    from repro_torch.launch import serve_graph

    ev = tmp_path / "events.jsonl"
    verdict = tmp_path / "verdict.json"
    trace = tmp_path / "trace.json"
    stats = tmp_path / "stats.json"
    dash = tmp_path / "dashboard.html"
    assert serve_graph.main([
        "--scale", "8", "--ranks", "2", "--device", "cpu", "--lanes", "4",
        "--qps", "100", "--duration", "1",
        "--replicas", "3", "--chaos", "kill-one@op=20;stall@op=20:ms=1500",
        "--chaos-seed", "0", "--router-timeout-s", "0.3",
        "--trace", str(trace),
        "--slo-config", os.path.join(REPO, "examples", "slo_chaos.json"),
        "--events", str(ev), "--slo-verdict", str(verdict),
        "--stats-json", str(stats), "--dashboard-html", str(dash),
    ]) == 0

    # 1. the availability page alert fired, with an exemplar trace
    vdoc = json.loads(verdict.read_text())
    assert vdoc["schema"] == "slo_verdict/v1"
    assert vdoc["any_fired"] is True
    fired = [a for a in vdoc["alerts"]
             if a["slo"] == "availability" and a["fired_count"] > 0]
    assert fired, vdoc["alerts"]
    tid = fired[0]["exemplar"]["trace_id"]
    assert tid

    # 2. the exemplar's event slice tells the whole story: the injected
    #    fault AND the hedge/retry it caused share that trace_id
    lines = [json.loads(l) for l in ev.read_text().splitlines()]
    sliced = [e for e in lines if e["trace_id"] == tid]
    kinds = {e["kind"] for e in sliced}
    assert {"chaos", "retry"} <= kinds, sorted(kinds)

    # 3. same chain via the CI gate CLIs
    schema = os.path.join(REPO, "tests", "event_schema.json")
    assert events_mod.main([str(ev), "--schema", schema,
                            "--require-kind", "chaos",
                            "--require-kind", "retry",
                            "--trace-id", tid]) == 0
    assert slo_mod.main([str(verdict),
                         "--expect", "availability=FIRED",
                         "--expect-exemplar", "availability"]) == 0

    # 4. the trace side: the hedge instant carries the same trace_id
    #    and a span id (the §18 span <-> §21 event join key)
    tdoc = json.loads(trace.read_text())
    hedges = [e for e in tdoc["traceEvents"]
              if e.get("ph") == "i" and e["name"].startswith("hedge:")
              and e["args"].get("trace_id") == tid]
    assert hedges and hedges[0]["args"].get("span_id")

    # 5. stats fold the verdict in (serve_graph_stats/v2)
    sdoc = json.loads(stats.read_text())
    assert sdoc["schema"] == "serve_graph_stats/v2"
    assert sdoc["slo"]["any_fired"] is True

    # 6. dashboard artifact is the self-contained page
    html = dash.read_text()
    assert "repro ops console" in html and "https://" not in html


def test_fault_exemplar_is_the_request_the_fault_was_injected_on():
    """The serving CLI's availability exemplar: the trace the injection
    stamped (``kill-replica`` and ``stall-wave`` on one op), even where a
    killed replica's held requests log their ``kill-impact`` after it;
    else the newest chaos, else the newest retry; never another run's."""
    from repro_torch.launch.serve_graph import fault_exemplar

    log = EventLog()
    log.emit("chaos", "kill-impact", trace_id="old")  # an earlier run's
    first = log.snapshot()["emitted"] + 1
    pick = fault_exemplar(log, first)
    assert pick() is None
    log.emit("retry", "hedge", trace_id="organic")
    assert pick() == {"trace_id": "organic", "source": "event:retry:hedge"}
    log.emit("chaos", "kill-impact", trace_id="hit")
    log.emit("retry", "retry", trace_id="hit")
    assert pick() == {"trace_id": "hit", "source": "event:chaos:kill-impact"}
    log.emit("chaos", "kill-replica", trace_id="op20")
    log.emit("chaos", "stall-wave", trace_id="op20")
    log.emit("chaos", "kill-impact", trace_id="late")  # the abandoned wave's
    log.emit("retry", "retry", trace_id="late")
    assert pick() == {"trace_id": "op20", "source": "event:chaos:stall-wave"}
    log.emit("chaos", "stall-wave", trace_id="")  # untraced: never picked
    assert pick()["trace_id"] == "op20"


# ---------------------------------------------------------------------------
# parity with the reference console
# ---------------------------------------------------------------------------


def test_dashboard_html_is_byte_equal_to_the_reference():
    from repro.service import console as ref_console

    assert DASHBOARD_HTML.encode() == ref_console.DASHBOARD_HTML.encode()


def _keys(obj):
    """The key structure of a JSON document (values dropped; a list by its
    first element)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


def _debug_docs(console_mod, metrics_mod, svc, log):
    """Every ``/debug/*`` route of a live console over one served request,
    bound to an ephemeral port on 127.0.0.1."""
    server = metrics_mod.MetricsServer(metrics_mod.MetricsRegistry(), host="127.0.0.1",
                                       port=0)
    console_mod.install_console(
        server, events=log, debug_requests=svc.debug_requests,
        replicas_fn=console_mod.single_service_replicas_feed(svc),
        cache_fn=console_mod.cache_feed(svc=svc))
    server.start()
    try:
        return {path: json.loads(_get(f"{server.url}{path}")[2])
                for path in ("/debug/requests?recent=5", "/debug/replicas",
                             "/debug/cache", "/debug/slo", "/debug/events?limit=5")}
    finally:
        server.stop()


def test_debug_routes_answer_with_the_reference_keys(mesh8):
    from repro.core import events as ref_events
    from repro.core import metrics as ref_metrics
    from repro.core.bfs import BFSConfig as RefConfig
    from repro.graph import generators as ref_gen
    from repro.graph import partition as ref_part
    from repro.service import GraphQueryService as RefService
    from repro.service import console as ref_console
    from repro_torch.core import metrics as port_metrics
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.graph import generators, partition
    from repro_torch.service import GraphQueryService
    from repro_torch.service import console as port_console

    docs = {}
    for side in ("ref", "port"):
        log = ref_events.EventLog() if side == "ref" else EventLog()
        if side == "ref":
            svc = RefService(ref_part.partition_1d(ref_gen.path_graph(96), 8), mesh8,
                             RefConfig(axes=("data",)), lanes=4, events=log)
            metrics_mod = ref_metrics
        else:
            svc = GraphQueryService(partition.partition_1d(generators.path_graph(96), 8),
                                    "cpu", BFSConfig(), lanes=4, events=log)
            metrics_mod = port_metrics
        try:
            svc.query("bfs", 3, timeout=120)
            svc.query("bfs", 3, timeout=120)  # a cache hit: a request event
            docs[side] = _debug_docs(ref_console if side == "ref" else port_console,
                                     metrics_mod, svc, log)
        finally:
            svc.stop()
    assert _keys(docs["port"]) == _keys(docs["ref"])
    assert docs["port"]["/debug/requests?recent=5"]["recent"]
    assert docs["port"]["/debug/cache"] == docs["ref"]["/debug/cache"]
