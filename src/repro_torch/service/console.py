"""Live ops console over the metrics HTTP server (DESIGN.md §21).

Registers JSON debug endpoints plus one self-contained HTML dashboard on a
:class:`~repro_torch.core.metrics.MetricsServer` route table:

* ``/debug/requests``   — in-flight tickets + recent completions, each with
  its §18 ``trace_id`` (the metrics→trace pivot);
* ``/debug/replicas``   — per-replica health/lag table (§17);
* ``/debug/cache``      — §15 result-cache counters (per replica when
  replicated);
* ``/debug/slo``        — §21 SLO compliance, burn rates, alert states;
* ``/debug/events``     — structured event-log slice; ``?trace_id=`` narrows
  to one request's story, ``?kind=`` to one subsystem's event class;
* ``/dashboard``        — one HTML page, zero external assets: live
  sparklines, SLO burn gauges, replica + request tables, all polled from
  the JSON endpoints above via relative URLs.

Everything here reads point-in-time snapshots; nothing holds service locks
across a request.  The console is wired by ``serve_graph`` but takes plain
callables, so tests drive it against toy stand-ins without a service.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def _one(query: Dict[str, list], key: str, default: str = "") -> str:
    vals = query.get(key)
    return vals[0] if vals else default


def _int(query: Dict[str, list], key: str, default: int) -> int:
    raw = _one(query, key)
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def console_routes(
    *,
    events,
    debug_requests: Optional[Callable[[int], Dict[str, Any]]] = None,
    replicas_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    cache_fn: Optional[Callable[[], Any]] = None,
    slo=None,
) -> Dict[str, Callable]:
    """Build the §21 route table.  ``events`` is an
    :class:`~repro_torch.core.events.EventLog`; the other feeds are optional —
    an absent feed answers with ``{"available": False}`` instead of 404 so
    the dashboard renders uniformly on partial deployments."""

    def r_requests(query):
        if debug_requests is None:
            return {"available": False, "inflight": [], "recent": []}
        out = debug_requests(_int(query, "recent", 50))
        out["available"] = True
        return out

    def r_replicas(query):
        if replicas_fn is None:
            return {"available": False, "replicas": []}
        out = replicas_fn()
        out["available"] = True
        return out

    def r_cache(query):
        if cache_fn is None:
            return {"available": False}
        out = cache_fn()
        if isinstance(out, dict):
            out = dict(out)
            out["available"] = True
        return out

    def r_slo(query):
        if slo is None:
            return {"available": False, "objectives": [], "alerts": []}
        return {"available": True, "objectives": slo.status(),
                "alerts": slo.alerts()}

    def r_events(query):
        trace_id = _one(query, "trace_id") or None
        kind = _one(query, "kind") or None
        subsystem = _one(query, "subsystem") or None
        limit = _int(query, "limit", 200)
        evs = events.query(trace_id=trace_id, kind=kind,
                           subsystem=subsystem, limit=limit)
        return {"count": len(evs), "trace_id": trace_id or "",
                "events": evs}

    def r_dashboard(query):
        return ("text/html; charset=utf-8", DASHBOARD_HTML)

    return {
        "/debug/requests": r_requests,
        "/debug/replicas": r_replicas,
        "/debug/cache": r_cache,
        "/debug/slo": r_slo,
        "/debug/events": r_events,
        "/dashboard": r_dashboard,
    }


def install_console(server, **feeds) -> None:
    """Attach the §21 console routes to a running
    :class:`~repro_torch.core.metrics.MetricsServer`."""
    for path, fn in console_routes(**feeds).items():
        server.add_route(path, fn)


def replicas_feed(router) -> Callable[[], Dict[str, Any]]:
    """``/debug/replicas`` feed for the §17 replicated path."""

    def fn():
        head = router.latest_seq
        rows = []
        for r in router.replicas:
            snap = r.snapshot()
            snap["lag"] = max(0, int(head) - int(snap["applied_seq"]))
            rows.append(snap)
        return {"head_seq": int(head), "replicas": rows,
                "n_serving": sum(1 for s in rows
                                 if s["state"] != "DEAD")}

    return fn


def single_service_replicas_feed(svc) -> Callable[[], Dict[str, Any]]:
    """``/debug/replicas`` feed when serving without replication — one
    synthetic always-healthy row keeps the dashboard shape uniform."""

    def fn():
        return {"head_seq": 0, "n_serving": 1, "replicas": [
            {"id": 0, "state": "HEALTHY", "applied_seq": 0, "lag": 0,
             "kills": 0, "recoveries": 0, "serving": True}]}

    return fn


def cache_feed(router=None, svc=None) -> Callable[[], Dict[str, Any]]:
    """``/debug/cache`` feed: per-replica §15 cache counters, or the
    single service's."""

    def fn():
        if router is not None:
            return {"caches": [
                {"replica": r.id, **r.svc.cache.snapshot()}
                for r in router.replicas]}
        return {"caches": [{"replica": 0, **svc.cache.snapshot()}]}

    return fn


# ---------------------------------------------------------------------------
# the dashboard page — a single self-contained document, no external assets
# ---------------------------------------------------------------------------

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>repro ops console</title>
<style>
  body { font: 13px/1.45 ui-monospace, monospace; margin: 0;
         background: #11151a; color: #cdd6e0; }
  h1 { font-size: 15px; margin: 0; padding: 10px 14px;
       background: #182029; border-bottom: 1px solid #26303b; }
  h1 small { color: #6b7a89; font-weight: normal; }
  h2 { font-size: 13px; color: #8ab4d8; margin: 0 0 6px 0; }
  .grid { display: grid; grid-template-columns: 1fr 1fr; gap: 12px;
          padding: 12px 14px; }
  .card { background: #161c23; border: 1px solid #26303b;
          border-radius: 6px; padding: 10px 12px; overflow-x: auto; }
  .wide { grid-column: 1 / -1; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: 2px 10px 2px 0;
           border-bottom: 1px solid #1f2831; white-space: nowrap; }
  th { color: #6b7a89; font-weight: normal; }
  .ok      { color: #6fce8f; }
  .warn    { color: #e8c06a; }
  .bad     { color: #e87a6a; }
  .dim     { color: #6b7a89; }
  .gauge { background: #0d1117; border-radius: 3px; height: 10px;
           width: 160px; display: inline-block; vertical-align: middle; }
  .gauge i { display: block; height: 100%; border-radius: 3px;
             background: #6fce8f; }
  .gauge i.hot { background: #e87a6a; }
  svg.spark { vertical-align: middle; }
  a, .tid { color: #8ab4d8; text-decoration: none; cursor: pointer; }
  pre { margin: 6px 0 0 0; max-height: 240px; overflow: auto;
        color: #9aa8b6; }
  .pill { padding: 0 6px; border-radius: 8px; background: #1f2831; }
</style>
</head>
<body>
<h1>repro ops console
  <small id="meta">polling /debug/* every 2s &mdash; all data local</small>
</h1>
<div class="grid">
  <div class="card"><h2>SLO burn</h2><div id="slo">loading&hellip;</div></div>
  <div class="card"><h2>replicas</h2><div id="replicas">loading&hellip;</div></div>
  <div class="card"><h2>requests
      <span class="dim">(inflight sparkline)</span>
      <svg id="spark-inflight" class="spark" width="120" height="16"></svg>
    </h2><div id="requests">loading&hellip;</div></div>
  <div class="card"><h2>cache</h2><div id="cache">loading&hellip;</div></div>
  <div class="card wide"><h2>events
      <span class="dim" id="evmeta"></span></h2>
    <div id="events">click a trace id above to slice the event log</div></div>
</div>
<script>
"use strict";
const hist = { inflight: [], burn: [] };
const MAXH = 60;

function esc(s) {
  return String(s).replace(/[&<>"]/g,
    c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
}

function spark(el, series, color) {
  const w = el.getAttribute("width"), h = el.getAttribute("height");
  if (!series.length) { el.innerHTML = ""; return; }
  const max = Math.max(...series, 1e-9);
  const pts = series.map((v, i) =>
    `${(i / Math.max(series.length - 1, 1) * w).toFixed(1)},` +
    `${(h - v / max * (h - 2) - 1).toFixed(1)}`).join(" ");
  el.innerHTML = `<polyline points="${pts}" fill="none"` +
                 ` stroke="${color}" stroke-width="1.2"/>`;
}

function gauge(frac) {
  const pct = Math.min(frac, 1) * 100;
  const hot = frac >= 1 ? " class=hot" : "";
  return `<span class=gauge><i${hot} style="width:${pct.toFixed(1)}%"></i>` +
         `</span>`;
}

function stateCls(s) {
  return {FIRING: "bad", PENDING: "warn", RESOLVED: "ok", INACTIVE: "dim",
          HEALTHY: "ok", SUSPECT: "warn", DEAD: "bad", RECOVERING: "warn"
         }[s] || "";
}

function tid(t) {
  return t ? `<span class=tid onclick="slice('${esc(t)}')">${esc(t)}</span>`
           : `<span class=dim>-</span>`;
}

async function j(url) { const r = await fetch(url); return r.json(); }

async function slice(traceId) {
  const d = await j(`/debug/events?trace_id=${traceId}&limit=200`);
  document.getElementById("evmeta").textContent =
    `trace ${traceId}: ${d.count} events`;
  document.getElementById("events").innerHTML =
    `<pre>${esc(d.events.map(e =>
      `${e.seq}\\t${e.kind}/${e.name}\\t${e.subsystem}\\t` +
      JSON.stringify(e.args)).join("\\n"))}</pre>`;
}

async function tick() {
  try {
    const [slo, reps, reqs, cache] = await Promise.all([
      j("/debug/slo"), j("/debug/replicas"),
      j("/debug/requests"), j("/debug/cache")]);

    let rows = "";
    let maxBurn = 0;
    for (const o of (slo.objectives || [])) {
      for (const a of (o.alerts || [])) {
        maxBurn = Math.max(maxBurn, a.burn_short / a.burn_threshold);
        rows += `<tr><td>${esc(o.name)}</td><td>${esc(a.rule)}</td>` +
          `<td class="${stateCls(a.state)}">${a.state}</td>` +
          `<td>${gauge(a.burn_short / a.burn_threshold)} ` +
          `${a.burn_short.toFixed(2)}x / ${a.burn_threshold}x</td>` +
          `<td>${(o.compliance * 100).toFixed(2)}%</td>` +
          `<td>${tid(a.exemplar && a.exemplar.trace_id)}</td></tr>`;
      }
    }
    hist.burn.push(maxBurn); if (hist.burn.length > MAXH) hist.burn.shift();
    document.getElementById("slo").innerHTML = slo.available && rows
      ? `<table><tr><th>slo</th><th>rule</th><th>state</th>` +
        `<th>burn (short)</th><th>compliance</th><th>exemplar</th></tr>` +
        rows + `</table>`
      : `<span class=dim>no SLO config loaded (--slo-config)</span>`;

    rows = "";
    for (const r of (reps.replicas || [])) {
      rows += `<tr><td>${r.id}</td>` +
        `<td class="${stateCls(r.state)}">${r.state}</td>` +
        `<td>${r.applied_seq}</td><td>${r.lag}</td>` +
        `<td>${r.kills ?? 0}</td><td>${r.recoveries ?? 0}</td></tr>`;
    }
    document.getElementById("replicas").innerHTML =
      `<div class=dim>head_seq ${reps.head_seq ?? 0} &middot; ` +
      `${reps.n_serving ?? 0} serving</div>` +
      `<table><tr><th>id</th><th>state</th><th>applied</th><th>lag</th>` +
      `<th>kills</th><th>recov</th></tr>${rows}</table>`;

    const inflight = reqs.inflight || [];
    hist.inflight.push(inflight.length);
    if (hist.inflight.length > MAXH) hist.inflight.shift();
    spark(document.getElementById("spark-inflight"), hist.inflight,
          "#8ab4d8");
    rows = "";
    for (const t of inflight.slice(0, 8)) {
      rows += `<tr><td>${esc(t.algo)}</td><td>${t.root}</td>` +
        `<td>${t.age_ms.toFixed(0)}ms</td><td>${t.attempts}</td>` +
        `<td>${tid(t.trace_id)}</td></tr>`;
    }
    for (const e of (reqs.recent || []).slice(-8).reverse()) {
      const cls = e.name === "completed" ? "ok" : "bad";
      rows += `<tr class=dim><td class="${cls}">${esc(e.name)}</td>` +
        `<td colspan=2>${esc((e.args && e.args.algo) || "")}</td>` +
        `<td>${e.args && e.args.latency_ms != null ?
               e.args.latency_ms.toFixed(1) + "ms" : ""}</td>` +
        `<td>${tid(e.trace_id)}</td></tr>`;
    }
    document.getElementById("requests").innerHTML =
      `<table><tr><th>algo</th><th>root</th><th>age/lat</th>` +
      `<th>att</th><th>trace</th></tr>${rows}</table>`;

    rows = "";
    for (const c of (cache.caches || [])) {
      rows += `<tr><td>${c.replica}</td><td>${c.size}/${c.capacity}</td>` +
        `<td>${(c.hit_rate * 100).toFixed(1)}%</td>` +
        `<td>${c.evictions}</td><td>${c.stale_dropped}</td></tr>`;
    }
    document.getElementById("cache").innerHTML =
      `<table><tr><th>replica</th><th>size</th><th>hit rate</th>` +
      `<th>evict</th><th>stale</th></tr>${rows}</table>`;
  } catch (e) {
    document.getElementById("meta").textContent = `poll failed: ${e}`;
  }
}
tick();
setInterval(tick, 2000);
</script>
</body>
</html>
"""
