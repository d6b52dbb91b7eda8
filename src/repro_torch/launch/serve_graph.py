"""Graph-query serving CLI (DESIGN.md §15), on PyTorch.

``python -m repro_torch.launch.serve_graph --scale 12 --ranks 8 --duration 5``

The port of ``repro.launch.serve_graph``, every flag kept; the
reference's ``--devices`` is ``--ranks`` (P simulated ranks on one
device, as the port's ``bfs_run`` names them) and ``--device`` picks the
device (the card unless ``--device cpu``).  Builds a graph, 1D-partitions
it over the simulated ranks, starts a
:class:`~repro_torch.service.GraphQueryService`, and drives it with a built-in
open-loop load (mixed ``bfs``/``closeness`` root queries at ``--qps``,
per-request ``--deadline-ms``); on exit it prints — and with
``--stats-json`` persists — the full telemetry snapshot (p50/p95/p99
latency, QPS, wave occupancy, cache hit rate) alongside the engine stats,
using the ``bfs_run`` stats schema extended with a ``telemetry`` block.

``--swap-after N`` swaps in a fresh graph (new seed) after ``N`` requests
to exercise the epoch-bump invalidation path under live traffic.

``--mutate-rate R`` injects ``R`` random edge-mutation batches per second
of offered load into the open-loop load (``--mutate-edges`` inserts and
``--mutate-delete-frac`` of that many deletions each) through
``GraphQueryService.apply_updates`` — the §16 streaming path: the
partition is patched in place, cached rows are proven-unchanged /
repaired / dropped per batch, and the report adds the
partial-invalidation hit-rate (surviving-row fraction) next to the
existing telemetry.  ``--record-updates PATH`` persists the injected
batches as a JSONL stream replayable by ``bfs_run --updates``.

``--replicas N`` serves through N independent engine replicas behind the
§17 version-aware router: mutations fan out through the replication log
with read-your-writes ``min_seq``, failures fail over, and the stats gain
a ``faults`` telemetry block (injected faults, retries, hedges,
failovers, recoveries, shed, stale serves — zeroed on the single-service
path so the ``--stats-json`` schema is uniform).  ``--chaos SPEC`` arms
the deterministic fault injector (``--chaos-seed`` fixes the victim
draws), e.g. ``--chaos 'kill-one@op=20;corrupt-batch@batch=2'``.

The §21 ops plane rides on top: ``--events PATH`` streams the structured
event log (``ops_events/v1`` JSONL, validate with ``python -m
repro_torch.core.events``); ``--slo-config PATH`` loads declarative SLOs and
evaluates Google-SRE multi-window burn-rate alerts live, folding the
machine-readable verdict into ``--stats-json`` (schema
``serve_graph_stats/v2``) and, with ``--slo-verdict PATH``, its own JSON;
``--metrics-port`` additionally serves the live console
(``/debug/requests|replicas|cache|slo|events`` + ``/dashboard``);
``--dashboard-html PATH`` saves the self-contained dashboard page as a CI
artifact.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=8,
                    help="simulated ranks P (the leading tensor axis)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--sync", default="adaptive",
                    choices=["butterfly", "sparse", "adaptive", "rabenseifner",
                             "all_to_all", "xla"])
    ap.add_argument("--lanes", type=int, default=32,
                    help="wave width (bit-lanes per MS-BFS wave)")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="offered open-loop arrival rate")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="seconds of offered load")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; 0 = best-effort")
    ap.add_argument("--linger-ms", type=float, default=5.0,
                    help="max wave linger before a partial dispatch")
    ap.add_argument("--cache-capacity", type=int, default=1024)
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="admission-control queue bound")
    ap.add_argument("--algos", default="bfs,closeness",
                    help="comma list drawn per request: traversals "
                         "(bfs,closeness,sssp,bc) and/or §19 vertex "
                         "programs (pagerank,cc,tri,kcore — root-free; "
                         "each gets its own single-result wave class)")
    ap.add_argument("--hot-fraction", type=float, default=0.2,
                    help="fraction of requests hitting one hot root "
                         "(exercises dedup + the result cache)")
    ap.add_argument("--swap-after", type=int, default=0,
                    help="swap in a reseeded graph after N requests "
                         "(exercises epoch invalidation); 0 = never")
    ap.add_argument("--mutate-rate", type=float, default=0.0,
                    help="edge-mutation batches per second of offered load "
                         "injected into it (0 = static graph)")
    ap.add_argument("--mutate-edges", type=int, default=16,
                    help="undirected edge inserts per mutation batch")
    ap.add_argument("--mutate-delete-frac", type=float, default=0.25,
                    help="deletions per batch as a fraction of "
                         "--mutate-edges")
    ap.add_argument("--record-updates", default=None, metavar="PATH",
                    help="persist injected mutation batches as a JSONL "
                         "stream (replay with `bfs_run --updates PATH`)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through N independent engine replicas "
                         "behind the §17 version-aware router")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault-injection spec, e.g. "
                         "'kill-one@op=20;corrupt-batch@batch=2' "
                         "(requires --replicas > 1 to stay available)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seed for fault victim draws (default: --seed)")
    ap.add_argument("--router-timeout-s", type=float, default=30.0,
                    help="router per-request budget before the hedged "
                         "duplicate fires (replicated path only); lower it "
                         "with a stall chaos spec to see the hedge in a "
                         "short --trace run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the §20 metrics registry over HTTP while "
                         "the load runs: GET /metrics is Prometheus text "
                         "exposition, GET /healthz reports per-replica "
                         "health state and replication lag (0 = pick a "
                         "free port; printed at startup)")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append a JSONL snapshot of every registry series "
                         "at exit (machine-readable metrics artifact)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="dump telemetry + engine stats as JSON "
                         "(serve_graph_stats/v2; adds an `slo` block when "
                         "--slo-config is active)")
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="stream the §21 structured event log as "
                         "ops_events/v1 JSONL (validate: python -m "
                         "repro_torch.core.events PATH --schema "
                         "tests/event_schema.json)")
    ap.add_argument("--slo-config", default=None, metavar="PATH",
                    help="slo_config/v1 JSON: declarative SLOs evaluated "
                         "live with multi-window burn-rate alerting")
    ap.add_argument("--slo-verdict", default=None, metavar="PATH",
                    help="write the slo_verdict/v1 JSON at exit (assert "
                         "with python -m repro_torch.core.slo)")
    ap.add_argument("--dashboard-html", default=None, metavar="PATH",
                    help="save the self-contained /dashboard page (no "
                         "server needed; CI uploads it as an artifact)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="export a §18 cross-stack request trace as "
                         "Perfetto/Chrome trace_event JSON (load at "
                         "ui.perfetto.dev); FILE.jsonl gets the raw "
                         "event stream")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.swap_after and args.replicas > 1:
        ap.error("--swap-after is a single-service path; use mutations "
                 "(--mutate-rate) with --replicas")

    import torch

    # On the CPU the waves (one at a time under the device lock) are many
    # small ops, so intra-op threads only add barriers; on a loaded host a
    # descheduled thread stalls every op at its barrier, waves slow by an
    # order of magnitude, organic latency passes --router-timeout-s, and
    # the hedges put every replica on backoff, so a chaos stall's hedge
    # finds none to go to.  The CPU path runs one thread, restored on exit.
    threads = torch.get_num_threads()
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    try:
        return _serve(ap, args)
    finally:
        torch.set_num_threads(threads)


def fault_exemplar(events, first_seq: int = 0):
    """Exemplar picker for the availability and staleness SLOs: the newest
    request a fault was injected on, i.e. the trace of the newest
    ``chaos`` event the injection itself stamped (``kill-replica``,
    ``stall-wave``), which holds the hedge or failover the fault forced;
    else the newest traced ``chaos`` or ``retry`` event (a ``kill-impact``,
    a retry of organic degradation).  Events before ``first_seq`` (another
    run's, in a process-wide log) are never picked.

    The reference takes the newest ``chaos`` event.  A killed replica's
    abandoned scheduler fails the requests it held a few ms after the
    kill, so their ``kill-impact`` events can land after a ``stall-wave``
    on the same op and take the exemplar from the stalled request, whose
    trace alone holds the hedge."""

    def pick():
        fallback = None
        for ev in reversed(events.events()):
            if ev["seq"] < first_seq:
                break
            if not ev["trace_id"] or ev["kind"] not in ("chaos", "retry"):
                continue
            if ev["kind"] == "chaos" and ev["name"] != "kill-impact":
                return {"trace_id": ev["trace_id"], "source": f"event:chaos:{ev['name']}"}
            if fallback is None or (fallback["kind"] == "retry" and ev["kind"] == "chaos"):
                fallback = ev
        if fallback is None:
            return None
        return {"trace_id": fallback["trace_id"],
                "source": f"event:{fallback['kind']}:{fallback['name']}"}

    return pick


def _serve(ap, args) -> int:
    import json
    import time

    import numpy as np
    import torch

    from repro_torch.core import bfs
    from repro_torch.graph import csr, generators, partition
    from repro_torch.service import (
        AdmissionError,
        FaultInjector,
        GraphQueryService,
        Replica,
        ReplicaRouter,
        RouterTelemetry,
    )

    def build(seed):
        g = generators.kronecker(args.scale, args.edge_factor, seed=seed)
        return g, partition.partition_1d(g, args.ranks)

    from repro_torch.core import events as events_mod
    from repro_torch.core.tracing import NULL_TRACER, Tracer

    tracer = Tracer() if args.trace else NULL_TRACER
    event_log = events_mod.default_event_log()
    first_seq = event_log.snapshot()["emitted"] + 1  # this run's events
    if args.events:
        event_log.attach_sink(args.events)

    dev = bfs.resolve_device(args.device)
    where = (f"{args.ranks} simulated ranks on "
             f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    g, pg = build(args.seed)
    print(f"graph: n={g.n_real:,} m={g.n_edges:,}")
    cfg = bfs.BFSConfig(fanout=args.fanout, sync=args.sync)
    algos = [a.strip() for a in args.algos.split(",") if a.strip()]
    from repro_torch.service.queue import ALGOS as _ALGOS

    bad = [a for a in algos if a not in _ALGOS]
    if bad:
        ap.error(f"--algos {bad} not servable; expected from {_ALGOS}")

    service_kw = dict(
        cache_capacity=args.cache_capacity, max_pending=args.max_pending,
        max_linger_s=args.linger_ms / 1e3,
        default_deadline_s=(args.deadline_ms / 1e3) or None,
    )
    rng = np.random.default_rng(args.seed)
    hot = csr.largest_component_root(g, rng)
    replicated = args.replicas > 1 or args.chaos is not None
    router = injector = None
    if replicated:
        replicas = [
            Replica(i, g, args.ranks, cfg, device=dev, lanes=args.lanes,
                    n_real=g.n_real, service_kw=dict(service_kw),
                    tracer=tracer if args.trace else None)
            for i in range(args.replicas)
        ]
        for r in replicas:  # warmup before measuring
            r.submit("bfs", hot).result(600.0)
            r.svc.reset_telemetry()
        tracer.clear()  # warmup spans must not pollute the exported trace
        injector = FaultInjector.from_spec(
            args.chaos,
            args.seed if args.chaos_seed is None else args.chaos_seed,
            args.replicas,
        )
        router = ReplicaRouter(replicas, injector=injector,
                               timeout_s=args.router_timeout_s,
                               tracer=tracer if args.trace else None)
        svc = replicas[0].svc  # overlay source for sampled batches
        if args.chaos:
            print(f"chaos: {args.chaos} -> "
                  f"{json.dumps(injector.schedule_json())}")
    else:
        svc = GraphQueryService(
            pg, dev, cfg, lanes=args.lanes, n_real=g.n_real,
            tracer=tracer if args.trace else None, **service_kw
        )
        svc.query("bfs", hot)  # warmup
        svc.reset_telemetry()  # builds must not pollute measured latency
        tracer.clear()  # same for the exported trace
    print(f"serving: replicas={args.replicas} lanes={args.lanes} "
          f"sync={args.sync} linger={args.linger_ms}ms qps={args.qps} "
          f"deadline={args.deadline_ms or 'none'}ms")

    slo_mgr = None
    if args.slo_config:
        from repro_torch.core import metrics as metrics_mod
        from repro_torch.core import slo as slo_mod

        reg = metrics_mod.default_registry()
        slo_config = slo_mod.load_config(args.slo_config)

        def source_for(obj):
            if obj.type == "latency":
                if replicated:
                    return slo_mod.latency_threshold_source(
                        reg, "router_latency_ms", obj.threshold_ms)
                return slo_mod.latency_threshold_source(
                    reg, "service_latency_ms", obj.threshold_ms,
                    {"stage": "total"})
            if obj.type == "staleness":
                if replicated:
                    return slo_mod.counter_events_source(
                        reg, "router_events_total",
                        good=("completed",), bad=("stale_serves",))
                return lambda: (0.0, 0.0)  # no degraded path to go stale
            # availability = served cleanly: a retry/hedge/stale fallback
            # burns budget even when the client future still succeeds
            if replicated:
                return slo_mod.counter_events_source(
                    reg, "router_events_total",
                    good=("completed",),
                    bad=("failed", "retries", "hedges", "stale_serves"))
            return slo_mod.counter_events_source(
                reg, "service_events_total",
                good=("completed",),
                bad=("failed", "expired", "deadline_misses"))

        def exemplar_for(obj):
            if obj.type == "latency":
                return slo_mod.histogram_exemplar(
                    reg, "router_latency_ms" if replicated
                    else "service_latency_ms")
            # chaos-first: when a fault was injected, the exemplar is the
            # request the fault hit (its trace holds kill + hedge); retry
            # events cover organic degradation without chaos
            return fault_exemplar(event_log, first_seq)

        slo_mgr = slo_mod.build_from_config(
            slo_config, source_for, exemplar_for, events=event_log)
        print(f"slo: {len(slo_mgr.trackers)} objectives, "
              f"time_scale={slo_config.get('time_scale', 1.0)} "
              f"({args.slo_config})")

    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.core import metrics as metrics_mod

        def health_fn():
            if replicated:
                head = router.latest_seq
                reps = [
                    {"replica": r.id, "state": r.state,
                     "applied_seq": int(r.applied_seq),
                     "lag": max(0, head - int(r.applied_seq))}
                    for r in router.replicas
                ]
                serving = sum(1 for r in reps if r["state"] != "DEAD")
                return {"status": "ok" if serving else "unavailable",
                        "head_seq": int(head), "replicas": reps}
            return {"status": "ok", "replicas": [
                {"replica": 0, "state": "HEALTHY", "applied_seq": 0,
                 "lag": 0}]}

        metrics_server = metrics_mod.MetricsServer(
            metrics_mod.default_registry(), port=args.metrics_port,
            health_fn=health_fn,
        )
        metrics_server.start()
        print(f"metrics: {metrics_server.url}/metrics  "
              f"{metrics_server.url}/healthz")

        from repro_torch.service import console as console_mod

        if replicated:
            console_mod.install_console(
                metrics_server, events=event_log,
                debug_requests=router.debug_requests,
                replicas_fn=console_mod.replicas_feed(router),
                cache_fn=console_mod.cache_feed(router=router),
                slo=slo_mgr)
        else:
            console_mod.install_console(
                metrics_server, events=event_log,
                debug_requests=svc.debug_requests,
                replicas_fn=console_mod.single_service_replicas_feed(svc),
                cache_fn=console_mod.cache_feed(svc=svc),
                slo=slo_mgr)
        print(f"console: {metrics_server.url}/dashboard")

    n = max(int(args.qps * args.duration), 1)
    futs = []
    rejected = 0
    batches = []  # injected mutation batches (for --record-updates)
    n_mut = 0
    min_seq = router.latest_seq if replicated else 0
    slo_tick_s = 0.05  # burn-rate evaluation cadence while driving load
    next_slo = 0.0
    t0 = time.perf_counter()
    for i in range(n):
        if slo_mgr is not None:
            nowm = time.monotonic()
            if nowm >= next_slo:
                slo_mgr.tick(nowm)
                next_slo = nowm + slo_tick_s
        target = t0 + i / args.qps
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        if args.swap_after and i == args.swap_after:
            g, pg = build(args.seed + 1)
            epoch = svc.swap_graph(pg, n_real=g.n_real)
            print(f"  [swapped graph at request {i} -> epoch {epoch}]")
        if args.mutate_rate > 0:
            # batches fall due on the offered load's schedule (request i
            # at i / qps), as requests do: on the wall clock, a batch that
            # costs more than 1 / rate seconds makes more batches due than
            # it applies, and the run never ends
            due = int(i / args.qps * args.mutate_rate)
            while n_mut < due:
                batch = svc.overlay.sample_batch(
                    rng, args.mutate_edges,
                    int(args.mutate_edges * args.mutate_delete_frac),
                )
                batches.append(batch)
                if replicated:  # replication log: fan out + read-your-writes
                    min_seq = router.apply_updates(batch)
                else:
                    svc.apply_updates(batch)
                n_mut += 1
        root = (hot if rng.random() < args.hot_fraction
                else int(rng.integers(0, g.n_real)))
        try:
            if replicated:
                futs.append(router.submit(algos[i % len(algos)], root,
                                          min_seq=min_seq))
            else:
                futs.append(svc.submit(algos[i % len(algos)], root))
        except AdmissionError:
            rejected += 1
    ok = err = stale = 0
    for f in futs:
        try:
            res = f.result(timeout=600)
            ok += 1
            if replicated and res.stale:
                stale += 1
        except Exception:
            err += 1
    elapsed = time.perf_counter() - t0
    slo_verdict = None
    if slo_mgr is not None:
        # final ticks AFTER every future resolved: the closing evaluation
        # sees all retries/hedges, and a PENDING alert gets its chance to
        # cross its hold-down into FIRING
        nowm = time.monotonic()
        slo_mgr.tick(nowm)
        slo_mgr.tick(nowm + slo_tick_s)
        slo_verdict = slo_mgr.verdict()
        fired = [a for a in slo_verdict["alerts"] if a["fired_count"] > 0]
        print(f"slo: ok={slo_verdict['ok']} "
              f"any_fired={slo_verdict['any_fired']}" + "".join(
                  f"  [{a['severity']}] {a['slo']}/{a['rule']} "
                  f"{a['state']} burn={a['burn_short']:.2f}x"
                  + (f" exemplar={a['exemplar']['trace_id']}"
                     if a.get("exemplar") else "")
                  for a in fired))

    if replicated:
        snap = router.snapshot()
    else:
        snap = svc.snapshot()
        # uniform --stats-json schema: the single-service path reports a
        # zeroed §17 faults block (nothing injected, nothing to fail over)
        snap["faults"] = RouterTelemetry().faults_block(injector)
    lat = snap["latency_ms"]
    if replicated:
        fb = snap["faults"]
        print(
            f"{ok}/{n} served in {elapsed:.2f}s ({ok/elapsed:.1f} QPS; "
            f"{rejected} rejected, {err} failed, {stale} stale)  "
            f"p50 {lat['p50']:.1f}ms  p95 {lat['p95']:.1f}ms  "
            f"p99 {lat['p99']:.1f}ms  replicas "
            f"{snap['n_serving']}/{args.replicas} serving "
            f"({where})"
        )
        print(
            f"faults: injected {sum(fb['injected'].values())}  "
            f"retries {fb['retries']}  hedges {fb['hedges']}  "
            f"failovers {fb['failovers']}  recoveries {fb['recoveries']}  "
            f"shed {fb['shed']}  stale serves {fb['stale_serves']}  "
            f"catch-up batches {fb['catch_up_batches']}"
        )
    else:
        print(
            f"{ok}/{n} served in {elapsed:.2f}s ({ok/elapsed:.1f} QPS; "
            f"{rejected} rejected, {err} failed/expired)  "
            f"p50 {lat['p50']:.1f}ms  p95 {lat['p95']:.1f}ms  "
            f"p99 {lat['p99']:.1f}ms  occupancy {snap['wave_occupancy']:.2f}  "
            f"cache hit-rate {snap['cache']['hit_rate']:.2f} "
            f"({where})"
        )
    if n_mut and not replicated:
        mut = snap["mutations"]
        print(
            f"mutations: {mut['batches']} batches "
            f"({mut['compactions']} compactions)  cached rows "
            f"{mut['rows_kept']} kept / {mut['rows_repaired']} repaired / "
            f"{mut['rows_dropped']} dropped  partial-invalidation "
            f"hit-rate {mut['survival_rate']:.2f}"
        )
    if args.record_updates and batches:
        from repro_torch.dynamic import delta

        delta.write_update_stream(args.record_updates, batches)
        print(f"update stream ({len(batches)} batches) -> "
              f"{args.record_updates}")
    if args.stats_json:
        from repro_torch.launch.bfs_run import write_stats_json

        # serve_graph_stats/v2 = v1 plus the optional `slo` block; every
        # v1 key keeps its name and shape, so v1 readers keep working
        write_stats_json(
            args.stats_json, algo="service",
            graph={"name": "kronecker", "scale": args.scale,
                   "edge_factor": args.edge_factor, "n": g.n,
                   "n_real": g.n_real, "n_edges": g.n_edges,
                   "weighted": bool(g.weighted)},
            devices=args.ranks,
            config={"sync": args.sync, "mode": cfg.mode,
                    "fanout": args.fanout, "lanes": args.lanes,
                    # the schema's keys; the waves' merges launch
                    # bitmap_or_reduce on the card all the same
                    "delta": 0, "max_weight": 0, "use_pallas": False,
                    "replicas": args.replicas,
                    "chaos": args.chaos or ""},
            timing_ms={"mean": lat["mean"], "total": elapsed * 1e3},
            engine_stats=svc.engine.stats,
            telemetry=snap,
            schema="serve_graph_stats/v2",
            slo=slo_verdict,
        )
        print(f"stats -> {args.stats_json}")
    if args.slo_verdict:
        if slo_verdict is None:
            print("slo-verdict requested without --slo-config; skipping",
                  file=sys.stderr)
        else:
            with open(args.slo_verdict, "w") as f:
                json.dump(slo_verdict, f, indent=1)
            print(f"slo verdict -> {args.slo_verdict}")
    if args.dashboard_html:
        from repro_torch.service.console import DASHBOARD_HTML

        with open(args.dashboard_html, "w") as f:
            f.write(DASHBOARD_HTML)
        print(f"dashboard -> {args.dashboard_html}")
    if args.metrics_jsonl:
        from repro_torch.core import metrics as metrics_mod

        n_series = metrics_mod.default_registry().write_jsonl(
            args.metrics_jsonl)
        print(f"metrics snapshot ({n_series} series) -> "
              f"{args.metrics_jsonl}")
    if metrics_server is not None:
        metrics_server.stop()
    if replicated:
        router.stop()
    else:
        svc.stop()
    if args.events:
        event_log.close_sink()
        print(f"event log ({len(event_log)} resident, "
              f"{event_log.snapshot()['emitted']} emitted) -> {args.events}")
    if args.trace:
        n_ev = tracer.write_chrome(args.trace)
        tracer.write_jsonl(args.trace + "l")  # FILE.json -> FILE.jsonl
        print(f"trace ({n_ev} events) -> {args.trace} "
              f"(Perfetto/chrome://tracing) + {args.trace}l")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
