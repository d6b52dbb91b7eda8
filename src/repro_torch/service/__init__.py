"""Async graph-query serving on the butterfly engine (DESIGN.md §15).

The port of ``repro.service``: where the reference takes a mesh, the
service takes a ``device`` (the card unless the caller asks for the CPU)
and the partition's P ranks are simulated on it.  The repo's first
subsystem whose unit of work is a REQUEST STREAM rather
than a fixed batch: callers submit single-root queries (``bfs`` /
``closeness`` / ``sssp`` / ``bc``) or graph-global §19 vertex-program
queries (``pagerank`` / ``cc`` / ``tri`` / ``kcore`` — the root argument
is normalized to 0, every rider shares one converged result per epoch)
with optional deadlines and get
:class:`concurrent.futures.Future`\\ s back; a background wave scheduler
coalesces compatible requests into full-width §13 lane waves against the
batched :class:`~repro_torch.analytics.engine.BFSQueryEngine`.

    queue  →  scheduler  →  engine  →  cache
      │           │            │          │
  admission   deadline /   compiled    epoch-keyed
  control     linger wave  §13/§14     LRU results
              formation    programs

Layers (one module each):

* :mod:`repro_torch.service.queue`     — thread-safe submission + admission control,
* :mod:`repro_torch.service.scheduler` — deadline-aware wave formation + dedup,
* :mod:`repro_torch.service.cache`     — bounded LRU keyed ``(epoch, algo, cfg, root)``,
* :mod:`repro_torch.service.telemetry` — p50/p95/p99, QPS, occupancy, hit rate.

Epoch contract: every result is computed, cached, and delivered under the
:class:`~repro_torch.dynamic.versioning.GraphVersion` current AT DISPATCH;
:meth:`GraphQueryService.swap_graph` bumps the epoch atomically with the
engine swap, so a reloaded graph can never serve levels computed under
its predecessor.  :meth:`GraphQueryService.apply_updates` (DESIGN.md §16)
is the surgical mutation path: an in-place edge-delta bumps only
``delta_seq`` and cached rows are proven-unchanged/repaired instead of
cold-started; an identity swap is free.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from repro_torch.analytics import measures
from repro_torch.core import events as events_mod
from repro_torch.core.tracing import NULL_TRACER
from repro_torch import programs as programs_mod
from repro_torch.analytics.engine import BFSQueryEngine, compiled_program_fn
from repro_torch.core.bfs import BFSConfig, resolve_device
from repro_torch.dynamic import delta as delta_mod
from repro_torch.dynamic import repair as repair_mod
from repro_torch.dynamic import versioning
from repro_torch.dynamic.versioning import GraphVersion, InvalidationStats  # noqa: F401
from repro_torch.graph import partition as partition_mod
from repro_torch.service.cache import ResultCache, result_key
from repro_torch.service.queue import (  # noqa: F401  (public API re-exports)
    ALGOS,
    PROGRAM_ALGOS,
    AdmissionError,
    DeadlineExceeded,
    QueryRequest,
    ServiceStopped,
    SubmissionQueue,
    resolve_future,
)
from repro_torch.service.scheduler import WAVE_CLASS, WaveScheduler  # noqa: F401
from repro_torch.service.telemetry import Telemetry
from repro_torch.traversal.sssp import SSSPConfig


class GraphQueryService:
    """Asynchronous deadline-aware graph-query service.

    ::

        svc = GraphQueryService(pg, "cuda", cfg, lanes=32)
        fut = svc.submit("bfs", root=7, deadline_s=0.1)
        dist = fut.result()        # int64[n] levels
        svc.stop()

    ``coalesce=False`` degrades to one-request-per-wave dispatch (the §15
    benchmark baseline).  ``cache_capacity=0`` disables the result cache.
    """

    def __init__(
        self,
        pg,
        device="cuda",
        cfg: BFSConfig = BFSConfig(),
        *,
        lanes: int = 32,
        n_real: Optional[int] = None,
        sssp_cfg: Optional[SSSPConfig] = None,
        max_pending: int = 1024,
        cache_capacity: int = 1024,
        max_linger_s: float = 0.005,
        default_deadline_s: Optional[float] = None,
        coalesce: bool = True,
        start: bool = True,
        compact_ratio: float = 0.25,
        repair_budget: Optional[int] = None,
        tracer=None,
        events=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        # §18 request tracing: a shared repro_torch.core.tracing.Tracer (one per
        # process, possibly shared across replicas) or the no-op default
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.lanes = lanes
        self.n_real = int(n_real) if n_real is not None else pg.n
        self.default_deadline_s = default_deadline_s
        self.swap_lock = threading.RLock()
        # (version, engine) swapped as ONE tuple so readers always see a
        # consistent pair without taking the swap lock
        self._state: Tuple[GraphVersion, BFSQueryEngine] = (
            GraphVersion(), BFSQueryEngine(pg, cfg, lanes=lanes,
                                         device=self.device)
        )
        self._sssp_cfg = sssp_cfg
        self._vp_cfg = None  # §19 knobs, derived from the engine cfg
        # streaming mutations (DESIGN.md §16): overlay built lazily from
        # the served partition on first apply_updates
        self.compact_ratio = compact_ratio
        self.repair_budget = repair_budget
        self._overlay: Optional[delta_mod.DeltaOverlay] = None
        # §21 structured event log (module default unless injected) —
        # admission rejects, scheduler decisions, waves, repairs, and
        # cache evictions land here stamped with the request's trace_id
        self.events = (events if events is not None
                       else events_mod.default_event_log())
        self.queue = SubmissionQueue(max_pending)
        self.cache = ResultCache(cache_capacity)
        self.telemetry = Telemetry()
        self.cache.bind_events(self.events, self.telemetry.name)
        self._register_gauges()
        self.scheduler = WaveScheduler(
            self, max_linger_s=max_linger_s, coalesce=coalesce
        )
        self._stopped = False
        if start:
            self.start()

    # --- state ------------------------------------------------------------

    @property
    def state(self) -> Tuple[GraphVersion, BFSQueryEngine]:
        return self._state

    @property
    def epoch(self) -> GraphVersion:
        return self._state[0]

    @property
    def engine(self) -> BFSQueryEngine:
        return self._state[1]

    @property
    def sssp_cfg(self) -> SSSPConfig:
        """The service's SSSP knobs (engine BFS knobs lifted when not given
        explicitly; raises when the engine sync has no SSSP equivalent)."""
        if self._sssp_cfg is None:
            self._sssp_cfg = self.engine._sssp_cfg(None)
        return self._sssp_cfg

    @property
    def program_cfg(self) -> "programs_mod.ProgramConfig":
        """The service's §19 vertex-program knobs (engine BFS knobs lifted;
        raises when the engine sync has no program equivalent)."""
        if self._vp_cfg is None:
            self._vp_cfg = self.engine._program_cfg(None)
        return self._vp_cfg

    def _cfg_for(self, algo: str):
        if algo == "sssp":
            return self.sssp_cfg
        if algo in PROGRAM_ALGOS:
            return self.program_cfg
        return self.engine.cfg

    # --- submission path --------------------------------------------------

    def submit(
        self, algo: str, root: int, deadline_s: Optional[float] = None,
        *, trace_id: str = "",
    ) -> Future:
        """Enqueue one root query; returns a future resolving to the algo's
        payload (``bfs``/``sssp``: ``int64[n]`` distances, ``closeness``:
        float, ``bc``: this source's Brandes dependency vector
        ``float64[n]``).  Cache hits resolve synchronously without touching
        the queue.  Raises :class:`AdmissionError` on overload and
        :class:`ValueError` on bad algo/root.  ``trace_id`` correlates the
        request's §18 spans (minted here when tracing is on and the
        caller — e.g. the §17 router — did not already assign one)."""
        epoch, engine = self._state
        if self._stopped or self.scheduler.dead:
            # a dead scheduler thread must refuse work, not absorb it:
            # nothing would ever resolve the future (timeout audit, §17)
            raise ServiceStopped("service is not accepting queries")
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; expected one of {ALGOS}")
        root = int(root)
        if not 0 <= root < engine.pg.n:
            raise ValueError(f"root out of range [0, {engine.pg.n}): {root}")
        if algo == "sssp":
            if not engine.pg.weighted:
                raise ValueError("sssp requires a weighted graph")
            self.sssp_cfg  # raises early when the sync has no SSSP analogue
        if algo in PROGRAM_ALGOS:
            self.program_cfg  # raises early when the sync has no analogue
            root = 0  # global result: every rider shares one program run
        self.telemetry.record_submit()
        if self.tracer.enabled and not trace_id:
            trace_id = self.tracer.new_trace_id()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        hit, value = self.cache_lookup(epoch, engine, algo, root)
        if hit:
            fut: Future = Future()
            fut.set_result(value)
            self.telemetry.record_completed(0.0, True, trace_id=trace_id)
            self.tracer.instant(
                f"cache-hit:{algo}", track="queue", trace_id=trace_id,
                args={"algo": algo, "root": root},
            )
            self.events.emit(
                "request", "cache-hit", subsystem=self.telemetry.name,
                trace_id=trace_id, args={"algo": algo, "root": root})
            return fut
        try:
            req = self.queue.submit(algo, root, deadline_s,
                                    trace_id=trace_id)
            self.tracer.instant(
                f"submit:{algo}", track="queue", trace_id=trace_id,
                args={"algo": algo, "root": root}, t=req.submit_t,
            )
            return req.future
        except AdmissionError as exc:
            self.telemetry.record_rejected(reason=exc.reason)
            self.tracer.instant(
                "admission-reject", track="queue", trace_id=trace_id,
                args={"algo": algo, "root": root},
            )
            self.events.emit(
                "admission", "reject", subsystem=self.telemetry.name,
                trace_id=trace_id,
                args={"algo": algo, "root": root, "reason": exc.reason})
            raise

    def query(
        self,
        algo: str,
        root: int,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = 600.0,
    ):
        """Blocking convenience: ``submit(...).result(timeout)``.

        The default timeout is deliberately finite (§17 timeout audit): a
        dead scheduler thread must surface as a ``TimeoutError`` in the
        caller, never as an eternal hang.  Pass ``timeout=None`` only when
        an outer watchdog owns the wait."""
        return self.submit(algo, root, deadline_s).result(timeout)

    # --- cache plumbing (scheduler calls these) ---------------------------

    def cache_lookup(self, epoch, engine, algo, root):
        """``(hit, payload)`` under ``epoch``.  A closeness probe falls back
        to a cached BFS row for the same root (same wave family) and
        memoizes the derived scalar."""
        if not self.cache.enabled:
            return False, None
        key = result_key(epoch, algo, self._cfg_for(algo), root)
        hit, value = self.cache.get(key)
        if hit:
            return True, value
        if algo == "closeness":
            hit, row = self.cache.get(
                result_key(epoch, "bfs", engine.cfg, root)
            )
            if hit:
                value = self._closeness(row)
                self.cache.put(key, value)
                return True, value
        return False, None

    def finish_result(self, epoch, engine, algo, root, raw):
        """Map a wave-class raw result to the request's payload (identity
        except closeness, which derives its scalar from the BFS row)."""
        if algo != "closeness":
            return raw
        value = self._closeness(raw)
        self.cache.put(
            result_key(epoch, "closeness", engine.cfg, root), value
        )
        return value

    def _closeness(self, dist_row) -> float:
        return float(
            measures.closeness_centrality(
                np.asarray(dist_row)[None, :], n=self.n_real
            )[0]
        )

    # --- graph lifecycle --------------------------------------------------

    def swap_graph(
        self,
        pg,
        device=None,
        cfg: Optional[BFSConfig] = None,
        *,
        lanes: Optional[int] = None,
        n_real: Optional[int] = None,
        sssp_cfg: Optional[SSSPConfig] = None,
    ) -> GraphVersion:
        """Replace the served graph; bumps the epoch atomically with the
        engine swap (waits for any in-flight wave).  Returns the new
        :class:`GraphVersion`.  Pending requests are served under the NEW
        version — a request never observes the graph it was submitted
        against after a swap, only the current one (the no-stale-results
        contract).

        **Identity swaps are free** (§16): when the incoming partition is
        structurally equivalent to the served one and no serving knob
        changes, the current engine, version, and cache are kept — a
        reload that turned out to be a no-op must not cold-start anything.
        """
        with self.swap_lock:
            knobs_unchanged = (
                (device is None
                 or resolve_device(device) == self.device)
                and (cfg is None or cfg == self.cfg)
                and (lanes is None or lanes == self.lanes)
                and (n_real is None or int(n_real) == self.n_real)
                and sssp_cfg is None
            )
            if knobs_unchanged and versioning.partitions_equivalent(
                self.engine.pg, pg
            ):
                return self._state[0]
            return self._swap_locked(
                pg, device=device, cfg=cfg, lanes=lanes, n_real=n_real,
                sssp_cfg=sssp_cfg,
            )

    def _swap_locked(
        self, pg, *, device=None, cfg=None, lanes=None, n_real=None,
        sssp_cfg=None,
    ) -> GraphVersion:
        """The unconditional swap path (caller holds ``swap_lock``)."""
        device = (resolve_device(device) if device is not None
                  else self.device)
        cfg = cfg if cfg is not None else self.cfg
        lanes = lanes if lanes is not None else self.lanes
        engine = BFSQueryEngine(pg, cfg, lanes=lanes, device=device)
        version = self._state[0].bump_epoch()
        self._state = (version, engine)
        self.device, self.cfg, self.lanes = device, cfg, lanes
        self.n_real = int(n_real) if n_real is not None else pg.n
        self._sssp_cfg = sssp_cfg
        self._vp_cfg = None  # re-derived from the new engine cfg
        self._overlay = None  # rebuilt from the new partition on demand
        self.cache.drop_stale(version)
        self.telemetry.record_epoch_bump()
        return version

    def bump_epoch(self) -> GraphVersion:
        """Invalidate every cached result without swapping the engine (the
        blunt hook for out-of-band in-place mutation; ``apply_updates`` is
        the surgical one).  Returns the new version."""
        with self.swap_lock:
            version = self._state[0].bump_epoch()
            self._state = (version, self._state[1])
            self._overlay = None
            self.cache.drop_stale(version)
            self.telemetry.record_epoch_bump()
            return version

    # --- streaming mutations (DESIGN.md §16) ------------------------------

    @property
    def overlay(self) -> delta_mod.DeltaOverlay:
        """The host-authoritative streaming edge set over the served
        partition (built on first touch)."""
        with self.swap_lock:
            if self._overlay is None:
                g = delta_mod.graph_from_partition(
                    self.engine.pg, n_real=self.n_real
                )
                self._overlay = delta_mod.DeltaOverlay(
                    g, compact_ratio=self.compact_ratio
                )
            return self._overlay

    def apply_updates(self, batch: delta_mod.EdgeBatch) -> GraphVersion:
        """Fold one mutation batch into the SERVED graph in place and
        carry the result cache across it (§16).

        The delta lands in the partition's static slack (compiled programs
        are reused — same shapes, same partition identity), the version
        bumps ``delta_seq``, and every cached ``bfs``/``sssp`` row is
        either proven unchanged (empty repair seeds), repaired to its new
        exact value on the device, or dropped; cached ``pagerank`` vectors
        are repaired by §19 incremental re-push (warm-started from their
        pre-mutation values), while ``cc``/``tri``/``kcore`` rows drop.
        Only full swaps (slack overflow / compaction threshold) still
        cold-start the cache, under a fresh epoch.  Returns the new
        version."""
        with self.swap_lock:
            old_version, engine = self._state
            overlay = self.overlay
            update = overlay.apply(batch)
            if update.empty:
                # a no-op batch (dedup'd away) must not invalidate anything
                self.telemetry.record_mutation(InvalidationStats())
                return old_version
            applied = delta_mod.apply_update_to_partition(engine.pg, update)
            if not applied or overlay.needs_compaction():
                # slack exhausted or overlay too thick: compact into a
                # fresh CSR and take the full-swap path (epoch bump),
                # dropping every cached row (honest survival accounting)
                g = overlay.compact()
                pg = partition_mod.partition_1d(g, engine.pg.p)
                self.tracer.instant(
                    "compaction", track="mutation",
                    args={"epoch": str(old_version)},
                )
                self.events.emit(
                    "repair", "compaction",
                    subsystem=self.telemetry.name,
                    args={"epoch": str(old_version),
                          "rows_dropped": len(self.cache)})
                self.telemetry.record_compaction()
                self.telemetry.record_mutation(InvalidationStats(
                    rows_before=len(self.cache), dropped=len(self.cache),
                ))
                version = self._swap_locked(
                    pg, n_real=self.n_real, sssp_cfg=self._sssp_cfg
                )
                self._overlay = overlay  # already rebased on the fresh CSR
                return version
            engine.refresh_arrays()
            version = old_version.bump_delta()
            self._state = (version, engine)
            t_rep = time.monotonic()
            budget = [self.repair_budget]
            stats = versioning.migrate_cache(
                self.cache, old_version, version,
                repairers=self._repairers(update, engine, budget),
                derive_closeness=self._closeness,
            )
            dt_rep = time.monotonic() - t_rep
            self._record_repair_metrics(engine, budget)
            self.telemetry.record_stage("repair", dt_rep)
            if self.tracer.enabled:
                self.tracer.add_span(
                    "repair", t_rep, t_rep + dt_rep, track="mutation",
                    args={"version": str(version), "kept": stats.kept,
                          "repaired": stats.repaired,
                          "dropped": stats.dropped},
                )
            self.events.emit(
                "repair", "repair", subsystem=self.telemetry.name,
                args={"version": str(version), "kept": stats.kept,
                      "repaired": stats.repaired,
                      "dropped": stats.dropped,
                      "duration_ms": round(dt_rep * 1e3, 3)})
            self.cache.drop_stale(version)
            self.telemetry.record_mutation(stats)
            return version

    def _record_repair_metrics(self, engine, budget) -> None:
        """§20 dynamic-repair series: repair budget actually spent on this
        batch and the partition's post-batch slack occupancy (the worst
        shard's ``edge_count / emax`` — 1.0 means the next insert that
        lands there forces a compaction)."""
        reg = self.telemetry.registry
        if self.repair_budget is not None and budget[0] is not None:
            reg.counter(
                "repair_budget_spent_total",
                "device repairs charged against the per-batch budget",
                ("service",),
            ).inc(self.repair_budget - budget[0],
                  service=self.telemetry.name)
        pg = engine.pg
        occ = float(
            max(
                np.max(pg.edge_count / max(1, pg.emax)),
                np.max(pg.in_count / max(1, pg.emax)),
            )
        )
        reg.gauge(
            "repair_slack_occupancy",
            "worst-shard fraction of static edge slack in use",
            ("service",),
        ).set(occ, service=self.telemetry.name)

    def _repairers(self, update, engine, budget=None):
        """Per-algo BATCH repairers for :func:`versioning.migrate_cache`,
        sharing one device-repair budget (``None`` = unlimited).  Suspect
        rows within the budget share lane-packed §16 repair waves; rows
        past it drop."""
        if budget is None:
            budget = [self.repair_budget]

        def make(cfg, unit_weight):
            def repairer(rows):
                outcomes = repair_mod.repair_rows(
                    engine.pg, rows, update, cfg,
                    unit_weight=unit_weight, arrays=engine._arrays,
                    max_repairs=budget[0], device=engine.device,
                    mesh=engine.mesh,
                )
                if budget[0] is not None:
                    # device-repaired suspects (iters > 0) consume budget;
                    # host-proven rows (iters == 0) are free
                    budget[0] -= sum(
                        1 for o in outcomes if o is not None and o[2] > 0
                    )
                return outcomes
            return repairer

        reps = {}
        try:
            reps["bfs"] = make(engine._sssp_cfg(None), True)
        except ValueError:
            pass  # sync has no min-monoid analogue: bfs rows drop
        if engine.pg.weighted:
            try:
                reps["sssp"] = make(self.sssp_cfg, False)
            except ValueError:
                pass  # same: sssp rows drop rather than failing the batch
        try:
            pcfg = self.program_cfg
        except ValueError:
            pcfg = None  # sync has no §19 analogue: pagerank rows drop

        if pcfg is not None:
            # §19 showcase: cached rank vectors warm-start the SAME
            # compiled program from their pre-mutation values (incremental
            # re-push) — a fraction of the cold rounds, counted through
            # migrate_cache's repair_iters ledger.  cc/tri/kcore rows have
            # no incremental story yet and drop (no repairer entry).
            def pagerank_repairer(rows):
                if budget[0] is not None and budget[0] < len(rows):
                    return [None] * len(rows)  # budget exhausted: drop
                fn = compiled_program_fn(
                    engine.pg, engine.device, "pagerank", pcfg, engine.mesh
                )
                outcomes = programs_mod.repair_rank_rows(
                    rows, pg=engine.pg, fn=fn, arrays=engine._arrays
                )
                if budget[0] is not None:
                    budget[0] -= sum(
                        1 for o in outcomes if o is not None and o[2] > 0
                    )
                return outcomes

            reps["pagerank"] = pagerank_repairer
        return reps

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.scheduler.start()

    def stop(self, *, join: bool = True) -> None:
        """Stop the scheduler; pending futures fail with
        :class:`ServiceStopped`.  ``join=False`` is the crash path (§17
        replica kill): the scheduler thread is abandoned mid-wave — its
        exit handler still fails whatever it was holding — and the call
        returns immediately."""
        if self._stopped:
            return
        self._stopped = True
        self.scheduler._stop.set()
        leftovers = self.queue.close()  # also wakes the scheduler
        self.scheduler.stop(join=join)
        for r in leftovers:
            resolve_future(r.future,
                           exception=ServiceStopped("service stopped"))

    def __enter__(self) -> "GraphQueryService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- reporting --------------------------------------------------------

    def reset_telemetry(self) -> None:
        """Fresh counters/latency reservoir — call after warmup so compile
        time never pollutes the measured latency/QPS/occupancy.  The new
        Telemetry starts fresh registry series under a new ``service``
        label; the pull gauges re-bind to it."""
        self.telemetry = Telemetry()
        self._register_gauges()

    def _register_gauges(self) -> None:
        """Pull-based §20 gauges evaluated at scrape time (queue depth and
        result-cache hit rate track the live objects, not a snapshot).
        The registry outlives the service, so the gauges hold it weakly: a
        service nothing else holds is freed with its placed arrays (on the
        card, gigabytes), and its gauges then read 0."""
        reg = self.telemetry.registry
        me = weakref.ref(self)

        def live(read):
            def gauge():
                svc = me()
                return 0 if svc is None else read(svc)
            return gauge

        reg.gauge(
            "service_queue_depth", "requests waiting in the submission "
            "queue", ("service",),
        ).set_function(live(lambda svc: len(svc.queue)),
                       service=self.telemetry.name)
        reg.gauge(
            "service_result_cache_hit_rate",
            "epoch-keyed result-cache hit rate since construction",
            ("service",),
        ).set_function(live(lambda svc: svc.cache.snapshot().get("hit_rate", 0.0)),
                       service=self.telemetry.name)

    def debug_requests(self, recent: int = 50) -> dict:
        """Queued (not yet dispatched) requests + the newest completed
        ones from the event log, each with its trace_id — the
        single-service feed for ``/debug/requests``."""
        now = time.monotonic()
        queued = [
            {"algo": r.algo, "root": r.root, "trace_id": r.trace_id,
             "age_ms": round((now - r.submit_t) * 1e3, 3)}
            for r in self.queue.pending()
        ]
        return {
            "inflight": sorted(queued, key=lambda d: -d["age_ms"]),
            "recent": self.events.query(kind="request", limit=recent),
        }

    def snapshot(self) -> dict:
        """JSON-serializable telemetry + cache + queue state."""
        return self.telemetry.snapshot(
            cache=self.cache.snapshot(),
            pending=len(self.queue),
            epoch=str(self.epoch),  # "epoch.delta_seq" (§16 versioning)
            lanes=self.engine.lanes,
            coalesce=self.scheduler.coalesce,
            engine={"waves": self.engine.stats.waves,
                    "queries": self.engine.stats.queries},
        )


# replicated serving tier (DESIGN.md §17) — re-exported here so the
# public surface stays one import: ``from repro_torch.service import ...``.
# These modules import GraphQueryService lazily, so the order is safe.
from repro_torch.service.faults import (  # noqa: E402, F401
    ChaosSpecError,
    Fault,
    FaultInjector,
    parse_chaos,
)
from repro_torch.service.replica import (  # noqa: E402, F401
    Replica,
    ReplicaUnavailable,
)
from repro_torch.service.router import (  # noqa: E402, F401
    NoQuorumError,
    ReplicaRouter,
    RoutedResult,
    RouterTelemetry,
    RouterTimeout,
)
