"""Version-aware replica router: the serving tier's front door (DESIGN.md §17).

One :class:`ReplicaRouter` fronts N :class:`~repro_torch.service.replica.Replica`
engines.  Clients talk ONLY to the router; every submission returns a
future resolving to a :class:`RoutedResult` whose ``stale`` flag is the
staleness contract made explicit:

* **bounded staleness** — each query carries a read version ``min_seq``
  (a replication-log position; ``router.latest_seq`` gives
  read-your-writes).  A FRESH result (``stale=False``) is only ever
  produced by a replica whose ``applied_seq >= min_seq`` at dispatch —
  the version gate, enforced at routing time and again at resolution.
* **degraded mode** — when no eligible replica exists (quorum lost: all
  dead, recovering, or behind the read version), the router serves the
  last known result for that ``(algo, root)`` from its stale-read cache
  with ``stale=True`` instead of failing closed; only a cold key fails
  (:class:`NoQuorumError`).

Admission control lives HERE, not per engine (§15's per-service bound is
kept as a deep backstop): a global in-flight bound plus per-tenant quotas
shed load at the front door with a structured
:class:`~repro_torch.service.queue.AdmissionError` (occupancy / quota /
retryable) so clients can tell shed-and-retry-later from
reject-permanently.  Non-retryable admission rejections are never
retried or hedged — they are not idempotent-safe to repeat.

Failure handling per request: a failed or unavailable replica triggers
ONE failover resubmission to a different replica; a request that exceeds
``timeout_s`` triggers ONE hedged duplicate to a different replica
(first result wins, the loser is discarded by the future's
first-set-wins contract) while the slow replica is marked SUSPECT with
exponential backoff; a hedge whose every other replica is on backoff goes
to one of them (the reference drops it).  A background heartbeat loop probes suspects,
declares dead schedulers DEAD, rebuilds dead replicas from the base
graph + full replication-log replay, and redelivers missing log batches
(catch-up) — which is also the repair path for dropped, delayed, and
corrupted deliveries injected by :mod:`repro_torch.service.faults`.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import events as events_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core.tracing import NULL_TRACER
from repro_torch.service import faults as faults_mod
from repro_torch.service.queue import (
    AdmissionError,
    ServiceStopped,
    resolve_future,
)
from repro_torch.service.replica import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    ReplicaUnavailable,
)
from repro_torch.service.telemetry import PercentileReservoir


class NoQuorumError(RuntimeError):
    """No eligible replica AND no stale row to degrade to."""


class RouterTimeout(TimeoutError):
    """Primary and hedge both exceeded the router's per-request budget."""


@dataclasses.dataclass(frozen=True)
class RoutedResult:
    """What a router future resolves to.  ``stale`` is True IFF degraded
    mode served it (from the stale-read cache, possibly below the
    requested read version — that is what the flag means)."""

    value: Any
    stale: bool
    replica: int  # serving replica id; -1 for a degraded (cached) serve
    seq: int  # replica's applied_seq at dispatch (cache's seq if stale)
    version: str  # served GraphVersion "epoch.delta_seq" ("" if stale)
    hedged: bool = False
    retried: bool = False


class _Ticket:
    """Router-side state of one client request."""

    __slots__ = ("algo", "root", "deadline_s", "min_seq", "tenant",
                 "client", "submit_t", "attempts", "hedged", "tried",
                 "lock", "trace_id")

    def __init__(self, algo, root, deadline_s, min_seq, tenant, now,
                 trace_id=""):
        self.algo = algo
        self.root = root
        self.deadline_s = deadline_s
        self.min_seq = min_seq
        self.tenant = tenant
        self.client: Future = Future()
        self.submit_t = now
        self.attempts = 0  # dispatches so far (failover + hedge included)
        self.hedged = False
        self.tried = set()  # replica ids dispatched to
        self.lock = threading.Lock()
        self.trace_id = trace_id


#: every RouterTelemetry counter, as events of ONE registry family
#: (``router_events_total{router=..., event=...}``)
_ROUTER_EVENTS = (
    "submitted", "completed", "failed",
    "shed",  # front-door admission rejections
    "stale_serves",  # degraded-mode cache serves
    "retries",  # failover resubmissions after a failure
    "hedges",  # timeout-triggered duplicate dispatches
    "failovers",  # replicas declared dead under traffic
    "recoveries",  # dead replicas rebuilt via log replay
    "catch_up_batches",  # log batches redelivered by catch-up
    "suspect_marks",
)

_ROUTER_IDS = itertools.count()


class RouterTelemetry:
    """Front-door counters + latency reservoir, registry-backed
    (DESIGN.md §20) with a JSON-safe snapshot.  The ``faults`` block
    merges the injector's deterministic ``injected`` schedule counters
    with the router's response counters."""

    def __init__(self, latency_window: int = 65536, *,
                 registry=None, name: Optional[str] = None):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.registry = (registry if registry is not None
                         else metrics_mod.default_registry())
        self.name = (name if name is not None
                     else f"router{next(_ROUTER_IDS)}")
        events = self.registry.counter(
            "router_events_total",
            "front-door request / failover / recovery events",
            ("router", "event"))
        self._events = {e: events.labels(router=self.name, event=e)
                        for e in _ROUTER_EVENTS}
        self._transitions = self.registry.counter(
            "router_health_transitions_total",
            "replica health-state transitions observed by the router",
            ("router", "replica", "to"))
        # exemplars on (§21): each latency bucket retains the trace_id
        # of a recent sample, so a p99 spike names a concrete trace
        self._lat_hist = self.registry.histogram(
            "router_latency_ms", "end-to-end routed-request latency",
            ("router",), exemplars=True).labels(router=self.name)
        exact = max(1, min(int(latency_window), 1024))
        self._latencies = PercentileReservoir(exact_limit=exact)

    def bump(self, name: str, by: int = 1) -> None:
        self._events[name].inc(by)

    def record_latency(self, seconds: float, trace_id: str = "") -> None:
        self._lat_hist.observe(seconds * 1e3, trace_id=trace_id)
        with self._lock:
            self._latencies.add(seconds)

    def record_transition(self, replica_id: int, to: str) -> None:
        """One replica health-state change (HEALTHY→SUSPECT→DEAD→…)."""
        self._transitions.inc(router=self.name, replica=str(replica_id),
                              to=to)

    def __getattr__(self, name: str) -> int:
        events = self.__dict__.get("_events")
        if events is not None and name in events:
            return int(events[name].value)
        raise AttributeError(name)

    def faults_block(self, injector) -> Dict[str, Any]:
        return {
            "injected": (injector.snapshot() if injector is not None
                         else {k: 0 for k in faults_mod.KINDS}),
            "schedule": (injector.schedule_json()
                         if injector is not None else []),
            "retries": self.retries,
            "hedges": self.hedges,
            "failovers": self.failovers,
            "recoveries": self.recoveries,
            "shed": self.shed,
            "stale_serves": self.stale_serves,
            "catch_up_batches": self.catch_up_batches,
            "suspect_marks": self.suspect_marks,
        }

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            lat_block = self._latencies.summary(scale=1e3)
        completed = self.completed
        return {
            "uptime_s": elapsed,
            "submitted": self.submitted,
            "completed": completed,
            "failed": self.failed,
            # empty window (no completions, e.g. right after a warmup
            # telemetry reset): exactly 0.0, never a denormal ratio
            "qps": completed / elapsed if completed else 0.0,
            "latency_ms": lat_block,
        }


class ReplicaRouter:
    """Front door over a replica set (see module docstring).

    ``heartbeat_interval_s=None`` disables the background health loop —
    tests then drive :meth:`health_sweep` / :meth:`catch_up_now` by hand
    for fully deterministic schedules."""

    def __init__(
        self,
        replicas: List,
        *,
        timeout_s: float = 30.0,
        hard_timeout_factor: float = 2.0,
        max_inflight: int = 4096,
        tenant_quota: Optional[int] = None,
        tenant_quotas: Optional[Dict[str, int]] = None,
        stale_cache_capacity: int = 512,
        heartbeat_interval_s: Optional[float] = 0.05,
        suspect_backoff_s: float = 0.1,
        injector: Optional[faults_mod.FaultInjector] = None,
        auto_recover: bool = True,
        start: bool = True,
        tracer=None,
        events=None,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1: {max_inflight}")
        self.replicas = list(replicas)
        self.timeout_s = timeout_s
        self.hard_timeout_factor = hard_timeout_factor
        self.max_inflight = max_inflight
        self.tenant_quota = tenant_quota
        self.tenant_quotas = dict(tenant_quotas or {})
        self.suspect_backoff_s = suspect_backoff_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.injector = injector
        self.auto_recover = auto_recover
        # §18 request tracing (share ONE tracer with the replicas' services
        # so every layer's spans land on a single timeline)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # §21 structured event log (default: the process-wide ring, like
        # the default metrics registry) — every state transition, chaos
        # injection, and degraded serve lands here with its trace_id
        self.events = (events if events is not None
                       else events_mod.default_event_log())
        self.telemetry = RouterTelemetry()
        # pull-based replication-lag gauges: evaluated at scrape time so
        # /metrics always reports the live ``head_seq - applied_seq``;
        # the registry outlives the router, so they hold it and its
        # replicas weakly (a replica's service holds its placed arrays)
        lag = self.telemetry.registry.gauge(
            "router_replication_lag",
            "replication lag (head_seq - applied_seq) per replica",
            ("router", "replica"))
        me = weakref.ref(self)
        for r in replicas:
            lag.set_function(
                (lambda rep: lambda: 0 if me() is None or rep() is None else max(
                    0, me().latest_seq - rep().applied_seq))(weakref.ref(r)),
                router=self.telemetry.name, replica=str(r.id))
        # replication log: batches in seq order (seq = 1-based index)
        self._log: List[Any] = []
        self._log_lock = threading.Lock()
        # admission accounting
        self._adm_lock = threading.Lock()
        self._inflight_total = 0
        self._inflight_tenant: Dict[str, int] = {}
        self._inflight_replica: Dict[int, int] = {
            r.id: 0 for r in self.replicas
        }
        self._op_counter = itertools.count(1)
        self._rr = itertools.count()
        # open tickets (for /debug/requests) + last chaos kill per
        # replica (attributes retried requests to the kill that caused
        # them — the §21 metrics→exemplar→trace→events chain)
        self._open_lock = threading.Lock()
        self._open: Dict[int, _Ticket] = {}
        self._kills: Dict[int, int] = {}  # replica id -> chaos op index
        # degraded-mode stale-read cache: (algo, root) -> (value, seq)
        self._stale_lock = threading.Lock()
        self._stale_cache: "OrderedDict[Tuple, Tuple[Any, int]]" = (
            OrderedDict()
        )
        self.stale_cache_capacity = stale_cache_capacity
        # timeout/hedge monitor
        self._mon_cond = threading.Condition()
        self._mon_heap: List[Tuple[float, int, str, _Ticket]] = []
        self._mon_seq = itertools.count()
        self._closed = False
        self._threads: List[threading.Thread] = []
        if start:
            self.start()

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        mon = threading.Thread(
            target=self._monitor_run, name="router-monitor", daemon=True
        )
        mon.start()
        self._threads.append(mon)
        if self.heartbeat_interval_s is not None:
            hb = threading.Thread(
                target=self._heartbeat_run, name="router-heartbeat",
                daemon=True,
            )
            hb.start()
            self._threads.append(hb)

    def stop(self) -> None:
        """Graceful teardown: close the front door, stop the background
        threads, stop every replica (their pending futures fail, which
        flows back into any outstanding client futures)."""
        if self._closed:
            return
        self._closed = True
        with self._mon_cond:
            self._mon_cond.notify_all()
        for t in self._threads:
            t.join(timeout=60.0)
        self._threads = []
        for r in self.replicas:
            r.stop()

    def __enter__(self) -> "ReplicaRouter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- replication log --------------------------------------------------

    @property
    def latest_seq(self) -> int:
        with self._log_lock:
            return len(self._log)

    def log_entries(self, from_seq: int = 0) -> List[Tuple[int, Any]]:
        """``[(seq, batch), ...]`` strictly after ``from_seq``."""
        with self._log_lock:
            return [(i + 1, b) for i, b in enumerate(self._log)
                    if i + 1 > from_seq]

    def apply_updates(self, batch) -> int:
        """Append one mutation batch to the replication log and fan it out
        to every replica (subject to injected delivery faults — dropped /
        delayed / duplicated / corrupted deliveries are repaired by
        catch-up, which redelivers the pristine logged copy).  Returns the
        batch's log ``seq``; ``submit(min_seq=seq)`` is read-your-writes."""
        if self._closed:
            raise ServiceStopped("router is stopped")
        with self._log_lock:
            self._log.append(batch)
            seq = len(self._log)
        for idx, r in enumerate(self.replicas):
            fault = (self.injector.on_batch(seq, idx)
                     if self.injector is not None else None)
            if fault is None:
                r.apply_log(seq, batch)
            elif fault.kind == "drop-batch":
                continue  # catch-up redelivers from the log
            elif fault.kind == "delay-batch":
                t = threading.Timer(
                    fault.delay_s, r.apply_log, args=(seq, batch)
                )
                t.daemon = True
                t.start()
            elif fault.kind == "dup-batch":
                r.apply_log(seq, batch)
                r.apply_log(seq, batch)  # duplicate: replica suppresses it
            elif fault.kind == "corrupt-batch":
                r.apply_log(
                    seq, faults_mod.corrupt_batch(batch, r.base_graph.n)
                )
            else:  # pragma: no cover
                raise AssertionError(f"unknown batch fault {fault.kind!r}")
        return seq

    # --- admission (the front door's §15 role) ----------------------------

    def _quota_for(self, tenant: str) -> Optional[int]:
        return self.tenant_quotas.get(tenant, self.tenant_quota)

    def _admit(self, tenant: str) -> None:
        with self._adm_lock:
            if self._inflight_total >= self.max_inflight:
                self.telemetry.bump("shed")
                self.events.emit(
                    "admission", "reject", subsystem=self.telemetry.name,
                    args={"reason": "overload", "tenant": tenant,
                          "occupancy": self._inflight_total})
                raise AdmissionError(
                    f"router overloaded ({self._inflight_total} in flight)",
                    occupancy=self._inflight_total,
                    quota=self.max_inflight,
                    retryable=True,
                    tenant=tenant,
                    reason="overload",
                )
            quota = self._quota_for(tenant)
            used = self._inflight_tenant.get(tenant, 0)
            if quota is not None and used >= quota:
                self.telemetry.bump("shed")
                self.events.emit(
                    "admission", "reject", subsystem=self.telemetry.name,
                    args={"reason": "tenant_quota", "tenant": tenant,
                          "occupancy": used})
                raise AdmissionError(
                    f"tenant {tenant!r} over quota ({used}/{quota})",
                    occupancy=used,
                    quota=quota,
                    retryable=True,
                    tenant=tenant,
                    reason="tenant_quota",
                )
            self._inflight_total += 1
            self._inflight_tenant[tenant] = used + 1

    def _release(self, tenant: str) -> None:
        with self._adm_lock:
            self._inflight_total -= 1
            self._inflight_tenant[tenant] = max(
                0, self._inflight_tenant.get(tenant, 1) - 1
            )

    # --- routing ----------------------------------------------------------

    def _eligible(self, min_seq: int, exclude, now: float) -> List:
        out = []
        for r in self.replicas:
            if r.id in exclude or not r.serving:
                continue
            if r.state == SUSPECT and now < r.suspect_until:
                continue  # exponential backoff: probe later, not now
            if r.applied_seq < min_seq:
                continue  # the version gate
            out.append(r)
        return out

    def _pick(self, min_seq: int, exclude, now: float):
        cands = self._eligible(min_seq, exclude, now)
        if not cands:
            return None
        rr = next(self._rr)  # round-robin tiebreak among equally loaded
        with self._adm_lock:
            return min(
                cands,
                key=lambda r: (self._inflight_replica.get(r.id, 0),
                               (r.id - rr) % len(self.replicas)),
            )

    def submit(
        self,
        algo: str,
        root: int,
        deadline_s: Optional[float] = None,
        *,
        tenant: str = "default",
        min_seq: Optional[int] = None,
    ) -> Future:
        """Route one query; returns a future resolving to
        :class:`RoutedResult`.  Raises :class:`AdmissionError` (structured:
        occupancy/quota/retryable) at the front door and
        :class:`NoQuorumError` when neither a replica nor a stale row can
        serve it."""
        if self._closed:
            raise ServiceStopped("router is stopped")
        min_seq = 0 if min_seq is None else int(min_seq)
        self.telemetry.bump("submitted")
        self._admit(tenant)
        now = time.monotonic()
        trace_id = (self.tracer.new_trace_id() if self.tracer.enabled
                    else "")
        ticket = _Ticket(algo, root, deadline_s, min_seq, tenant, now,
                         trace_id)
        with self._open_lock:
            self._open[id(ticket)] = ticket
        ticket.client.add_done_callback(self._finish(ticket))
        try:
            stall = None
            op = next(self._op_counter)
            if self.injector is not None:
                for fault in self.injector.on_op(op):
                    if fault.kind == "kill-replica":
                        self.tracer.instant(
                            "chaos:kill-replica", track="router",
                            cat="chaos", trace_id=trace_id,
                            args={"victim": fault.victim, "op": op},
                        )
                        self.events.emit(
                            "chaos", "kill-replica",
                            subsystem=self.telemetry.name,
                            trace_id=trace_id,
                            args={"victim": fault.victim, "op": op})
                        with self._open_lock:
                            self._kills[fault.victim] = op
                        self._kill(fault.victim)
                    elif fault.kind == "stall-wave":
                        self.tracer.instant(
                            "chaos:stall-wave", track="router",
                            cat="chaos", trace_id=trace_id,
                            args={"victim": fault.victim, "op": op,
                                  "delay_s": fault.delay_s},
                        )
                        self.events.emit(
                            "chaos", "stall-wave",
                            subsystem=self.telemetry.name,
                            trace_id=trace_id,
                            args={"victim": fault.victim, "op": op,
                                  "delay_s": fault.delay_s})
                        stall = fault
            victim = (self.replicas[stall.victim]
                      if stall is not None else None)
            if (victim is not None and victim.serving
                    and victim.applied_seq >= min_seq):
                # force this op onto the victim, delayed past the router
                # timeout: the monitor's hedge is the escape hatch (the
                # victim still had to pass the version gate)
                self._dispatch(ticket, victim, delay_s=stall.delay_s)
            else:
                replica = self._pick(min_seq, ticket.tried, now)
                if replica is None:
                    self._serve_degraded(ticket, NoQuorumError(
                        f"no replica at seq >= {min_seq} and no stale row "
                        f"for ({algo}, root={root})"
                    ))
                    return ticket.client
                self._dispatch(ticket, replica)
            self._arm(ticket, "hedge", now + self.timeout_s)
            self._arm(ticket, "timeout",
                      now + self.timeout_s * self.hard_timeout_factor)
        except BaseException as exc:
            # never leak an armed ticket on a submit-path error
            resolve_future(ticket.client, exception=exc)
            raise
        return ticket.client

    def query(
        self,
        algo: str,
        root: int,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = 600.0,
        **kw,
    ) -> RoutedResult:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(algo, root, deadline_s, **kw).result(timeout)

    def _finish(self, ticket: _Ticket):
        def cb(fut: Future) -> None:
            self._release(ticket.tenant)
            with self._open_lock:
                self._open.pop(id(ticket), None)
            if fut.cancelled():
                return
            now = time.monotonic()
            exc = fut.exception()
            args = {"algo": ticket.algo, "root": ticket.root,
                    "attempts": ticket.attempts, "hedged": ticket.hedged}
            if exc is None:
                res = fut.result()
                self.telemetry.bump("completed")
                self.telemetry.record_latency(now - ticket.submit_t,
                                              trace_id=ticket.trace_id)
                if not res.stale:
                    self._stale_put(ticket.algo, ticket.root,
                                    res.value, res.seq)
                args["stale"] = res.stale
                args["replica"] = res.replica
            else:
                self.telemetry.bump("failed")
                args["error"] = type(exc).__name__
            self.events.emit(
                "request", "completed" if exc is None else "failed",
                subsystem=self.telemetry.name, trace_id=ticket.trace_id,
                args={**args,
                      "latency_ms": round((now - ticket.submit_t) * 1e3, 3)})
            if self.tracer.enabled:
                self.tracer.add_span(
                    f"route:{ticket.algo}", ticket.submit_t, now,
                    track="router", trace_id=ticket.trace_id, args=args,
                )
        return cb

    # --- dispatch / failover / hedging ------------------------------------

    def _dispatch(self, ticket: _Ticket, replica, delay_s: float = 0.0):
        if delay_s > 0:
            t = threading.Timer(delay_s, self._dispatch,
                                args=(ticket, replica))
            t.daemon = True
            t.start()
            with ticket.lock:
                ticket.attempts += 1
                ticket.tried.add(replica.id)
            return
        if ticket.client.done():
            return
        with ticket.lock:
            if delay_s == 0.0 and replica.id not in ticket.tried:
                ticket.attempts += 1
                ticket.tried.add(replica.id)
        seq0 = replica.applied_seq  # applies only ever advance this, so
        # seq0 is a sound freshness witness for the result
        if seq0 < ticket.min_seq:
            # the gate re-checked at dispatch (a delayed/raced dispatch
            # must not serve below the read version): route elsewhere
            other = self._pick(ticket.min_seq, ticket.tried,
                               time.monotonic())
            if other is None:
                self._serve_degraded(ticket, NoQuorumError(
                    f"no replica at seq >= {ticket.min_seq}"
                ))
            else:
                self._dispatch(ticket, other)
            return
        with self._adm_lock:
            self._inflight_replica[replica.id] = (
                self._inflight_replica.get(replica.id, 0) + 1
            )
        t_att = time.monotonic()
        try:
            # keep the legacy call shape when tracing is off so replica-like
            # stand-ins (tests, adapters) that predate trace_id still work
            if ticket.trace_id:
                inner = replica.submit(ticket.algo, ticket.root,
                                       ticket.deadline_s,
                                       trace_id=ticket.trace_id)
            else:
                inner = replica.submit(ticket.algo, ticket.root,
                                       ticket.deadline_s)
        except Exception as exc:
            with self._adm_lock:
                self._inflight_replica[replica.id] -= 1
            self._attempt_span(ticket, replica, t_att, exc)
            self._on_failure(ticket, replica, exc)
            return
        inner.add_done_callback(
            lambda fut: self._on_inner(ticket, replica, seq0, t_att, fut)
        )

    def _attempt_span(self, ticket: _Ticket, replica, t_att: float,
                      exc: Optional[BaseException]) -> None:
        """One per-replica dispatch attempt on the replica's own track.  A
        killed replica's in-flight work shows up as exactly this span with
        an ``error`` annotation (``ServiceStopped``/``ReplicaUnavailable``)
        — the §17 chaos narrative made visible in Perfetto."""
        if not self.tracer.enabled:
            return
        args = {"algo": ticket.algo, "root": ticket.root,
                "attempt": ticket.attempts}
        if exc is not None:
            args["error"] = type(exc).__name__
        self.tracer.add_span(
            f"attempt:{ticket.algo}", t_att, time.monotonic(),
            track=f"replica-{replica.id}", trace_id=ticket.trace_id,
            args=args,
        )

    def _on_inner(self, ticket: _Ticket, replica, seq0: int, t_att: float,
                  fut: Future):
        with self._adm_lock:
            self._inflight_replica[replica.id] -= 1
        if fut.cancelled():
            return
        exc = fut.exception()
        self._attempt_span(ticket, replica, t_att, exc)
        if exc is None:
            self._state_change(replica, replica.mark_healthy)
            resolve_future(ticket.client, result=RoutedResult(
                value=fut.result(),
                stale=False,
                replica=replica.id,
                seq=seq0,
                version=str(replica.version),
                hedged=ticket.hedged,
                retried=ticket.attempts > 1,
            ))
            return
        self._on_failure(ticket, replica, exc)

    def _on_failure(self, ticket: _Ticket, replica, exc: BaseException):
        """One replica failed this request: strike it, then fail over ONCE
        to a different replica — except for non-retryable admission
        rejections, which are terminal by contract."""
        self._suspect(replica)
        if isinstance(exc, AdmissionError) and not exc.retryable:
            resolve_future(ticket.client, exception=exc)
            return
        if ticket.client.done():
            return
        now = time.monotonic()
        with ticket.lock:
            may_retry = len(ticket.tried) < len(self.replicas) + 1
        other = (self._pick(ticket.min_seq, ticket.tried, now)
                 if may_retry and not self._closed else None)
        if other is not None:
            self.telemetry.bump("retries")
            self.tracer.instant(
                f"retry:{ticket.algo}", track="router", cat="retry",
                trace_id=ticket.trace_id,
                args={"root": ticket.root, "failed": replica.id,
                      "retry_to": other.id,
                      "error": type(exc).__name__},
            )
            # attribute the retry to the chaos kill that caused it (if
            # one did): the kill event lands in THIS request's event
            # slice, which is what makes the SLO alert's exemplar trace
            # navigate back to the fault
            with self._open_lock:
                kill_op = self._kills.get(replica.id)
            if kill_op is not None and isinstance(
                    exc, (ServiceStopped, ReplicaUnavailable)):
                self.events.emit(
                    "chaos", "kill-impact",
                    subsystem=self.telemetry.name,
                    trace_id=ticket.trace_id,
                    args={"victim": replica.id, "op": kill_op,
                          "error": type(exc).__name__})
            self.events.emit(
                "retry", "retry", subsystem=self.telemetry.name,
                trace_id=ticket.trace_id,
                args={"algo": ticket.algo, "root": ticket.root,
                      "failed": replica.id, "retry_to": other.id,
                      "error": type(exc).__name__})
            self._dispatch(ticket, other)
        else:
            self._serve_degraded(ticket, exc)

    def _serve_degraded(self, ticket: _Ticket, fallback: BaseException):
        """Quorum lost for this request: serve the stale-read cache with
        an explicit marker, or fail with ``fallback`` on a cold key."""
        entry = self._stale_get(ticket.algo, ticket.root)
        if entry is not None:
            value, seq = entry
            if resolve_future(ticket.client, result=RoutedResult(
                value=value, stale=True, replica=-1, seq=seq, version="",
                hedged=ticket.hedged, retried=ticket.attempts > 1,
            )):
                self.telemetry.bump("stale_serves")
                self.tracer.instant(
                    f"stale-serve:{ticket.algo}", track="router",
                    trace_id=ticket.trace_id,
                    args={"root": ticket.root, "seq": seq},
                )
                self.events.emit(
                    "retry", "stale-serve",
                    subsystem=self.telemetry.name,
                    trace_id=ticket.trace_id,
                    args={"algo": ticket.algo, "root": ticket.root,
                          "seq": seq})
            return
        resolve_future(ticket.client, exception=fallback)

    def _state_change(self, replica, fn, *args) -> None:
        """Run one health-state mutator and count the transition it
        actually caused (no-ops — already in that state — don't count)."""
        before = replica.state
        fn(*args)
        if replica.state != before:
            self.telemetry.record_transition(replica.id, replica.state)
            self.events.emit(
                "replica", "state", subsystem=self.telemetry.name,
                args={"replica": replica.id, "from": before,
                      "to": replica.state})

    def _suspect(self, replica) -> None:
        self.telemetry.bump("suspect_marks")
        self._state_change(replica, replica.mark_suspect,
                           self.suspect_backoff_s, time.monotonic())

    def _kill(self, victim: int) -> None:
        r = self.replicas[victim]
        if r.state != DEAD:
            self._state_change(r, r.kill)
            self.telemetry.bump("failovers")

    # --- timeout/hedge monitor --------------------------------------------

    def _arm(self, ticket: _Ticket, kind: str, fire_t: float) -> None:
        with self._mon_cond:
            heapq.heappush(
                self._mon_heap, (fire_t, next(self._mon_seq), kind, ticket)
            )
            self._mon_cond.notify_all()

    def _monitor_run(self) -> None:
        while True:
            with self._mon_cond:
                while not self._mon_heap and not self._closed:
                    self._mon_cond.wait()
                if self._closed and not self._mon_heap:
                    return
                fire_t, _, kind, ticket = self._mon_heap[0]
                now = time.monotonic()
                if fire_t > now and not self._closed:
                    self._mon_cond.wait(fire_t - now)
                    continue
                heapq.heappop(self._mon_heap)
                if self._closed:
                    # drain: fail whatever is still pending, then exit
                    resolve_future(ticket.client, exception=ServiceStopped(
                        "router stopped"))
                    continue
            if ticket.client.done():
                continue
            if kind == "hedge":
                self._fire_hedge(ticket)
            else:
                resolve_future(ticket.client, exception=RouterTimeout(
                    f"{ticket.algo} root={ticket.root}: no replica answered "
                    f"within {self.timeout_s * self.hard_timeout_factor:.3f}s"
                ))

    def _fire_hedge(self, ticket: _Ticket) -> None:
        """The per-request timeout elapsed with the primary still silent:
        dispatch ONE duplicate to a different replica (first result wins)
        and put the slow replica on backoff.  Where every other replica
        that could answer sits out a backoff, the duplicate goes to one of
        them all the same: the primary has already outlived the timeout,
        and a backoff spaces out routine picks, not this escape (the
        reference drops the hedge then; on a loaded host, where slow waves
        put every replica on backoff, that left a stalled request to the
        hard timeout)."""
        now = time.monotonic()
        with ticket.lock:
            if ticket.hedged:
                return
            ticket.hedged = True
            slow = ticket.tried
        for r in self.replicas:
            if r.id in slow:
                self._suspect(r)
        other = (self._pick(ticket.min_seq, slow, now)
                 or self._pick(ticket.min_seq, slow, float("inf")))
        if other is None:
            return  # nowhere to hedge; the hard timeout is the backstop
        self.telemetry.bump("hedges")
        self.tracer.instant(
            f"hedge:{ticket.algo}", track="router", cat="hedge",
            trace_id=ticket.trace_id,
            args={"root": ticket.root, "slow": sorted(slow),
                  "hedge_to": other.id},
        )
        self.events.emit(
            "retry", "hedge", subsystem=self.telemetry.name,
            trace_id=ticket.trace_id,
            args={"algo": ticket.algo, "root": ticket.root,
                  "slow": sorted(slow), "hedge_to": other.id})
        self._dispatch(ticket, other)

    # --- health + catch-up ------------------------------------------------

    def _heartbeat_run(self) -> None:
        stop_check = self.heartbeat_interval_s or 0.05
        while not self._closed:
            time.sleep(stop_check)
            if self._closed:
                return
            try:
                self.health_sweep()
            except Exception:  # a sweep failure must not kill the loop
                pass

    def health_sweep(self, now: Optional[float] = None) -> None:
        """One pass of the health state machine + log catch-up.  Called by
        the heartbeat thread (or directly by deterministic tests)."""
        now = time.monotonic() if now is None else now
        for r in self.replicas:
            if r.state == DEAD:
                if self.auto_recover:
                    try:
                        with self.tracer.span(
                            "recover", track=f"replica-{r.id}",
                            cat="recovery",
                            args={"log_seq": self.latest_seq},
                        ):
                            self._state_change(r, r.recover,
                                               self.log_entries())
                        self.telemetry.bump("recoveries")
                    except Exception:
                        pass  # stays DEAD; retried next sweep
            elif r.state == SUSPECT and now >= r.suspect_until:
                if r.heartbeat():
                    self._state_change(r, r.mark_healthy)
                else:
                    self._state_change(r, r.mark_dead)
                    self.telemetry.bump("failovers")
            elif r.state == HEALTHY and not r.heartbeat():
                # scheduler thread died underneath a healthy replica
                self._state_change(r, r.mark_dead)
                self.telemetry.bump("failovers")
        self.catch_up_now()

    def catch_up_now(self) -> int:
        """Redeliver missing log batches to every live replica (repairs
        dropped/corrupted deliveries and post-recovery gaps).  Returns the
        number of batches actually applied."""
        applied = 0
        head = self.latest_seq
        t0 = time.monotonic()
        for r in self.replicas:
            if r.state in (DEAD, RECOVERING):
                continue
            behind = r.applied_seq
            if behind >= head:
                continue
            for seq, batch in self.log_entries(behind):
                if r.apply_log(seq, batch) == "applied":
                    applied += 1
        if applied:
            self.telemetry.bump("catch_up_batches", applied)
            self.events.emit(
                "repair", "catch-up", subsystem=self.telemetry.name,
                args={"batches": applied, "head_seq": head})
            if self.tracer.enabled:
                # recorded only when batches actually moved, so the
                # heartbeat's idle sweeps never flood the trace
                self.tracer.add_span(
                    "catch-up", t0, time.monotonic(), track="router",
                    cat="recovery", args={"batches": applied},
                )
        return applied

    # --- degraded-mode stale cache ----------------------------------------

    def _stale_put(self, algo, root, value, seq) -> None:
        if self.stale_cache_capacity <= 0:
            return
        key = (algo, int(root))
        with self._stale_lock:
            if key in self._stale_cache:
                self._stale_cache.move_to_end(key)
            while len(self._stale_cache) >= self.stale_cache_capacity:
                self._stale_cache.popitem(last=False)
            self._stale_cache[key] = (value, int(seq))

    def _stale_get(self, algo, root):
        with self._stale_lock:
            return self._stale_cache.get((algo, int(root)))

    # --- reporting --------------------------------------------------------

    def debug_requests(self, recent: int = 50) -> Dict[str, Any]:
        """In-flight tickets + the newest completed requests (from the
        event log), each with its trace_id — ``/debug/requests``."""
        now = time.monotonic()
        with self._open_lock:
            open_tickets = list(self._open.values())
        inflight = [
            {"algo": t.algo, "root": t.root, "tenant": t.tenant,
             "trace_id": t.trace_id, "attempts": t.attempts,
             "hedged": t.hedged, "age_ms": round((now - t.submit_t) * 1e3, 3)}
            for t in open_tickets
        ]
        return {
            "inflight": sorted(inflight, key=lambda d: -d["age_ms"]),
            "recent": self.events.query(kind="request", limit=recent),
        }

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable router + per-replica + faults state."""
        snap = self.telemetry.snapshot()
        with self._adm_lock:
            snap["inflight"] = self._inflight_total
            snap["inflight_by_tenant"] = dict(self._inflight_tenant)
        snap["log_seq"] = self.latest_seq
        snap["replicas"] = [r.snapshot() for r in self.replicas]
        snap["n_serving"] = sum(
            1 for r in self.replicas if r.state in (HEALTHY, SUSPECT)
        )
        with self._stale_lock:
            snap["stale_cache_size"] = len(self._stale_cache)
        snap["faults"] = self.telemetry.faults_block(self.injector)
        return snap
