"""Engine replica lifecycle for the replicated serving tier (DESIGN.md §17).

The port of ``repro.service.replica``.  One :class:`Replica` owns one
full §15/§16 serving stack — its own partition, its own device, its own :class:`~repro_torch.service.GraphQueryService`
(scheduler thread, cache, overlay) — over a SHARED base graph and a shared
replication log.  The §16 ``(epoch, delta_seq)`` JSONL update stream is
exactly a replication log: batches are totally ordered by the router's
``seq``, every replica applies them independently through its own
``apply_updates``, and a replica's served graph is a pure function of
``(base graph, applied_seq)`` — which is what makes catch-up, recovery,
and the router's version gate sound.

Health state machine (router-driven, see ``repro_torch.service.router``)::

    HEALTHY --timeout/failure--> SUSPECT --strikes/dead-thread--> DEAD
       ^            |probe ok                                       |
       |            v                                               v
       +--------- HEALTHY          RECOVERING <---- log catch-up ---+

* **HEALTHY** — serving; eligible for routing.
* **SUSPECT** — a timeout/failure was observed; routed to again only
  after an exponential backoff, and only as a probe.
* **DEAD** — scheduler thread gone (crash/kill) or too many strikes; the
  router rebuilds it from the base graph + full log replay.
* **RECOVERING** — rebuild in progress; never routed to.

Out-of-order and duplicate log delivery (the fault injector produces
both) are handled at the replica boundary: a batch beyond
``applied_seq + 1`` is held back until the gap fills, a batch at or below
``applied_seq`` is a suppressed duplicate, and a batch the overlay
rejects (corruption) leaves ``applied_seq`` untouched so the router's
catch-up redelivers the pristine copy.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from repro_torch.core.bfs import resolve_device
from repro_torch.graph.csr import GraphValidationError

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"
RECOVERING = "RECOVERING"
STATES = (HEALTHY, SUSPECT, DEAD, RECOVERING)


class ReplicaUnavailable(RuntimeError):
    """The chosen replica cannot accept work (dead/recovering/stopped)."""


class Replica:
    """One independently serving engine replica.

    The replica partitions its graph over ``ranks`` simulated ranks on
    ``device`` (the card unless the caller asks for the CPU).  Replicas on
    one device share its execution lock (:mod:`repro_torch.core.devlock`),
    so their waves run one at a time: the counterpart of the reference's
    replicas that share a mesh.  Each replica partitions the graph itself,
    so its programs are its own (the program cache keys on the partition).
    """

    def __init__(
        self,
        replica_id: int,
        graph,
        ranks: int,
        cfg,
        *,
        device="cuda",
        lanes: int = 32,
        n_real: Optional[int] = None,
        service_kw: Optional[dict] = None,
        tracer=None,
    ):
        self.id = int(replica_id)
        self.base_graph = graph  # pristine CSR: recovery rebuilds from it
        self.ranks = int(ranks)
        self.cfg = cfg
        self.lanes = lanes
        self.n_real = n_real if n_real is not None else graph.n_real
        self.service_kw = dict(service_kw or {})
        if tracer is not None:
            # §18: replicas share the router's tracer so every layer's
            # spans land on one timeline (rebuilt services inherit it too)
            self.service_kw.setdefault("tracer", tracer)
        self.device = resolve_device(device)
        # TWO locks, never nested the other way around: ``_lock`` guards
        # health state and is taken from the engine's future-resolution
        # callbacks (mark_healthy/mark_suspect), so it must NEVER be held
        # across ``svc.apply_updates`` — that waits on the wave swap lock
        # the scheduler holds while resolving those same futures (a
        # 2-thread cycle).  ``_log_lock`` serializes log application and
        # recovery and is safe to hold across the apply.
        self._lock = threading.RLock()
        self._log_lock = threading.RLock()
        self.state = HEALTHY
        self.strikes = 0
        self.suspect_until = 0.0
        # replication-log position
        self.applied_seq = 0
        self._holdback: Dict[int, object] = {}
        self.rejected_batches = 0  # corrupt deliveries bounced by the overlay
        self.dup_batches = 0  # duplicate deliveries suppressed
        self.held_batches = 0  # out-of-order deliveries parked then drained
        self.kills = 0
        self.recoveries = 0
        self.svc = self._build_service()

    # --- construction -----------------------------------------------------

    def _build_service(self):
        from repro_torch.graph import partition
        from repro_torch.service import GraphQueryService

        pg = partition.partition_1d(self.base_graph, self.ranks)
        return GraphQueryService(
            pg, self.device, self.cfg, lanes=self.lanes, n_real=self.n_real,
            **self.service_kw,
        )

    # --- serving ----------------------------------------------------------

    @property
    def serving(self) -> bool:
        """Able to accept a query right now (state + scheduler liveness)."""
        return (
            self.state in (HEALTHY, SUSPECT)
            and not self.svc._stopped
            and self.svc.scheduler.running
        )

    @property
    def version(self):
        """The served :class:`~repro_torch.dynamic.versioning.GraphVersion`."""
        return self.svc.epoch

    def submit(self, algo: str, root: int,
               deadline_s: Optional[float] = None, *,
               trace_id: str = "") -> Future:
        """Route one query into this replica's service.  Raises
        :class:`ReplicaUnavailable` when not serving — the router treats
        that exactly like a failed future (failover, no client impact).
        ``trace_id`` carries the router-minted §18 correlation id down
        into the service's queue/scheduler/engine spans."""
        if not self.serving:
            raise ReplicaUnavailable(
                f"replica {self.id} is {self.state} (not serving)"
            )
        return self.svc.submit(algo, root, deadline_s, trace_id=trace_id)

    def heartbeat(self) -> bool:
        """Liveness probe: the scheduler thread must be alive and the
        submission path open.  Cheap enough for a tight router loop."""
        return (
            not self.svc._stopped
            and self.svc.scheduler.running
            and not self.svc.queue.closed
        )

    # --- replication log --------------------------------------------------

    def apply_log(self, seq: int, batch) -> str:
        """Fold log batch ``seq`` into the served graph.  Returns one of
        ``applied`` / ``duplicate`` / ``held`` / ``rejected`` /
        ``unavailable`` — never raises for delivery-level problems (the
        router's catch-up is the repair path, not the delivery)."""
        with self._log_lock:
            if self.state in (DEAD, RECOVERING) or self.svc._stopped:
                return "unavailable"
            if seq <= self.applied_seq:
                self.dup_batches += 1
                return "duplicate"
            if seq > self.applied_seq + 1:
                self._holdback[seq] = batch
                self.held_batches += 1
                return "held"
            outcome = self._apply_next(batch)
            if outcome == "applied":
                self._drain_holdback()
            return outcome

    def _apply_next(self, batch) -> str:
        try:
            self.svc.apply_updates(batch)
        except GraphValidationError:
            # corrupt delivery: applied_seq does NOT advance, so the
            # router's catch-up redelivers the pristine copy from its log
            self.rejected_batches += 1
            return "rejected"
        except Exception:
            # the service was killed/stopped underneath the apply (chaos
            # does this); catch-up redelivers once the replica recovers
            return "unavailable"
        self.applied_seq += 1
        return "applied"

    def _drain_holdback(self) -> None:
        while self.applied_seq + 1 in self._holdback:
            batch = self._holdback.pop(self.applied_seq + 1)
            if self._apply_next(batch) != "applied":
                return

    # --- health transitions (router-driven) -------------------------------

    def mark_suspect(self, backoff_s: float, now: float) -> None:
        with self._lock:
            if self.state == HEALTHY:
                self.state = SUSPECT
            self.strikes += 1
            self.suspect_until = now + backoff_s * (2 ** (self.strikes - 1))

    def mark_healthy(self) -> None:
        with self._lock:
            if self.state in (HEALTHY, SUSPECT):
                self.state = HEALTHY
                self.strikes = 0
                self.suspect_until = 0.0

    def mark_dead(self) -> None:
        with self._lock:
            self.state = DEAD

    # --- crash / recovery -------------------------------------------------

    def kill(self) -> None:
        """Simulated crash: the replica stops serving NOW.  Pending and
        in-flight futures fail with ``ServiceStopped`` (the router's
        failover resubmits them elsewhere); no draining, no join — the
        scheduler thread is abandoned mid-wave like a real process kill."""
        with self._lock:
            self.state = DEAD
            self.kills += 1
            self.svc.tracer.instant(
                "replica-killed", track=f"replica-{self.id}", cat="chaos",
                args={"kills": self.kills},
            )
            self.svc.stop(join=False)

    def recover(self, log: List[Tuple[int, object]]) -> None:
        """Rebuild from the pristine base graph + full log replay (the
        §16 stream IS the recovery mechanism: served graph == pure
        function of ``(base, applied_seq)``).  ``log`` is the router's
        ordered ``[(seq, batch), ...]``; entries at or below the rebuilt
        position are skipped."""
        with self._lock:
            if self.state not in (DEAD, SUSPECT):
                return
            self.state = RECOVERING
        with self._log_lock:  # serialize with in-flight deliveries
            self._holdback.clear()
            try:
                old, self.svc = self.svc, self._build_service()
                old.stop(join=False)
                applied = 0
                for seq, batch in log:
                    if seq != applied + 1:
                        raise RuntimeError(
                            f"replication log has a gap at seq {seq}"
                        )
                    self.svc.apply_updates(batch)
                    applied = seq
                self.applied_seq = applied
                with self._lock:
                    self.state = HEALTHY
                    self.strikes = 0
                    self.suspect_until = 0.0
                    self.recoveries += 1
            except Exception:
                with self._lock:
                    self.state = DEAD
                raise

    def stop(self) -> None:
        """Graceful shutdown (router teardown path)."""
        self.svc.stop()

    # --- reporting --------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "id": self.id,
                "state": self.state,
                "applied_seq": self.applied_seq,
                "version": str(self.version),
                "strikes": self.strikes,
                "kills": self.kills,
                "recoveries": self.recoveries,
                "rejected_batches": self.rejected_batches,
                "dup_batches": self.dup_batches,
                "held_batches": self.held_batches,
                "serving": self.serving,
            }
