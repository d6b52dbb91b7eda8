"""Deadline-aware wave scheduler (DESIGN.md §15).

The §13 result that makes this worth building: a butterfly-synced MS-BFS
wave costs nearly the same whether 1 or 32 lanes are occupied, so serving
throughput is won in BATCH FORMATION.  The scheduler therefore coalesces
compatible pending requests — same graph epoch, same wave class, same
config — into full-width lane waves, and dispatches a partial wave only
when waiting longer would cost more than the empty lanes:

* **full wave** — the class has ``wave_width`` distinct pending roots;
* **max linger** — the oldest request has waited ``max_linger_s`` (bounds
  the latency floor under light load);
* **deadline pressure** — the oldest request's remaining budget is within
  ``deadline_margin`` × the EWMA service time (dispatch now or miss it).

Within a wave, duplicate roots fold into ONE lane (every rider resolves
from the same result), and requests whose deadline already passed are
failed without burning a lane (load shedding).  Wave classes: ``bfs`` and
``closeness`` share BFS distance waves; ``sssp`` batches through the
engine's per-root min-reduce program; ``bc`` dispatches one source per
engine call (per-request Brandes contributions cannot share a wave — the
wave program accumulates over lanes) but still dedups repeats; the
§19 vertex programs (``pagerank``/``cc``/``tri``/``kcore``) are width-1
classes whose ENTIRE pending group rides one engine run — their result is
global, so every rider resolves from the same converged vector.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, TYPE_CHECKING

from repro_torch.service.cache import result_key
from repro_torch.service.queue import (
    PROGRAM_ALGOS,
    DeadlineExceeded,
    QueryRequest,
    ServiceStopped,
    resolve_future,
)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.service import GraphQueryService

# request algo -> wave class sharing one dispatch group; §19 vertex
# programs each form their own class (one global result per graph epoch,
# so a class's whole pending group folds into a single engine run)
WAVE_CLASS = {"bfs": "bfs", "closeness": "bfs", "sssp": "sssp", "bc": "bc"}
WAVE_CLASS.update({algo: algo for algo in PROGRAM_ALGOS})

#: Dispatch groups in drain order (insertion-ordered, deduped).
WAVE_CLASSES = tuple(dict.fromkeys(WAVE_CLASS.values()))


def _device_context(device):
    """The thread's current CUDA device set to ``device`` for the body of
    the scheduler thread (the current device is per thread, and the thread
    launches the waves); on the CPU, no context."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class WaveScheduler:
    """Single background thread that drains the queue, forms waves, drives
    the engine, and resolves futures."""

    def __init__(
        self,
        service: "GraphQueryService",
        *,
        max_linger_s: float = 0.005,
        coalesce: bool = True,
        deadline_margin: float = 2.0,
        est_service_s: float = 0.05,
    ):
        if max_linger_s < 0:
            raise ValueError(f"max_linger_s must be >= 0, got {max_linger_s}")
        self.service = service
        self.max_linger_s = max_linger_s
        self.coalesce = coalesce
        self.deadline_margin = deadline_margin
        # EWMA of per-engine-call service time, per wave class (seeds the
        # deadline-pressure trigger before the first measurement)
        self._est: Dict[str, float] = {
            cls: est_service_s for cls in WAVE_CLASSES
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="wave-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        # wake a thread parked in queue.wait(None) — direct stop() must
        # not depend on the service having closed the queue first
        self.service.queue.kick()
        if join and self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def dead(self) -> bool:
        """Started but no longer running (crash or un-joined stop) — new
        submissions must fail fast rather than queue forever."""
        return self._thread is not None and not self._thread.is_alive()

    # --- wave formation policy --------------------------------------------

    def wave_width(self, cls: str) -> int:
        """Distinct roots that fill a wave (the full-wave trigger).  §19
        program classes are width-1: every rider shares ONE global result,
        so a single pending request already fills the 'wave'."""
        if not self.coalesce or cls == "bc" or cls in PROGRAM_ALGOS:
            return 1
        return self.service.engine.lanes

    def _trigger_t(self, cls: str, reqs: List[QueryRequest]) -> float:
        """Absolute time of the group's earliest linger/deadline trigger.
        The linger clock runs on the OLDEST submission; the deadline budget
        is the TIGHTEST across the whole group (a late-arriving urgent
        request must not wait out an earlier relaxed one's linger)."""
        t = reqs[0].submit_t + self.max_linger_s
        margin = self._est[cls] * self.deadline_margin
        for r in reqs:
            if r.deadline_t is not None:
                t = min(t, r.deadline_t - margin)
        return t

    def _ready(self, cls: str, reqs: List[QueryRequest], now: float) -> bool:
        if not reqs:
            return False
        if len({r.root for r in reqs}) >= self.wave_width(cls):
            return True
        return now >= self._trigger_t(cls, reqs)

    def _next_timeout(
        self, pending: Dict[str, List[QueryRequest]], now: float
    ) -> Optional[float]:
        """Seconds until the earliest linger/deadline trigger; None = sleep
        until new work arrives."""
        t_next = None
        for cls, reqs in pending.items():
            if not reqs:
                continue
            t = self._trigger_t(cls, reqs)
            t_next = t if t_next is None else min(t_next, t)
        if t_next is None:
            return None
        return max(t_next - now, 0.0)

    # --- main loop --------------------------------------------------------

    def _run(self) -> None:
        svc = self.service
        pending: Dict[str, List[QueryRequest]] = {
            cls: [] for cls in WAVE_CLASSES
        }
        try:
            with _device_context(svc.device):
                self._run_loop(svc, pending)
        finally:
            # fail-fast on ANY exit — stop() or a crashed loop: futures
            # already drained into `pending` AND futures still sitting in
            # the queue both fail promptly instead of hanging their
            # callers forever (the §17 timeout-audit contract)
            leftovers = [r for reqs in pending.values() for r in reqs]
            leftovers.extend(svc.queue.drain())
            for r in leftovers:
                resolve_future(
                    r.future, exception=ServiceStopped("scheduler stopped")
                )

    def _run_loop(self, svc, pending: Dict[str, List[QueryRequest]]) -> None:
        while True:
            timeout = self._next_timeout(pending, time.monotonic())
            svc.queue.wait(timeout)
            if self._stop.is_set():
                return
            now = time.monotonic()
            for req in svc.queue.drain():
                req.drain_t = now  # queue-wait / coalesce boundary (§18)
                pending[WAVE_CLASS[req.algo]].append(req)
            for cls in WAVE_CLASSES:
                reqs = pending[cls]
                if reqs and self._ready(cls, reqs, now):
                    pending[cls] = []
                    svc.events.emit(
                        "sched", "dispatch",
                        subsystem=svc.telemetry.name,
                        args={"cls": cls, "pending": len(reqs),
                              "trigger": self._trigger_reason(
                                  cls, reqs, now)})
                    try:
                        self._dispatch(cls, reqs)
                    except Exception as exc:  # engine failure: fail the
                        for r in reqs:  # wave, keep serving
                            if not r.future.done() and resolve_future(
                                r.future, exception=exc
                            ):
                                svc.telemetry.record_failed()

    # --- dispatch ---------------------------------------------------------

    def _resolve(self, req: QueryRequest, payload) -> None:
        now = time.monotonic()
        met = req.deadline_t is None or now <= req.deadline_t
        if resolve_future(req.future, result=payload):
            self.service.telemetry.record_completed(
                now - req.submit_t, met, trace_id=req.trace_id)

    def _trigger_reason(self, cls: str, reqs: List[QueryRequest],
                        now: float) -> str:
        """Which §15 dispatch trigger released this wave (for the §21
        scheduler-decision event): full width, linger expiry, or
        deadline pressure."""
        if len({r.root for r in reqs}) >= self.wave_width(cls):
            return "full"
        if now >= reqs[0].submit_t + self.max_linger_s:
            return "linger"
        return "deadline"

    def _dispatch(self, cls: str, reqs: List[QueryRequest]) -> None:
        svc = self.service
        with svc.swap_lock:  # graph swaps wait for in-flight waves
            epoch, engine = svc.state
            now = time.monotonic()

            live: List[QueryRequest] = []
            for r in reqs:
                if r.future.cancelled():
                    continue
                if r.expired(now):
                    if resolve_future(r.future, exception=DeadlineExceeded(
                        f"{r.algo} root={r.root}: deadline passed "
                        "before dispatch"
                    )):
                        svc.telemetry.record_expired()
                elif r.root >= engine.pg.n:
                    # validated at submit against the THEN-current graph; a
                    # swap can shrink n underneath a pending request.  Fail
                    # just this one — never the innocents sharing its wave.
                    if resolve_future(r.future, exception=ValueError(
                        f"root {r.root} out of range after graph swap "
                        f"(n={engine.pg.n})"
                    )):
                        svc.telemetry.record_failed()
                else:
                    live.append(r)
            if not live:
                return

            # second cache probe (a wave since submission may have filled
            # the entry) + duplicate-root fold: one lane per distinct root
            by_root: Dict[int, List[QueryRequest]] = {}
            n_riders = 0
            for r in live:
                hit, value = svc.cache_lookup(epoch, engine, r.algo, r.root)
                if hit:
                    self._resolve(r, value)
                else:
                    group = by_root.setdefault(r.root, [])
                    if group:
                        n_riders += 1
                    group.append(r)
            if not by_root:
                return

            roots = sorted(by_root)
            # §18 stage breakdown: queued-until-drained, then lingered in
            # the coalescing window until this dispatch instant
            t0 = time.monotonic()
            tracer = svc.tracer
            for group in by_root.values():
                for r in group:
                    drain_t = r.drain_t or t0
                    svc.telemetry.record_stage(
                        "queue_wait", drain_t - r.submit_t
                    )
                    svc.telemetry.record_stage("coalesce", t0 - drain_t)
                    if tracer.enabled:
                        tracer.add_span(
                            f"queue-wait:{r.algo}", r.submit_t, drain_t,
                            track="queue", trace_id=r.trace_id,
                            args={"algo": r.algo, "root": r.root},
                        )
                        tracer.add_span(
                            f"coalesce:{cls}", drain_t, t0,
                            track="scheduler", trace_id=r.trace_id,
                            args={"algo": r.algo, "root": r.root},
                        )
            results, engine_waves, offered = self._execute(
                engine, epoch, cls, roots
            )
            dt_engine = time.monotonic() - t0
            svc.telemetry.record_stage("engine", dt_engine)
            if tracer.enabled:
                tracer.add_span(
                    f"wave:{cls}", t0, t0 + dt_engine, track="engine",
                    args={
                        "cls": cls, "roots": len(roots),
                        "engine_waves": engine_waves, "riders": n_riders,
                        "trace_ids": [r.trace_id for g in by_root.values()
                                      for r in g][:8],
                    },
                )
            svc.events.emit(
                "wave", cls, subsystem=svc.telemetry.name,
                # one representative trace_id keeps the event slim; the
                # wave span above carries the fuller list
                trace_id=next((r.trace_id for g in by_root.values()
                               for r in g if r.trace_id), ""),
                args={"roots": len(roots), "engine_waves": engine_waves,
                      "riders": n_riders,
                      "duration_ms": round(dt_engine * 1e3, 3)})
            n_calls = max(1, (engine_waves if cls != "bfs"
                              else -(-len(roots) // self.wave_width(cls))))
            self._est[cls] = (
                0.7 * self._est[cls]
                + 0.3 * dt_engine / n_calls
            )
            svc.telemetry.record_dispatch(
                engine_waves=engine_waves,
                lanes_used=len(roots),
                lanes_offered=offered,
                coalesced_roots=n_riders,
            )
            for root in roots:
                for r in by_root[root]:
                    self._resolve(
                        r, svc.finish_result(epoch, engine, r.algo, root,
                                             results[root])
                    )

    def _execute(self, engine, epoch: int, cls: str, roots: List[int]):
        """Run the engine for the wave's distinct roots; returns
        ``(root -> raw result, engine_waves, lanes_offered)`` and caches
        raw results under the dispatch epoch."""
        svc = self.service
        results = {}
        w0 = engine.stats.waves
        offered = 0
        if cls == "bfs":
            chunk = engine.lanes if self.coalesce else 1
            for lo in range(0, len(roots), chunk):
                part = roots[lo : lo + chunk]
                dist = engine.query(part)
                for root, row in zip(part, dist):
                    row = row.copy()  # a view would pin the whole wave
                    results[root] = row
                    svc.cache.put(
                        result_key(epoch, "bfs", engine.cfg, root), row
                    )
                offered += engine.lanes * max(
                    1, -(-len(part) // engine.lanes)
                )
            waves = engine.stats.waves - w0
        elif cls == "sssp":
            rows = engine.sssp(roots, svc.sssp_cfg)
            for root, row in zip(roots, rows):
                row = row.copy()  # a view would pin the whole batch
                results[root] = row
                svc.cache.put(
                    result_key(epoch, "sssp", svc.sssp_cfg, root), row
                )
            waves = len(roots)  # one min-reduce program run per root
            offered = len(roots)
        elif cls == "bc":
            for root in roots:
                vec = engine.betweenness([root])
                results[root] = vec
                svc.cache.put(
                    result_key(epoch, "bc", engine.cfg, root), vec
                )
            waves = engine.stats.waves - w0
            offered = engine.lanes * len(roots)
        elif cls in PROGRAM_ALGOS:
            # one global result per epoch: every rider (all roots fold to
            # 0 at submit) resolves from the same converged vector
            cfg = svc.program_cfg
            vec = engine.vertex_program(cls, cfg)
            for root in roots:
                results[root] = vec
                svc.cache.put(result_key(epoch, cls, cfg, root), vec)
            waves = 1
            offered = 1
        else:  # pragma: no cover
            raise AssertionError(f"unknown wave class {cls!r}")
        return results, waves, offered
