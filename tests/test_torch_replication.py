"""PyTorch port, fault-tolerant replicated serving: router, replicas,
chaos (DESIGN.md §17).

``parse_chaos``, its rejects and the injector's schedule for a seed equal
the reference's, and ``serve_graph --replicas 2 --stats-json`` writes the
reference's keys.  Then the reference's cases, against the port's replicas
(``device="cpu"``, P = 8, Kronecker scale 9): the heartbeat loop DISABLED
(``heartbeat_interval_s=None``) so every health transition and catch-up is
driven explicitly and the fault schedules and counters are deterministic;
one of two replicas killed mid-wave under load with ZERO failed client
futures; drop/delay/dup/corrupt/out-of-order deliveries and their catch-up
repairs; degraded mode; the hedge; router admission; stop; the version
gate by a seeded random walk over stub replicas (and Hypothesis where
installed); and the device lock that replicas on one device share.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from repro_torch.core import bfs
from repro_torch.graph import csr, generators
from repro_torch.service import (
    AdmissionError,
    ChaosSpecError,
    FaultInjector,
    NoQuorumError,
    Replica,
    ReplicaRouter,
    ReplicaUnavailable,
    RoutedResult,
    ServiceStopped,
    parse_chaos,
)
from repro_torch.service.replica import DEAD, HEALTHY, RECOVERING, SUSPECT

INF32 = np.iinfo(np.int32).max
LANES = 8
RESULT_S = 120.0  # generous future timeout: programs are built on first touch


def _norm(d):
    return np.where(np.asarray(d) >= INF32, -1, np.asarray(d))


@pytest.fixture(scope="module")
def graph():
    return generators.kronecker(9, 8, seed=1, max_weight=16)


@pytest.fixture(scope="module")
def cfg():
    return bfs.BFSConfig(fanout=4)


def _replicas(graph, cfg, n=2, **service_kw):
    service_kw.setdefault("max_linger_s", 0.005)
    return [
        Replica(i, graph, 8, cfg, device="cpu", lanes=LANES,
                n_real=graph.n_real, service_kw=service_kw)
        for i in range(n)
    ]


def _roots(graph, count):
    return [int(r) for r in csr.largest_component_roots(
        graph, count, np.random.default_rng(0)
    )]


def _batch(replicas, seed, n_insert=24, n_delete=8):
    """A random mutation batch sampled against replica 0's current edge
    set (the batch itself is just edges — replica-independent)."""
    return replicas[0].svc.overlay.sample_batch(
        np.random.default_rng(seed), n_insert, n_delete, max_weight=16
    )


def _wait_until(cond, timeout_s=10.0):
    """Poll for a condition that a future's done-callback sets — callbacks
    run after ``result()``'s waiter is released, so counter asserts need a
    bounded wait, not an instant read."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError("condition not met within bound")
        time.sleep(0.005)


class _StubReplica:
    """Duck-typed replica for router unit/property tests: no engine, no
    torch — ``submit`` resolves immediately with ``(id, applied_seq, root)``
    so invariants are checkable without building programs."""

    class _G:
        n = 64

    def __init__(self, replica_id):
        self.id = replica_id
        self.base_graph = self._G()
        self.state = HEALTHY
        self.strikes = 0
        self.suspect_until = 0.0
        self.applied_seq = 0
        self.kills = 0
        self.recoveries = 0

    @property
    def serving(self):
        return self.state in (HEALTHY, SUSPECT)

    @property
    def version(self):
        return f"0.{self.applied_seq}"

    def submit(self, algo, root, deadline_s=None):
        from concurrent.futures import Future

        if not self.serving:
            raise ReplicaUnavailable(f"stub {self.id} is {self.state}")
        f = Future()
        f.set_result((self.id, self.applied_seq, int(root)))
        return f

    def heartbeat(self):
        return self.serving

    def apply_log(self, seq, batch):
        if seq <= self.applied_seq:
            return "duplicate"
        if seq > self.applied_seq + 1:
            return "held"
        self.applied_seq = seq
        return "applied"

    def mark_suspect(self, backoff_s, now):
        if self.state == HEALTHY:
            self.state = SUSPECT
        self.strikes += 1
        self.suspect_until = now + backoff_s * (2 ** (self.strikes - 1))

    def mark_healthy(self):
        if self.state in (HEALTHY, SUSPECT):
            self.state = HEALTHY
            self.strikes = 0

    def mark_dead(self):
        self.state = DEAD

    def kill(self):
        self.state = DEAD
        self.kills += 1

    def recover(self, log):
        self.state = RECOVERING
        self.applied_seq = 0
        for seq, _ in log:
            self.applied_seq = seq
        self.state = HEALTHY
        self.recoveries += 1

    def stop(self):
        self.state = DEAD

    def snapshot(self):
        return {"id": self.id, "state": self.state,
                "applied_seq": self.applied_seq, "serving": self.serving}


class _HoldReplica(_StubReplica):
    """Stub whose submissions stay in flight until the test releases
    them — makes admission occupancy exact."""

    def __init__(self, replica_id):
        super().__init__(replica_id)
        self.pending = []

    def submit(self, algo, root, deadline_s=None):
        from concurrent.futures import Future

        if not self.serving:
            raise ReplicaUnavailable(f"stub {self.id} is {self.state}")
        f = Future()
        self.pending.append((f, (self.id, self.applied_seq, int(root))))
        return f

    def release_all(self):
        pending, self.pending = self.pending, []
        for f, value in pending:
            f.set_result(value)


# --- chaos spec parsing -----------------------------------------------------


def test_parse_chaos_grammar_and_determinism():
    spec = "kill-one@op=20; stall@op=8:ms=250; drop-batch@batch=2; corrupt"
    a = parse_chaos(spec, seed=7, n_replicas=4)
    b = parse_chaos(spec, seed=7, n_replicas=4)
    assert a == b  # pure function of (spec, seed, n_replicas)
    assert [f.kind for f in a] == [
        "kill-replica", "stall-wave", "drop-batch", "corrupt-batch"
    ]
    assert a[0].at == 20 and a[1].at == 8
    assert a[1].delay_s == pytest.approx(0.25)
    assert all(0 <= f.victim < 4 for f in a)
    assert parse_chaos(spec, seed=8, n_replicas=4) != a  # seed moves victims
    assert parse_chaos(None, 0, 2) == [] and parse_chaos("", 0, 2) == []


@pytest.mark.parametrize("bad", [
    "explode@op=1",            # unknown kind
    "kill-one@12",             # trigger missing op=/batch=
    "kill-one@batch=3",        # kill triggers on ops, not batches
    "drop-batch@op=3",         # drop triggers on batches, not ops
    "kill-one@op=0",           # 1-based indices
    "stall@op=2:warp=9",       # unknown param
    "stall@op=2:ms",           # param missing '='
])
def test_parse_chaos_rejects(bad):
    with pytest.raises(ChaosSpecError):
        parse_chaos(bad, seed=0, n_replicas=2)


def test_injector_counters_are_schedule_deterministic():
    spec = "kill-one@op=3;drop@batch=1;dup@batch=2"
    runs = []
    for _ in range(2):
        inj = FaultInjector.from_spec(spec, seed=11, n_replicas=3)
        for op in range(1, 6):
            inj.on_op(op)
        for seq in (1, 2):
            for rep in range(3):
                inj.on_batch(seq, rep)
        runs.append((inj.schedule_json(), inj.snapshot()))
    assert runs[0] == runs[1]
    assert runs[0][1]["kill-replica"] == 1
    assert runs[0][1]["drop-batch"] == 1 and runs[0][1]["dup-batch"] == 1


# --- headline chaos: kill a replica mid-wave --------------------------------


def test_kill_replica_mid_wave_zero_failed_futures(graph, cfg):
    """THE §17 acceptance test: two replicas under load, one killed
    mid-stream by the injector.  Every client future must resolve with a
    correct, version-gated result (zero failures); the killed replica must
    rejoin via log catch-up and serve again."""
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("kill-one@op=9", seed=3, n_replicas=2)
    router = ReplicaRouter(
        reps, timeout_s=30.0, heartbeat_interval_s=None, injector=inj,
        suspect_backoff_s=0.01,
    )
    try:
        seq = router.apply_updates(_batch(reps, seed=5))
        roots = _roots(graph, 6)
        futs = [router.submit("bfs", r, min_seq=seq, tenant=f"t{i % 2}")
                for i, r in enumerate(roots * 4)]  # 24 ops: kill at #9
        results = [f.result(RESULT_S) for f in futs]

        assert inj.snapshot()["kill-replica"] == 1
        victim = reps[inj.faults[0].victim]
        assert victim.kills == 1
        # zero failed futures, zero version-gate violations, no stale serves
        assert all(isinstance(r, RoutedResult) for r in results)
        assert all(not r.stale and r.seq >= seq for r in results)
        # correctness: every answer matches the post-mutation oracle
        g1 = reps[1 - victim.id].svc.overlay.current_graph()
        for root, res in zip(roots, results[:len(roots)]):
            np.testing.assert_array_equal(
                _norm(res.value), _norm(bfs.bfs_reference(g1, root))
            )
        _wait_until(lambda: router.snapshot()["completed"] == len(futs))
        snap = router.snapshot()
        assert snap["failed"] == 0
        assert snap["faults"]["injected"]["kill-replica"] == 1

        # the killed replica rejoins via base-graph rebuild + log replay
        assert victim.state == DEAD
        router.health_sweep()
        assert victim.state == HEALTHY
        assert victim.applied_seq == router.latest_seq == seq
        assert victim.recoveries == 1
        d = victim.submit("bfs", roots[0]).result(RESULT_S)
        np.testing.assert_array_equal(
            _norm(d), _norm(bfs.bfs_reference(g1, roots[0]))
        )
    finally:
        router.stop()


def test_chaos_schedule_identical_across_runs(graph, cfg):
    """Same ``--chaos`` spec + seed twice -> byte-identical fault schedule
    AND byte-identical injected counters after identical event streams."""
    spec = "kill-one@op=4;corrupt-batch@batch=1"
    outcomes = []
    for _ in range(2):
        reps = _replicas(graph, cfg, n=2)
        inj = FaultInjector.from_spec(spec, seed=13, n_replicas=2)
        router = ReplicaRouter(
            reps, heartbeat_interval_s=None, injector=inj,
        )
        try:
            router.apply_updates(_batch(reps, seed=2))
            roots = _roots(graph, 3)
            futs = [router.submit("bfs", r) for r in roots * 2]
            for f in futs:
                f.result(RESULT_S)
            outcomes.append(
                (inj.schedule_json(), inj.snapshot(),
                 [r.snapshot()["rejected_batches"] for r in reps])
            )
        finally:
            router.stop()
    assert outcomes[0] == outcomes[1]


# --- replication-log delivery faults ----------------------------------------


def test_drop_batch_repaired_by_catch_up(graph, cfg):
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("drop-batch@batch=1", seed=1,
                                  n_replicas=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None, injector=inj)
    try:
        victim = reps[inj.faults[0].victim]
        other = reps[1 - victim.id]
        seq = router.apply_updates(_batch(reps, seed=7))
        assert victim.applied_seq == 0 and other.applied_seq == seq
        # the version gate refuses the lagging replica meanwhile
        res = router.query("bfs", _roots(graph, 1)[0], min_seq=seq,
                           timeout=RESULT_S)
        assert res.replica == other.id and res.seq >= seq
        applied = router.catch_up_now()
        assert applied == 1 and victim.applied_seq == seq
        assert router.snapshot()["faults"]["catch_up_batches"] == 1
    finally:
        router.stop()


def test_duplicate_batch_is_suppressed(graph, cfg):
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("dup-batch@batch=1", seed=4, n_replicas=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None, injector=inj)
    try:
        victim = reps[inj.faults[0].victim]
        seq = router.apply_updates(_batch(reps, seed=9))
        assert victim.applied_seq == seq  # applied exactly once
        assert victim.dup_batches == 1  # second delivery suppressed
        # both replicas converge to the same served graph
        r0 = reps[0].svc.overlay.current_graph()
        r1 = reps[1].svc.overlay.current_graph()
        np.testing.assert_array_equal(r0.src, r1.src)
        np.testing.assert_array_equal(r0.dst, r1.dst)
    finally:
        router.stop()


def test_corrupt_batch_rejected_then_repaired(graph, cfg):
    """A corrupted delivery must be rejected by validation WITHOUT
    advancing the log position, so catch-up redelivers the pristine copy
    from the router's log and the replica converges."""
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("corrupt-batch@batch=1", seed=6,
                                  n_replicas=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None, injector=inj)
    try:
        victim = reps[inj.faults[0].victim]
        seq = router.apply_updates(_batch(reps, seed=1))
        assert victim.rejected_batches == 1
        assert victim.applied_seq == 0  # position NOT advanced
        assert router.catch_up_now() == 1
        assert victim.applied_seq == seq and victim.rejected_batches == 1
        g0 = reps[0].svc.overlay.current_graph()
        g1 = reps[1].svc.overlay.current_graph()
        np.testing.assert_array_equal(g0.src, g1.src)
        np.testing.assert_array_equal(g0.dst, g1.dst)
    finally:
        router.stop()


def test_delayed_batch_applies_late(graph, cfg):
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("delay-batch@batch=1:ms=80", seed=2,
                                  n_replicas=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None, injector=inj)
    try:
        victim = reps[inj.faults[0].victim]
        seq = router.apply_updates(_batch(reps, seed=4))
        # delivery is in a timer; the replica lags NOW but converges
        deadline = time.monotonic() + 10.0
        while victim.applied_seq < seq and time.monotonic() < deadline:
            time.sleep(0.01)
        assert victim.applied_seq == seq
    finally:
        router.stop()


def test_out_of_order_batches_held_then_drained(graph, cfg):
    """Replica-boundary reordering: seq 2 before seq 1 parks in holdback
    and drains once the gap fills."""
    reps = _replicas(graph, cfg, n=1)
    rep = reps[0]
    try:
        b1, b2 = _batch(reps, seed=1), _batch(reps, seed=2)
        assert rep.apply_log(2, b2) == "held"
        assert rep.applied_seq == 0 and rep.held_batches == 1
        assert rep.apply_log(1, b1) == "applied"
        assert rep.applied_seq == 2  # holdback drained
        assert rep.apply_log(1, b1) == "duplicate"
    finally:
        rep.stop()


# --- degraded mode + hedging ------------------------------------------------


def test_degraded_mode_serves_stale_with_explicit_flag(graph, cfg):
    """Quorum lost: a warm key serves from the stale-read cache with
    ``stale=True``; a cold key fails with NoQuorumError."""
    reps = _replicas(graph, cfg, n=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None,
                           auto_recover=False)
    try:
        warm, cold = _roots(graph, 2)
        fresh = router.query("bfs", warm, timeout=RESULT_S)
        assert not fresh.stale
        # the stale cache fills in the client future's done-callback
        _wait_until(lambda: router._stale_get("bfs", warm) is not None)
        for r in reps:
            r.kill()
        res = router.query("bfs", warm, timeout=RESULT_S)
        assert res.stale and res.replica == -1
        np.testing.assert_array_equal(
            np.asarray(res.value), np.asarray(fresh.value)
        )
        with pytest.raises(NoQuorumError):
            router.query("bfs", cold, timeout=RESULT_S)
        _wait_until(
            lambda: router.snapshot()["faults"]["stale_serves"] == 1
        )
        assert router.snapshot()["n_serving"] == 0
    finally:
        router.stop()


def test_stalled_wave_is_hedged_to_another_replica(graph, cfg):
    """A stall fault routes one op to a victim and sits on it past the
    router timeout; the monitor fires ONE hedge to a different replica and
    the client still gets a fresh result."""
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("stall@op=1:ms=2000", seed=5,
                                  n_replicas=2)
    router = ReplicaRouter(
        reps, timeout_s=0.25, hard_timeout_factor=200.0,
        heartbeat_interval_s=None, injector=inj, suspect_backoff_s=0.05,
    )
    try:
        root = _roots(graph, 1)[0]
        res = router.submit("bfs", root).result(RESULT_S)
        assert res.hedged and not res.stale
        assert res.replica != inj.faults[0].victim
        np.testing.assert_array_equal(
            _norm(res.value), _norm(bfs.bfs_reference(graph, root))
        )
        snap = router.snapshot()
        assert snap["faults"]["hedges"] == 1
        assert snap["faults"]["injected"]["stall-wave"] == 1
    finally:
        router.stop()


def test_hedge_goes_to_a_backed_off_replica_when_no_other_is_eligible(graph, cfg):
    """Every replica but the stalled primary sits out a backoff: the hedge
    still goes to one of them (the reference drops it and leaves the
    request to the hard timeout, which on a loaded host broke the chaos
    showcase's exemplar), and the client gets the hedged, fresh result."""
    reps = _replicas(graph, cfg, n=2)
    inj = FaultInjector.from_spec("stall@op=1:ms=2000", seed=5,
                                  n_replicas=2)
    router = ReplicaRouter(
        reps, timeout_s=0.25, hard_timeout_factor=200.0,
        heartbeat_interval_s=None, injector=inj, suspect_backoff_s=0.05,
    )
    try:
        victim = inj.faults[0].victim
        other = reps[1 - victim]
        other.mark_suspect(60.0, time.monotonic())  # backed off for a minute
        root = _roots(graph, 1)[0]
        res = router.submit("bfs", root).result(RESULT_S)
        assert res.hedged and not res.stale and res.replica == other.id
        np.testing.assert_array_equal(
            _norm(res.value), _norm(bfs.bfs_reference(graph, root))
        )
        assert router.snapshot()["faults"]["hedges"] == 1
    finally:
        router.stop()


def test_router_admission_is_structured_and_final():
    """Front-door shedding: global in-flight bound + per-tenant quota
    raise structured AdmissionError; non-retryable rejections are never
    failed over or hedged.  Uses hold-open stub replicas so occupancy is
    exact, not a race against wave completion."""
    reps = [_HoldReplica(0), _HoldReplica(1)]
    router = ReplicaRouter(reps, heartbeat_interval_s=None, max_inflight=3,
                           tenant_quotas={"small": 1}, timeout_s=30.0)
    try:
        held = [router.submit("bfs", 0, tenant="small"),
                router.submit("bfs", 1)]
        with pytest.raises(AdmissionError) as quota:
            router.submit("bfs", 3, tenant="small")
        assert quota.value.tenant == "small"
        assert quota.value.occupancy == 1 and quota.value.quota == 1
        held.append(router.submit("bfs", 2))
        with pytest.raises(AdmissionError) as over:
            router.submit("bfs", 4)
        assert over.value.retryable is True
        assert over.value.occupancy == 3 and over.value.quota == 3
        for r in reps:
            r.release_all()
        for f in held:
            assert not f.result(RESULT_S).stale
        _wait_until(lambda: router.snapshot()["inflight"] == 0)
        assert router.snapshot()["faults"]["shed"] == 2
    finally:
        router.stop()


def test_non_retryable_rejection_is_terminal():
    """A replica-side non-retryable AdmissionError (e.g. unmeetable
    deadline) must reach the client verbatim — no failover, no hedge:
    repeating a rejected-as-submitted request is not idempotent-safe."""

    class _Rejecting(_StubReplica):
        def submit(self, algo, root, deadline_s=None):
            raise AdmissionError(
                "deadline unmeetable", occupancy=0, quota=1,
                retryable=False,
            )

    reps = [_Rejecting(0), _Rejecting(1)]
    router = ReplicaRouter(reps, heartbeat_interval_s=None, timeout_s=30.0)
    try:
        with pytest.raises(AdmissionError) as exc:
            router.query("bfs", 0, timeout=10.0)
        assert exc.value.retryable is False
        # the failure path runs synchronously for a raising stub, so the
        # counters are settled: no failover, no hedge
        faults = router.snapshot()["faults"]
        assert faults["retries"] == 0 and faults["hedges"] == 0
    finally:
        router.stop()


# --- version-gate property --------------------------------------------------


def _gate_walk(seed, n_replicas=3, n_ops=200):
    """Random walk over mutations/kills/recoveries/queries; returns the
    list of (min_seq, result-or-exception) observations."""
    rng = np.random.default_rng(seed)
    reps = [_StubReplica(i) for i in range(n_replicas)]
    router = ReplicaRouter(
        reps, heartbeat_interval_s=None, timeout_s=30.0,
        auto_recover=False,
    )
    obs = []
    try:
        for _ in range(n_ops):
            op = rng.integers(5)
            if op == 0:
                router.apply_updates(object())
            elif op == 1 and any(r.serving for r in reps):
                reps[int(rng.integers(n_replicas))].kill()
            elif op == 2:
                router.health_sweep()
                for r in reps:
                    if r.state == DEAD and rng.integers(2):
                        r.recover(router.log_entries())
            elif op == 3:  # one replica falls behind (skip a delivery)
                lag = reps[int(rng.integers(n_replicas))]
                lag.applied_seq = max(0, lag.applied_seq
                                      - int(rng.integers(3)))
            else:
                min_seq = int(rng.integers(router.latest_seq + 1))
                root = int(rng.integers(8))
                try:
                    res = router.query("bfs", root, timeout=10.0,
                                       min_seq=min_seq)
                    obs.append((min_seq, root, res))
                except (NoQuorumError, ReplicaUnavailable) as exc:
                    obs.append((min_seq, root, exc))
    finally:
        router.stop()
    return obs


def _assert_gate_invariant(obs):
    """No fresh result below the read version; stale results come only
    from degraded mode (replica == -1) and echo a previously FRESH value
    for the same root."""
    fresh_seen = {}
    n_queries = 0
    for min_seq, root, res in obs:
        if isinstance(res, Exception):
            continue
        n_queries += 1
        if not res.stale:
            assert res.seq >= min_seq, (
                f"version-gate violation: served seq {res.seq} < "
                f"read version {min_seq}"
            )
            rid, seq_at_serve, r = res.value
            assert rid == res.replica and r == root
            assert seq_at_serve == res.seq
            fresh_seen[root] = res.value
        else:
            assert res.replica == -1 and res.version == ""
            assert fresh_seen.get(root) == res.value, (
                "stale serve must echo the last fresh value for the root"
            )
    assert n_queries > 0  # the walk must actually exercise queries


def test_version_gate_random_walk_property():
    for seed in range(6):
        _assert_gate_invariant(_gate_walk(seed))


def test_version_gate_walk_is_deterministic():
    a = _gate_walk(42)
    b = _gate_walk(42)
    assert [(m, r, type(x).__name__,
             x.seq if isinstance(x, RoutedResult) else str(x))
            for m, r, x in a] == \
           [(m, r, type(x).__name__,
             x.seq if isinstance(x, RoutedResult) else str(x))
            for m, r, x in b]


def test_version_gate_hypothesis_property():
    """The same invariant under Hypothesis-driven op sequences (skipped
    when hypothesis is not installed; the seeded walk above always runs)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=20, deadline=None)
    @hyp.given(seed=st.integers(min_value=0, max_value=2**32 - 1))
    def inner(seed):
        _assert_gate_invariant(_gate_walk(seed, n_ops=60))

    inner()


# --- teardown semantics -----------------------------------------------------


def test_router_stop_fails_outstanding_futures(graph, cfg):
    reps = [_StubReplica(0)]
    reps[0].state = DEAD  # nothing can serve; ticket waits on the monitor
    router = ReplicaRouter(reps, heartbeat_interval_s=None,
                           timeout_s=30.0, auto_recover=False)
    try:
        with pytest.raises((NoQuorumError, ServiceStopped)):
            router.query("bfs", 0, timeout=5.0)
    finally:
        router.stop()
    with pytest.raises(ServiceStopped):
        router.submit("bfs", 0)


# --- serve_graph --stats-json faults schema ---------------------------------

FAULT_KEYS = {
    "injected", "schedule", "retries", "hedges", "failovers",
    "recoveries", "shed", "stale_serves", "catch_up_batches",
    "suspect_marks",
}


def test_serve_graph_stats_json_faults_schema(tmp_path):
    """Both serving paths emit the same ``faults`` telemetry block: the
    replicated+chaos path with real counts, the single-service path
    zeroed — so dashboards never branch on the config."""
    from repro_torch.launch import serve_graph

    rep_stats = tmp_path / "replicated.json"
    assert serve_graph.main([
        "--scale", "8", "--ranks", "2", "--device", "cpu", "--lanes", "4",
        "--qps", "40", "--duration", "0.5",
        "--replicas", "2", "--chaos", "kill-one@op=6",
        "--chaos-seed", "3", "--mutate-rate", "4", "--mutate-edges", "4",
        "--stats-json", str(rep_stats),
    ]) == 0
    doc = json.loads(rep_stats.read_text())
    assert doc["config"]["replicas"] == 2
    assert doc["config"]["chaos"] == "kill-one@op=6"
    fb = doc["telemetry"]["faults"]
    assert set(fb) == FAULT_KEYS
    assert fb["injected"].get("kill-replica") == 1
    assert fb["schedule"] == [
        {"kind": "kill-replica", "at": 6, "victim": fb["schedule"][0]["victim"],
         "delay_s": 0.0}]
    assert doc["telemetry"]["completed"] >= 1
    assert doc["telemetry"]["failed"] == 0

    solo_stats = tmp_path / "solo.json"
    assert serve_graph.main([
        "--scale", "8", "--ranks", "2", "--device", "cpu", "--lanes", "4",
        "--qps", "40", "--duration", "0.5",
        "--stats-json", str(solo_stats),
    ]) == 0
    doc = json.loads(solo_stats.read_text())
    assert doc["config"]["replicas"] == 1 and doc["config"]["chaos"] == ""
    fb = doc["telemetry"]["faults"]
    assert set(fb) == FAULT_KEYS
    assert fb["schedule"] == [] and sum(fb["injected"].values()) == 0




# --- parity with the reference ----------------------------------------------


@pytest.mark.parametrize("spec", [
    "kill-one@op=20; stall@op=8:ms=250; drop-batch@batch=2; corrupt",
    "kill-one@op=3;drop@batch=1;dup@batch=2;delay@batch=3:ms=40;stall@op=5:ms=10",
    "kill-one@op=20",
])
@pytest.mark.parametrize("seed", [0, 7])
def test_parse_chaos_and_schedule_equal_the_reference(spec, seed):
    from repro.service import faults as ref_faults
    from repro_torch.service import faults

    assert [dataclasses.asdict(f) for f in parse_chaos(spec, seed, 3)] == \
        [dataclasses.asdict(f) for f in ref_faults.parse_chaos(spec, seed, 3)]
    runs = []
    for mod in (faults, ref_faults):
        inj = mod.FaultInjector.from_spec(spec, seed=seed, n_replicas=3)
        for op in range(1, 25):
            inj.on_op(op)
        for seq in range(1, 6):
            for rep in range(3):
                inj.on_batch(seq, rep)
        runs.append((inj.schedule_json(), inj.snapshot()))
    assert runs[0] == runs[1]
    assert faults.KINDS == ref_faults.KINDS


@pytest.mark.parametrize("bad", [
    "explode@op=1", "kill-one@12", "kill-one@batch=3", "drop-batch@op=3",
    "kill-one@op=0", "stall@op=2:warp=9", "stall@op=2:ms",
])
def test_parse_chaos_rejects_as_the_reference(bad):
    from repro.service import faults as ref_faults

    with pytest.raises(ChaosSpecError) as got:
        parse_chaos(bad, seed=0, n_replicas=2)
    with pytest.raises(ref_faults.ChaosSpecError) as want:
        ref_faults.parse_chaos(bad, seed=0, n_replicas=2)
    assert str(got.value) == str(want.value)


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def test_serve_graph_stats_json_has_the_reference_keys(tmp_path):
    from repro.launch import serve_graph as ref_serve_graph
    from repro_torch.launch import serve_graph

    args = ["--scale", "8", "--lanes", "4", "--qps", "40", "--duration", "0.5",
            "--replicas", "2", "--chaos", "kill-one@op=6", "--chaos-seed", "3",
            "--mutate-rate", "4", "--mutate-edges", "4"]
    assert serve_graph.main(args + ["--ranks", "2", "--device", "cpu", "--stats-json",
                                    str(tmp_path / "got.json")]) == 0
    assert ref_serve_graph.main(args + ["--devices", "2", "--stats-json",
                                        str(tmp_path / "want.json")]) == 0
    got = json.loads((tmp_path / "got.json").read_text())
    want = json.loads((tmp_path / "want.json").read_text())
    assert got["schema"] == want["schema"] == "serve_graph_stats/v2"
    # the injected counts are keyed by the faults that fired
    for doc in (got, want):
        doc["telemetry"]["faults"]["injected"] = {}
    assert _key_tree(got) == _key_tree(want)
    assert got["telemetry"]["faults"]["schedule"] == want["telemetry"]["faults"]["schedule"]
    assert got["telemetry"]["failed"] == 0


# --- the device lock (repro_torch.core.devlock) -----------------------------


def test_device_lock_keyed_by_device():
    import torch

    from repro_torch.core.devlock import device_lock

    assert device_lock("cpu") is device_lock(torch.device("cpu"))
    assert device_lock("cpu") is device_lock("cpu:0")
    assert device_lock("cuda:0") is device_lock(torch.device("cuda", 0))
    assert device_lock("cuda:0") is not device_lock("cuda:1")
    assert device_lock("cpu") is not device_lock("cuda:0")


def test_replicas_on_one_device_share_its_lock_and_both_serve(graph, cfg):
    """Replicas on one device (the counterpart of replicas over one mesh)
    take the device's one lock, so their waves run one at a time; both
    still take load and every answer is right."""
    from repro_torch.core.devlock import device_lock

    reps = [
        Replica(i, graph, 4, cfg, device="cpu", lanes=LANES,
                n_real=graph.n_real, service_kw={"max_linger_s": 0.005})
        for i in range(2)
    ]
    router = ReplicaRouter(reps, heartbeat_interval_s=None)
    try:
        assert device_lock(reps[0].device) is device_lock(reps[1].device)
        roots = _roots(graph, 12)
        futs = [router.submit("bfs", r) for r in roots]
        want = {r: _norm(bfs.bfs_reference(graph, r)) for r in set(roots)}
        for r, f in zip(roots, futs):
            res = f.result(RESULT_S)
            assert not res.stale
            np.testing.assert_array_equal(_norm(res.value), want[r])
        served = {r.id for r in reps if r.svc.telemetry.snapshot()["completed"]}
        assert served == {0, 1}  # both replicas actually took load
    finally:
        router.stop()


def test_a_stopped_router_frees_its_replicas(graph, cfg):
    """The router's replication-lag gauges hold the router and its replicas
    weakly, so a stopped router's replicas (and their engines' placed
    arrays) are freed."""
    import gc
    import weakref

    reps = _replicas(graph, cfg, n=2)
    router = ReplicaRouter(reps, heartbeat_interval_s=None)
    try:
        router.query("bfs", _roots(graph, 1)[0], timeout=RESULT_S)
        engines = [weakref.ref(r.svc.engine) for r in reps]
    finally:
        router.stop()
    del router, reps
    gc.collect()
    assert [e() is None for e in engines] == [True, True]
