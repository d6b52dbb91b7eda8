"""PyTorch port, the cross-stack request-tracing layer (DESIGN.md §18):
the same call sequence through ``repro.core.tracing`` and the port's copy
gives equal span documents (modulo ids and timestamps); then the
reference's own cases, run against the port: the span/instant collector, the Chrome/Perfetto + JSONL exporters, the
hand-rolled schema validator and its CLI gate, and the telemetry
regressions that rode along with the observability PR (snapshot-extra
collision guard, empty-window qps, per-stage reservoirs).

The port's side is stdlib only; the reference module is imported for
the parity case alone.
"""

import json
import os
import threading

import pytest

from repro_torch.core import tracing
from repro_torch.core.tracing import NULL_TRACER, Tracer, validate_schema
from repro_torch.service.telemetry import STAGES, Telemetry


# ---------------------------------------------------------------------------
# parity with the reference module
# ---------------------------------------------------------------------------


def _drive(mod):
    """One call sequence on a clocked tracer: spans, instants, a context
    span that raises, cleared and refilled; returns its Chrome document
    and its raw events."""
    ticks = iter([100.0 + 0.25 * i for i in range(64)]).__next__
    tr = mod.Tracer(clock=ticks)
    tid = tr.new_trace_id()
    tr.add_span("queue-wait:bfs", 100.1, 100.3, track="queue", trace_id=tid,
                args={"algo": "bfs", "root": 7})
    tr.instant("cache-hit:bfs", track="queue", trace_id=tid, args={"root": 7})
    with tr.span("wave:bfs", track="engine", args={"roots": 3}) as sp:
        sp.args["engine_waves"] = 1
    with pytest.raises(RuntimeError):
        with tr.span("wave:sssp", track="engine", trace_id=tid):
            raise RuntimeError("boom")
    tr.add_span("backwards", 101.0, 100.5, track="router", cat="chaos")
    tr.instant("replica-killed", track="replica-1", cat="chaos",
               args={"kills": 1}, t=100.9)
    return tr.to_chrome(), tr.events()


def _strip_ids(obj):
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ("span_id", "trace_id")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


def test_chrome_and_events_equal_the_reference_modulo_ids():
    from repro.core import tracing as ref_tracing

    got_doc, got_ev = _drive(tracing)
    want_doc, want_ev = _drive(ref_tracing)
    assert _strip_ids(got_doc) == _strip_ids(want_doc)
    assert _strip_ids(got_ev) == _strip_ids(want_ev)
    # the ids keep their shapes: 16-hex trace ids, 8-hex span ids
    assert [len(e.get("trace_id", "")) for e in got_ev] == \
        [len(e.get("trace_id", "")) for e in want_ev]
    schema = json.load(open(os.path.join(os.path.dirname(__file__), "trace_schema.json")))
    assert validate_schema(got_doc, schema) == []
    assert ref_tracing.validate_schema(got_doc, schema) == []

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")


def _schema():
    with open(SCHEMA_PATH) as f:
        return json.load(f)


def _torch_schema():
    """The port's own schema: the repo's, with the span ids typed."""
    with open(os.path.join(os.path.dirname(__file__), "torch_trace_schema.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Tracer core
# ---------------------------------------------------------------------------


def test_add_span_and_instant_record_relative_microseconds():
    t = iter([10.0, 10.5]).__next__  # constructor reads t0=10.0, instant 10.5
    tr = Tracer(clock=t)
    tr.add_span("wave", 10.1, 10.2, track="engine", cat="serve",
                trace_id="abc", args={"roots": 3})
    tr.instant("hedge", track="router")
    evs = tr.events()
    assert len(tr) == 2 and len(evs) == 2
    span, inst = evs
    assert span["kind"] == "span"
    assert span["ts_us"] == 100_000 and span["dur_us"] == 100_000
    assert span["track"] == "engine" and span["trace_id"] == "abc"
    assert span["args"] == {"roots": 3}
    assert inst["kind"] == "instant"
    assert inst["ts_us"] == 500_000 and inst["dur_us"] == 0


def test_span_context_manager_measures_and_mutates_args():
    clock = iter([0.0, 1.0, 3.0]).__next__
    tr = Tracer(clock=clock)
    with tr.span("work", track="engine", args={"fixed": 1}) as sp:
        sp.args["added"] = 2
    (ev,) = tr.events()
    assert ev["ts_us"] == 1_000_000 and ev["dur_us"] == 2_000_000
    assert ev["args"] == {"fixed": 1, "added": 2}


def test_span_context_manager_annotates_exceptions():
    tr = Tracer(clock=iter([0.0, 0.0, 0.0]).__next__)
    with pytest.raises(KeyError):
        with tr.span("boom"):
            raise KeyError("x")
    (ev,) = tr.events()
    assert ev["args"]["error"] == "KeyError"


def test_negative_duration_clamped_to_zero():
    tr = Tracer(clock=lambda: 0.0)
    tr.add_span("backwards", 2.0, 1.0)
    assert tr.events()[0]["dur_us"] == 0


def test_new_trace_id_is_16_hex_and_unique():
    ids = {Tracer.new_trace_id() for _ in range(64)}
    assert len(ids) == 64
    for tid in ids:
        assert len(tid) == 16
        int(tid, 16)  # hex or raises


def test_clear_and_len():
    tr = Tracer(clock=lambda: 0.0)
    tr.instant("a")
    tr.instant("b")
    assert len(tr) == 2
    tr.clear()
    assert len(tr) == 0 and tr.events() == []


def test_tracer_is_thread_safe():
    tr = Tracer()
    n, workers = 200, 8

    def hammer():
        for i in range(n):
            tr.instant(f"ev{i}", track="t")
            with tr.span("s", track="t"):
                pass

    threads = [threading.Thread(target=hammer) for _ in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(tr) == workers * n * 2


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def test_to_chrome_structure_tracks_and_trace_id_folding():
    tr = Tracer(clock=lambda: 0.0)
    tr.add_span("wave", 0.001, 0.002, track="engine", trace_id="deadbeef")
    tr.instant("chaos", track="router", cat="chaos")
    doc = tr.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["schema"] == tracing.CHROME_SCHEMA
    evs = doc["traceEvents"]
    # "M" thread-name metadata precede the payload events, one per track
    metas = [e for e in evs if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"engine", "router"}
    assert evs[: len(metas)] == metas
    span = next(e for e in evs if e["ph"] == "X")
    assert span["dur"] == 1000 and span["ts"] == 1000
    assert span["args"]["trace_id"] == "deadbeef"  # folded for Perfetto query
    inst = next(e for e in evs if e["ph"] == "i")
    assert inst["s"] == "t"
    # every track maps to a small integer tid shared with its meta record
    assert span["tid"] == next(
        m["tid"] for m in metas if m["args"]["name"] == "engine"
    )


def test_chrome_doc_validates_against_repo_schema():
    tr = Tracer(clock=lambda: 0.0)
    tr.add_span("wave", 0.0, 0.001, track="engine", args={"roots": 2})
    tr.instant("kill", track="router", cat="chaos")
    assert validate_schema(tr.to_chrome(), _schema()) == []


def test_write_chrome_and_jsonl_roundtrip(tmp_path):
    tr = Tracer(clock=lambda: 0.0)
    tr.add_span("a", 0.0, 0.001, track="x")
    tr.instant("b", track="y")
    chrome = str(tmp_path / "trace.json")
    jsonl = str(tmp_path / "trace.jsonl")
    assert tr.write_chrome(chrome) == 2
    assert tr.write_jsonl(jsonl) == 2
    with open(chrome) as f:
        doc = json.load(f)
    assert validate_schema(doc, _schema()) == []
    with open(jsonl) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ev["name"] for ev in lines] == ["a", "b"]
    assert lines[0]["kind"] == "span" and lines[1]["kind"] == "instant"


def test_null_tracer_is_inert():
    assert NULL_TRACER.enabled is False
    assert NULL_TRACER.new_trace_id() == ""
    NULL_TRACER.add_span("x", 0.0, 1.0)
    NULL_TRACER.instant("y")
    with NULL_TRACER.span("z") as sp:
        sp.args["ignored"] = 1  # same surface as the real handle
    assert len(NULL_TRACER) == 0 and NULL_TRACER.events() == []
    assert NULL_TRACER.now() >= 0.0  # real clock: callers time against it


# ---------------------------------------------------------------------------
# Schema validator + CLI gate
# ---------------------------------------------------------------------------


def test_validate_schema_reports_each_violation_kind():
    schema = _schema()
    bad = {
        "displayTimeUnit": "ns",  # const violation
        "traceEvents": [
            {"ph": "Q", "pid": 1, "tid": 1, "name": "x"},  # enum violation
            {"ph": "X", "pid": 0, "tid": 1, "name": "x"},  # minimum violation
            {"ph": "i", "pid": 1, "tid": 1},  # missing required "name"
            {"ph": "i", "pid": 1, "tid": 1, "name": "x",
             "bogus": 1},  # additionalProperties violation
            {"ph": "X", "pid": 1, "tid": 1, "name": "x",
             "ts": "soon"},  # type violation
        ],
    }
    errs = validate_schema(bad, schema)
    joined = "\n".join(errs)
    assert "expected const 'ms'" in joined
    assert "'Q' not in enum" in joined
    assert "0 < minimum 1" in joined
    assert "missing required key 'name'" in joined
    assert "unexpected key 'bogus'" in joined
    assert "expected type number" in joined
    # paths point into the document
    assert any(e.startswith("$.traceEvents[0]") for e in errs)


def test_validate_schema_accepts_type_lists_and_ignores_bools():
    assert validate_schema(1, {"type": ["integer", "null"]}) == []
    assert validate_schema(None, {"type": ["integer", "null"]}) == []
    # bool is NOT an integer for schema purposes
    assert validate_schema(True, {"type": "integer"}) != []
    assert validate_schema(True, {"minimum": 5}) == []  # minimum skips bools


def test_cli_validator_pass_and_fail(tmp_path, capsys):
    tr = Tracer(clock=lambda: 0.0)
    tr.instant("ok", track="t")
    good = str(tmp_path / "good.json")
    tr.write_chrome(good)
    assert tracing.main([good, "--schema", SCHEMA_PATH]) == 0
    assert "schema OK" in capsys.readouterr().out

    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"ph": "Z"}]}, f)
    assert tracing.main([bad, "--schema", SCHEMA_PATH]) == 1
    assert "SCHEMA VIOLATION" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Telemetry regressions (satellites 1 + 2)
# ---------------------------------------------------------------------------


def test_snapshot_extra_collision_raises():
    tm = Telemetry()
    with pytest.raises(ValueError, match="qps"):
        tm.snapshot(qps=123.0)
    with pytest.raises(ValueError, match="completed.*qps|qps.*completed"):
        tm.snapshot(qps=1.0, completed=2)
    # non-colliding extras still merge verbatim
    snap = tm.snapshot(cache={"hits": 1}, pending=0)
    assert snap["cache"] == {"hits": 1} and snap["pending"] == 0


def test_empty_window_qps_is_exactly_zero():
    # near-zero uptime + zero completions must report 0.0, not a denormal
    tm = Telemetry(clock=lambda: 0.0)
    snap = tm.snapshot()
    assert snap["qps"] == 0.0 and snap["completed"] == 0

    from repro_torch.service.router import RouterTelemetry

    rt = RouterTelemetry()
    assert rt.snapshot()["qps"] == 0.0


def test_record_stage_reservoirs_and_unknown_stage():
    tm = Telemetry()
    for s in STAGES:
        tm.record_stage(s, 0.010)
        tm.record_stage(s, 0.030)
    stages = tm.snapshot()["stages_ms"]
    assert set(stages) == set(STAGES)
    for s in STAGES:
        assert stages[s]["count"] == 2
        assert stages[s]["mean"] == pytest.approx(20.0)
    with pytest.raises(ValueError, match="unknown stage"):
        tm.record_stage("teleport", 0.001)


def test_stage_block_is_json_serializable():
    tm = Telemetry()
    tm.record_stage("engine", 0.005)
    json.dumps(tm.snapshot())


# ---------------------------------------------------------------------------
# span ids (§21: the span <-> event join key)
# ---------------------------------------------------------------------------


def test_every_event_gets_a_unique_8hex_span_id():
    tr = Tracer(clock=lambda: 0.0)
    tr.add_span("a", 0.0, 0.1)
    tr.instant("b")
    with tr.span("c"):
        pass
    ids = [ev["span_id"] for ev in tr.events()]
    assert len(set(ids)) == 3
    for sid in ids:
        assert len(sid) == 8
        int(sid, 16)  # hex or raises


def test_span_ids_fold_into_chrome_args():
    tr = Tracer(clock=lambda: 0.0)
    tr.instant("hedge", trace_id="abc")
    tr.add_span("untraced", 0.0, 0.1)  # span_id even without a trace_id
    recs = [r for r in tr.to_chrome()["traceEvents"] if r["ph"] != "M"]
    assert recs[0]["args"]["trace_id"] == "abc"
    assert recs[0]["args"]["span_id"] == "00000001"
    assert "trace_id" not in recs[1]["args"]
    assert recs[1]["args"]["span_id"] == "00000002"


def test_span_id_allocation_is_thread_safe():
    tr = Tracer(clock=lambda: 0.0)
    n_threads, n_iter = 8, 250
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for _ in range(n_iter):
            tr.instant("x")

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ids = [ev["span_id"] for ev in tr.events()]
    assert len(ids) == len(set(ids)) == n_threads * n_iter


# ---------------------------------------------------------------------------
# trace-id propagation across the router's hedged-retry path (§21 satellite)
# ---------------------------------------------------------------------------


class _HedgeStub:
    """Replica stand-in that accepts the traced ``submit`` call shape and
    resolves after ``delay_s`` — slow enough to trip the hedge monitor."""

    class _G:
        n = 64

    def __init__(self, replica_id, delay_s=0.0):
        from repro_torch.service.replica import HEALTHY

        self.id = replica_id
        self.base_graph = self._G()
        self.state = HEALTHY
        self.strikes = 0
        self.suspect_until = 0.0
        self.applied_seq = 0
        self.kills = 0
        self.recoveries = 0
        self.delay_s = delay_s
        self.seen_trace_ids = []

    @property
    def serving(self):
        from repro_torch.service.replica import DEAD

        return self.state != DEAD

    @property
    def version(self):
        return "0.0"

    def submit(self, algo, root, deadline_s=None, *, trace_id=""):
        from concurrent.futures import Future

        self.seen_trace_ids.append(trace_id)
        f = Future()
        if self.delay_s:
            t = threading.Timer(self.delay_s, f.set_result,
                                args=((self.id, int(root)),))
            t.daemon = True
            t.start()
        else:
            f.set_result((self.id, int(root)))
        return f

    def heartbeat(self):
        return self.serving

    def mark_suspect(self, backoff_s, now):
        from repro_torch.service.replica import HEALTHY, SUSPECT

        if self.state == HEALTHY:
            self.state = SUSPECT
        self.strikes += 1
        self.suspect_until = now + backoff_s

    def mark_healthy(self):
        from repro_torch.service.replica import HEALTHY

        self.state = HEALTHY
        self.strikes = 0

    def mark_dead(self):
        from repro_torch.service.replica import DEAD

        self.state = DEAD

    def stop(self, join=True):
        pass


def test_hedged_retry_shares_trace_id_with_distinct_span_ids():
    """The §18/§21 contract the ops console navigates by: a hedged
    request is ONE trace — the slow original attempt, the hedge
    decision, and the winning attempt all carry the ticket's trace_id —
    while per-event span_ids keep the two attempts distinguishable."""
    import time

    from repro_torch.core.events import EventLog
    from repro_torch.service.router import ReplicaRouter

    slow = _HedgeStub(0, delay_s=0.6)   # primary: answers after the hedge
    fast = _HedgeStub(1)
    tracer = Tracer()
    log = EventLog()
    router = ReplicaRouter(
        [slow, fast], timeout_s=0.1, hard_timeout_factor=100.0,
        heartbeat_interval_s=None, suspect_backoff_s=0.05,
        tracer=tracer, events=log,
    )
    try:
        res = router.query("bfs", 5, timeout=10.0)
        assert res.hedged and res.replica == 1
        # the slow primary resolves too; wait for its attempt span
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if sum(1 for ev in tracer.events()
                   if ev["name"] == "attempt:bfs") == 2:
                break
            time.sleep(0.01)
    finally:
        router.stop()

    # both replicas saw the SAME trace_id on the wire
    assert slow.seen_trace_ids == fast.seen_trace_ids
    tid = fast.seen_trace_ids[0]
    assert len(tid) == 16

    evs = tracer.events()
    attempts = [ev for ev in evs if ev["name"] == "attempt:bfs"]
    (hedge,) = [ev for ev in evs if ev["name"] == "hedge:bfs"]
    (route,) = [ev for ev in evs if ev["name"] == "route:bfs"]
    assert len(attempts) == 2
    assert {ev["trace_id"] for ev in attempts} == {tid}
    assert hedge["trace_id"] == tid and route["trace_id"] == tid
    assert attempts[0]["track"] != attempts[1]["track"]  # per-replica rows
    span_ids = {ev["span_id"] for ev in attempts} | {hedge["span_id"]}
    assert len(span_ids) == 3  # same trace, distinguishable events

    # the event-log side of the same story carries the same key
    (hedge_ev,) = log.query(kind="retry", trace_id=tid)
    assert hedge_ev["name"] == "hedge"
    assert hedge_ev["args"]["hedge_to"] == 1


# ---------------------------------------------------------------------------
# parents, self time, the process-wide current tracer, the profiler mirror
# ---------------------------------------------------------------------------


def test_context_spans_carry_the_innermost_open_span_as_parent():
    ticks = iter(float(t) for t in range(9)).__next__
    tr = Tracer(clock=ticks)
    with tr.span("outer"):
        with tr.span("a"):
            pass
        with tr.span("b"):
            with tr.span("c"):
                pass
        tr.add_span("interval", 0.0, 1.0)  # an interval given whole: no parent
    by = {ev["name"]: ev for ev in tr.events()}
    assert "parent_id" not in by["outer"] and "parent_id" not in by["interval"]
    assert by["a"]["parent_id"] == by["b"]["parent_id"] == by["outer"]["span_id"]
    assert by["c"]["parent_id"] == by["b"]["span_id"]
    # ids are taken when a span opens: unique, the outer span's first
    ids = [ev["span_id"] for ev in tr.events()]
    assert len(set(ids)) == len(ids) and by["outer"]["span_id"] == min(ids)
    doc = tr.to_chrome()
    c = next(e for e in doc["traceEvents"] if e["name"] == "c")
    assert c["args"]["parent_id"] == by["b"]["span_id"]
    assert validate_schema(doc, _torch_schema()) == []
    # the port's schema types the ids; the repo's leaves args open
    c["args"]["parent_id"] = 7
    assert validate_schema(doc, _torch_schema()) != []
    assert validate_schema(doc, _schema()) == []


def test_parents_are_per_thread_and_popped_on_exceptions():
    tr = Tracer()
    gate = threading.Barrier(2)

    def worker():
        with tr.span("other-thread"):
            gate.wait(timeout=10)
            gate.wait(timeout=10)

    th = threading.Thread(target=worker)
    th.start()
    with tr.span("main-thread"):
        gate.wait(timeout=10)
        with pytest.raises(ValueError):
            with tr.span("raises"):
                raise ValueError
        with tr.span("after"):
            pass
        gate.wait(timeout=10)
    th.join(timeout=10)
    assert not th.is_alive()
    by = {ev["name"]: ev for ev in tr.events()}
    assert "parent_id" not in by["other-thread"]
    assert by["raises"]["parent_id"] == by["after"]["parent_id"] == by["main-thread"]["span_id"]
    assert by["raises"]["args"]["error"] == "ValueError"


def test_span_times_give_total_self_and_count():
    # outer [0, 10] holds a [1, 3] and a [4, 8]; the second holds c [5, 6]
    ticks = iter(float(t) for t in (0, 0, 1, 3, 4, 5, 6, 8, 10, 10)).__next__
    tr = Tracer(clock=ticks)
    with tr.span("outer"):
        with tr.span("a"):
            pass
        with tr.span("a"):
            with tr.span("c"):
                pass
    tr.instant("ignored")
    times = tracing.span_times(tr.events())
    assert times == {"outer": {"count": 1, "total_s": 10.0, "self_s": 4.0},
                     "a": {"count": 2, "total_s": 6.0, "self_s": 5.0},
                     "c": {"count": 1, "total_s": 1.0, "self_s": 1.0}}


def test_module_span_records_on_the_current_tracer_only_inside_recording():
    assert tracing._current is NULL_TRACER
    with tracing.span("nobody", k=1) as sp:
        assert sp is None
    first, second = Tracer(), Tracer()
    with tracing.recording(first) as tr:
        assert tr is first and tracing._current is first
        with tracing.span("level", index=3) as sp:
            assert sp.args == {"index": 3}
            with tracing.recording(second):
                with tracing.span("inner"):
                    pass
            assert tracing._current is first
            with tracing.span("child"):
                pass
    assert tracing._current is NULL_TRACER
    assert [ev["name"] for ev in second.events()] == ["inner"]
    assert "parent_id" not in second.events()[0]  # parents stay within a tracer
    child, level = first.events()
    assert level["args"] == {"index": 3} and child["parent_id"] == level["span_id"]
    # restored after an exception too
    with pytest.raises(RuntimeError):
        with tracing.recording(first):
            raise RuntimeError
    assert tracing._current is NULL_TRACER


def test_clocked_span_gives_its_clock_points_with_or_without_a_tracer():
    with tracing.clocked("loop.level", index=0) as h:
        pass
    assert h.t1 >= h.t0 > 0
    tr = Tracer()
    with tracing.recording(tr):
        with tracing.clocked("loop.level", index=1) as h:
            pass
    (ev,) = tr.events()
    assert ev["dur_us"] == tr._us(h.t1) - tr._us(h.t0) and ev["args"] == {"index": 1}


def test_off_span_is_one_shared_null_context():
    assert tracing.span("a") is tracing.span("b", x=1)


def _annotations(prof):
    return [e.name for e in prof.events() if e.name.startswith("t.")]


def test_spans_mirror_into_a_recording_profiler_with_the_tracer_off():
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("t.outer", root=1):
            with tracing.span("t.inner"):
                torch.ones(4).sum()
    assert len(_annotations(prof)) == 2 and set(_annotations(prof)) == {"t.outer", "t.inner"}
    names = {(e["name"], e.get("cat")) for e in _chrome_events(prof)}
    assert {("t.outer", "user_annotation"), ("t.inner", "user_annotation")} <= names
    # recorded and mirrored at once; nothing mirrored once the profiler stops
    tr = Tracer()
    with tracing.recording(tr):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.span("t.both"):
                pass
        with tracing.span("t.after"):
            pass
    assert _annotations(prof) == ["t.both"]
    assert [ev["name"] for ev in tr.events()] == ["t.both", "t.after"]


def _chrome_events(prof):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def test_services_explicit_tracer_is_not_the_current_tracer():
    """The serving tier's ``tracer=`` wiring records on the tracer it was
    given, whatever tracer the program's spans record on."""
    from repro_torch.service.router import ReplicaRouter

    given, current = Tracer(), Tracer()
    router = ReplicaRouter([_HedgeStub(0), _HedgeStub(1)], timeout_s=5.0,
                           heartbeat_interval_s=None, tracer=given)
    try:
        with tracing.recording(current):
            assert router.query("bfs", 3, timeout=10.0).replica in (0, 1)
    finally:
        router.stop()
    assert {"route:bfs"} <= {ev["name"] for ev in given.events()}
    assert current.events() == []
    assert validate_schema(given.to_chrome(), _torch_schema()) == []
