"""PyTorch port, the structured event log (DESIGN.md §21): the same emits
through ``repro.core.events`` and the port's copy give equal event
documents (modulo timestamps), valid against ``tests/event_schema.json``;
then the reference's cases against the port: ring, sink, query, schema,
CLI."""

import json
import threading

import pytest

from repro_torch.core import events
from repro_torch.core.events import (
    EVENT_SCHEMA,
    KINDS,
    NULL_EVENTS,
    EventLog,
    validate_events_file,
)

SCHEMA_PATH = __file__.rsplit("/", 1)[0] + "/event_schema.json"


# ---------------------------------------------------------------------------
# parity with the reference module
# ---------------------------------------------------------------------------


def _drive(mod, sink):
    """One emit sequence on a small clocked ring with a sink: every kind,
    an overflow of the ring, filters and a clear."""
    ticks = iter([1000.0 + 0.5 * i for i in range(64)]).__next__
    log = mod.EventLog(capacity=6, clock=ticks)
    log.attach_sink(str(sink))
    for i, kind in enumerate(mod.KINDS):
        log.emit(kind, f"n{i}", subsystem="svc0" if i % 2 else "router0",
                 trace_id=("%016x" % i) if i % 3 else "", args={"i": i})
    log.emit("wave", "bfs", subsystem="svc0", args={"roots": 3})
    snap = log.snapshot()
    assert snap.pop("sink") == str(sink)
    out = {"events": log.events(), "snapshot": snap,
           "wave": log.query(kind="wave"), "svc": log.query(subsystem="svc0", limit=2),
           "last": log.last(with_trace=True)}
    log.clear()
    log.emit("request", "cache-hit", args={"algo": "bfs"})
    out["after_clear"] = log.events()
    log.close_sink()
    out["sink"] = [json.loads(line) for line in open(sink)]
    return out


def test_event_documents_equal_the_reference(tmp_path):
    from repro.core import events as ref_events

    assert KINDS == ref_events.KINDS and EVENT_SCHEMA == ref_events.EVENT_SCHEMA
    got = _drive(events, tmp_path / "got.jsonl")
    want = _drive(ref_events, tmp_path / "want.jsonl")
    assert got == want
    schema = json.load(open(SCHEMA_PATH))
    assert validate_events_file(str(tmp_path / "got.jsonl"), schema) == []
    assert ref_events.validate_events_file(str(tmp_path / "got.jsonl"), schema) == []


# ---------------------------------------------------------------------------
# recording + typing
# ---------------------------------------------------------------------------


def test_emit_shapes_and_monotonic_seq():
    log = EventLog(clock=lambda: 12.5)
    e1 = log.emit("request", "completed", subsystem="svc0",
                  trace_id="abc", args={"latency_ms": 3.2})
    e2 = log.emit("chaos", "kill-replica")
    assert e1["schema"] == EVENT_SCHEMA and e2["schema"] == EVENT_SCHEMA
    assert (e1["seq"], e2["seq"]) == (1, 2)
    assert e1["ts"] == 12.5
    assert e1["subsystem"] == "svc0" and e1["trace_id"] == "abc"
    assert e2["subsystem"] == "" and e2["trace_id"] == ""
    assert e1["args"] == {"latency_ms": 3.2} and e2["args"] == {}


def test_unknown_kind_rejected():
    log = EventLog()
    with pytest.raises(ValueError, match="unknown event kind"):
        log.emit("printf", "whoops")
    with pytest.raises(ValueError):
        EventLog(capacity=0)


def test_ring_bounded_but_seq_keeps_counting():
    log = EventLog(capacity=3)
    for i in range(7):
        log.emit("wave", f"w{i}")
    assert len(log) == 3
    assert [e["name"] for e in log.events()] == ["w4", "w5", "w6"]
    snap = log.snapshot()
    assert snap["emitted"] == 7
    assert snap["resident"] == 3
    assert snap["dropped_from_ring"] == 4
    assert snap["by_kind"] == {"wave": 3}


# ---------------------------------------------------------------------------
# query / last
# ---------------------------------------------------------------------------


def _loaded():
    log = EventLog()
    log.emit("request", "completed", subsystem="svc0", trace_id="t1")
    log.emit("retry", "hedge", subsystem="router0", trace_id="t1")
    log.emit("request", "completed", subsystem="svc0", trace_id="t2")
    log.emit("chaos", "kill-replica", subsystem="router0")
    log.emit("retry", "retry", subsystem="router0", trace_id="t2")
    return log


def test_query_filters_compose():
    log = _loaded()
    assert len(log.query(trace_id="t1")) == 2
    assert [e["name"] for e in log.query(kind="retry")] == ["hedge", "retry"]
    assert len(log.query(subsystem="router0")) == 3
    assert len(log.query(trace_id="t2", kind="retry")) == 1
    assert log.query(trace_id="missing") == []


def test_query_limit_keeps_newest():
    log = EventLog()
    for i in range(10):
        log.emit("wave", f"w{i}")
    out = log.query(kind="wave", limit=3)
    assert [e["name"] for e in out] == ["w7", "w8", "w9"]


def test_last_with_trace_skips_untraced():
    log = _loaded()
    assert log.last(kind="chaos")["name"] == "kill-replica"
    # the newest chaos event has no trace_id -> skipped under with_trace
    assert log.last(kind="chaos", with_trace=True) is None
    assert log.last(kind="retry", with_trace=True)["trace_id"] == "t2"
    assert log.last(kind="slo") is None


def test_clear_resets_ring_not_seq():
    log = _loaded()
    log.clear()
    assert len(log) == 0
    e = log.emit("wave", "next")
    assert e["seq"] == 6  # seq is the lifetime counter, not ring position


# ---------------------------------------------------------------------------
# sink + schema validation
# ---------------------------------------------------------------------------


def test_sink_keeps_full_stream_and_validates(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(capacity=2)
    log.attach_sink(path)
    assert log.sink_path == path
    for i in range(5):
        log.emit("cache", "evict", args={"i": i})
    log.close_sink()
    assert log.sink_path is None
    lines = [json.loads(l) for l in open(path)]
    assert len(lines) == 5  # ring kept 2, sink kept all
    with open(SCHEMA_PATH) as f:
        schema = json.load(f)
    assert validate_events_file(path, schema) == []


def test_schema_rejects_bad_lines(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    good = EventLog().emit("wave", "ok")
    with open(path, "w") as f:
        f.write(json.dumps(good) + "\n")
        f.write(json.dumps({**good, "kind": "printf"}) + "\n")  # enum
        f.write(json.dumps({k: v for k, v in good.items()
                            if k != "trace_id"}) + "\n")  # required
        f.write("not json\n")
    with open(SCHEMA_PATH) as f:
        schema = json.load(f)
    errs = validate_events_file(path, schema)
    assert len(errs) == 3
    assert any("line 2" in e for e in errs)
    assert any("line 3" in e for e in errs)
    assert any("line 4" in e for e in errs)


def test_schema_enum_matches_kinds():
    with open(SCHEMA_PATH) as f:
        schema = json.load(f)
    assert tuple(schema["properties"]["kind"]["enum"]) == KINDS


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_validates_and_gates(tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    log = EventLog()
    log.attach_sink(path)
    log.emit("chaos", "kill-replica", trace_id="abcd")
    log.emit("retry", "hedge", trace_id="abcd")
    log.close_sink()

    assert events.main([path, "--schema", SCHEMA_PATH]) == 0
    assert events.main([path, "--schema", SCHEMA_PATH,
                        "--require-kind", "chaos",
                        "--require-kind", "retry"]) == 0
    assert events.main([path, "--schema", SCHEMA_PATH,
                        "--require-kind", "slo"]) == 1
    assert events.main([path, "--schema", SCHEMA_PATH,
                        "--trace-id", "abcd"]) == 0
    assert events.main([path, "--schema", SCHEMA_PATH,
                        "--trace-id", "nope"]) == 1
    out = capsys.readouterr().out
    assert "trace abcd: 2 correlated events" in out


def test_cli_flags_schema_violations(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"schema": "wrong/v9"}) + "\n")
    assert events.main([path, "--schema", SCHEMA_PATH]) == 1


# ---------------------------------------------------------------------------
# null log + module default
# ---------------------------------------------------------------------------


def test_null_event_log_is_inert():
    assert NULL_EVENTS.emit("request", "x") == {}
    assert NULL_EVENTS.events() == []
    assert NULL_EVENTS.query(trace_id="t") == []
    assert NULL_EVENTS.last(kind="chaos") is None
    assert len(NULL_EVENTS) == 0
    assert not NULL_EVENTS.enabled
    NULL_EVENTS.attach_sink("/nonexistent/never/opened")  # no-op, no error
    NULL_EVENTS.close_sink()


def test_module_default_log_shared():
    before = len(events.default_event_log().events())
    events.emit("repair", "sweep", args={"n": 1})
    log = events.default_event_log()
    assert len(log.events()) == before + 1
    assert log.events()[-1]["name"] == "sweep"


def test_emit_thread_safe_exact_seq():
    log = EventLog(capacity=100_000)
    n_threads, n_iter = 8, 500
    start = threading.Barrier(n_threads)

    def worker(tid):
        start.wait()
        for i in range(n_iter):
            log.emit("wave", f"t{tid}-{i}")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = log.events()
    assert len(evs) == n_threads * n_iter
    assert [e["seq"] for e in evs] == list(range(1, n_threads * n_iter + 1))
