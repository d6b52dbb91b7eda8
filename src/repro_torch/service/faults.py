"""Deterministic fault injection for the replicated serving tier (DESIGN.md §17).

Chaos testing is only worth the name when a failure is REPRODUCIBLE: a
flake that cannot be replayed cannot be debugged, and a chaos suite whose
fault schedule drifts between runs cannot gate a merge.  Every fault here
is therefore triggered by a LOGICAL event index — the router's Nth routed
request (``op``) or the replication log's Nth batch (``batch``) — never by
wall-clock time, and every random choice (which replica to kill, which
copy of a batch to drop) is drawn from one seeded generator at plan-build
time.  Two runs with the same ``(spec, seed, n_replicas)`` produce the
byte-identical schedule and byte-identical ``injected`` counters.

Spec grammar (semicolon-separated clauses)::

    kind[@trigger=INT][:param=VALUE[,param=VALUE]]

    kill-one@op=20              kill one replica when request #20 routes
    stall@op=8:ms=400           route request #8 to a victim and sit on it
    drop-batch@batch=2          never deliver log batch 2 to one replica
    delay-batch@batch=3:ms=80   deliver batch 3 to one replica 80ms late
    dup-batch@batch=1           deliver batch 1 twice to one replica
    corrupt-batch@batch=2       deliver a copy that Graph.validate rejects

The router owns the injection points (see ``repro_torch.service.router``):
``on_op`` fires before a request is routed, ``on_batch`` before a log
batch is delivered to one replica.  Dropped and corrupted batches are
repaired by the router's catch-up path, which redelivers the PRISTINE
copy from its log — the fault lives in the delivery, never in the log.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# canonical kind -> accepted aliases in specs
KINDS = {
    "kill-replica": ("kill-replica", "kill-one", "kill"),
    "stall-wave": ("stall-wave", "stall"),
    "drop-batch": ("drop-batch", "drop"),
    "delay-batch": ("delay-batch", "delay"),
    "dup-batch": ("dup-batch", "dup"),
    "corrupt-batch": ("corrupt-batch", "corrupt"),
}
_ALIAS = {a: k for k, aliases in KINDS.items() for a in aliases}
# which event stream triggers each kind
OP_KINDS = ("kill-replica", "stall-wave")
BATCH_KINDS = ("drop-batch", "delay-batch", "dup-batch", "corrupt-batch")
_DEFAULT_AT = {"kill-replica": 8, "stall-wave": 4}  # default op trigger
_DEFAULT_MS = {"stall-wave": 400.0, "delay-batch": 50.0}


class ChaosSpecError(ValueError):
    """Malformed ``--chaos`` spec."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` fires at logical event index ``at``
    against replica index ``victim`` (drawn at plan-build time)."""

    kind: str
    at: int
    victim: int
    delay_s: float = 0.0

    def json(self) -> Dict:
        return {"kind": self.kind, "at": self.at, "victim": self.victim,
                "delay_s": self.delay_s}


def parse_chaos(
    spec: Optional[str], seed: int, n_replicas: int
) -> List[Fault]:
    """Build the deterministic fault schedule for ``spec``.

    Victims are drawn from ``default_rng(seed)`` in clause order, so the
    schedule is a pure function of ``(spec, seed, n_replicas)``."""
    if not spec:
        return []
    if n_replicas < 1:
        raise ChaosSpecError("chaos needs at least one replica")
    rng = np.random.default_rng(seed)
    faults: List[Fault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, _, params = clause.partition(":")
        name, _, at_s = head.partition("@")
        kind = _ALIAS.get(name.strip())
        if kind is None:
            raise ChaosSpecError(
                f"unknown fault kind {name.strip()!r}; expected one of "
                f"{sorted(_ALIAS)}"
            )
        kv = {}
        for part in params.split(","):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            if not eq:
                raise ChaosSpecError(f"bad param {part!r} in {clause!r}")
            kv[k.strip()] = v.strip()
        if at_s:
            k, eq, v = at_s.partition("=")
            if not eq or k.strip() not in ("op", "batch"):
                raise ChaosSpecError(
                    f"bad trigger {at_s!r} in {clause!r} (want op=N/batch=N)"
                )
            want = "op" if kind in OP_KINDS else "batch"
            if k.strip() != want:
                raise ChaosSpecError(
                    f"{kind} triggers on {want}=N, got {at_s!r}"
                )
            at = int(v)
        else:
            at = _DEFAULT_AT.get(kind, 1)
        if at < 1:
            raise ChaosSpecError(f"trigger index must be >= 1 in {clause!r}")
        delay_s = float(kv.pop("ms", _DEFAULT_MS.get(kind, 0.0))) / 1e3
        if kv:
            raise ChaosSpecError(f"unknown params {sorted(kv)} in {clause!r}")
        victim = int(rng.integers(n_replicas))
        faults.append(Fault(kind=kind, at=at, victim=victim, delay_s=delay_s))
    return faults


def corrupt_batch(batch, n: int):
    """A delivery-corrupted copy of ``batch``: one insert endpoint is
    pushed out of the vertex range so ``DeltaOverlay.apply`` (which
    enforces the ``Graph.validate`` range contract) rejects it whole.
    The pristine batch stays in the router's log for catch-up."""
    from repro_torch.dynamic.delta import EdgeBatch

    ins_src = np.concatenate([batch.insert_src, [np.int64(n + 7)]])
    ins_dst = np.concatenate([batch.insert_dst, [np.int64(0)]])
    w = batch.insert_weights
    if w is not None:
        w = np.concatenate([w, [np.uint32(1)]])
    return EdgeBatch(
        insert_src=ins_src, insert_dst=ins_dst, insert_weights=w,
        delete_src=batch.delete_src, delete_dst=batch.delete_dst,
    )


class FaultInjector:
    """Holds the schedule and the per-kind ``injected`` counters.

    ``on_op`` / ``on_batch`` are called by the router at the two
    injection points; each scheduled fault fires EXACTLY once (the event
    indices are strictly increasing), so the counters are a deterministic
    function of the schedule and how far the event streams ran."""

    def __init__(self, faults: List[Fault]):
        from repro_torch.core import metrics as metrics_mod

        self.faults = list(faults)
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}
        self._by_op: Dict[int, List[Fault]] = {}
        self._by_batch: Dict[int, List[Fault]] = {}
        for f in self.faults:
            group = self._by_op if f.kind in OP_KINDS else self._by_batch
            group.setdefault(f.at, []).append(f)
        # registry mirror of the deterministic ``injected`` counters
        # (DESIGN.md §20): one labeled series per fault kind
        self._metric = metrics_mod.default_registry().counter(
            "chaos_faults_injected_total",
            "faults actually fired by the deterministic injector",
            ("kind",))

    @classmethod
    def from_spec(
        cls, spec: Optional[str], seed: int, n_replicas: int
    ) -> "FaultInjector":
        return cls(parse_chaos(spec, seed, n_replicas))

    def on_op(self, op_index: int) -> List[Fault]:
        """Faults firing on routed request ``op_index`` (1-based)."""
        fired = self._by_op.get(op_index, [])
        for f in fired:
            self.injected[f.kind] += 1
            self._metric.inc(kind=f.kind)
        return fired

    def on_batch(self, seq: int, replica_index: int) -> Optional[Fault]:
        """The fault (if any) hitting the delivery of log batch ``seq``
        to ``replica_index``.  At most one fault per (seq, victim)."""
        for f in self._by_batch.get(seq, []):
            if f.victim == replica_index:
                self.injected[f.kind] += 1
                self._metric.inc(kind=f.kind)
                return f
        return None

    def schedule_json(self) -> List[Dict]:
        return [f.json() for f in self.faults]

    def snapshot(self) -> Dict:
        """JSON-serializable ``{kind: fired_count}`` (zero-filled)."""
        return dict(self.injected)
