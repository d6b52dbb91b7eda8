"""Partition-aligned delta overlay on the CSR graph (DESIGN.md §16).

A copy of ``repro.dynamic.delta`` (NumPy only) on the port's
:class:`~repro_torch.graph.csr.Graph` and
:class:`~repro_torch.graph.partition.PartitionedGraph`.  The JSONL update
stream has the reference's format, so a stream either package writes
replays in the other.

Two mutable views are kept in lock-step:

* **host overlay** (:class:`DeltaOverlay`) — the authoritative edge set:
  the base :class:`~repro_torch.graph.csr.Graph` plus every batch applied since
  the last compaction, maintained as a sorted ``(src << 32 | dst)`` key
  array with the SAME semantics as the ETL (``csr.from_edges``):
  symmetrize mirrors both directions, self-loops are dropped, duplicate
  inserts keep the MINIMUM weight (so an insert can only lower a weight —
  the choice that keeps repair monotone, §16).  ``current_graph()``
  materializes a validated CSR at any time; ``compact()`` rebases on it.

* **partitioned view** (:func:`apply_update_to_partition`) — the stacked
  ``[P, emax]`` arrays of a
  :class:`~repro_torch.graph.partition.PartitionedGraph`.  Inserts append into
  each owner shard's static slack (``edge_count`` / ``in_count`` grow, the
  array SHAPES never change, so cached programs are reused); deletions
  compact the matching slots out of the active prefix.  The traversal
  kernels never depend on edge ORDER (scatter-OR / scatter-MIN are
  order-free), so appended edges traverse exactly like rebuilt ones.
  When a shard's slack is exhausted the update is refused untouched and
  the caller falls back to compaction + repartition (a §15 full swap).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import Graph, GraphValidationError, unique_keys


def _as_ids(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1)


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """One batch of UNDIRECTED edge mutations (the user-facing unit).

    ``insert_weights`` is required iff the target overlay is weighted.
    Self-loops are ignored; inserting an edge that already exists keeps the
    minimum weight (ETL dedup semantics); deleting a missing edge is a
    no-op (GAP streaming convention).
    """

    insert_src: np.ndarray
    insert_dst: np.ndarray
    insert_weights: Optional[np.ndarray] = None
    delete_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    delete_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )

    def __post_init__(self):
        object.__setattr__(self, "insert_src", _as_ids(self.insert_src))
        object.__setattr__(self, "insert_dst", _as_ids(self.insert_dst))
        object.__setattr__(self, "delete_src", _as_ids(self.delete_src))
        object.__setattr__(self, "delete_dst", _as_ids(self.delete_dst))
        if self.insert_src.shape != self.insert_dst.shape:
            raise ValueError("insert src/dst length mismatch")
        if self.delete_src.shape != self.delete_dst.shape:
            raise ValueError("delete src/dst length mismatch")
        if self.insert_weights is not None:
            w = np.asarray(self.insert_weights, dtype=np.uint32).reshape(-1)
            if w.shape != self.insert_src.shape:
                raise ValueError("insert_weights length mismatch")
            if w.size and w.min() == 0:
                # the §16 repair soundness argument needs w >= 1: a
                # zero-weight edge lets the taint closure reach the root
                raise ValueError("insert weights must be >= 1")
            object.__setattr__(self, "insert_weights", w)

    @classmethod
    def insert(cls, src, dst, weights=None) -> "EdgeBatch":
        return cls(insert_src=src, insert_dst=dst, insert_weights=weights)

    @classmethod
    def delete(cls, src, dst) -> "EdgeBatch":
        return cls(insert_src=np.zeros(0, np.int64),
                   insert_dst=np.zeros(0, np.int64),
                   delete_src=src, delete_dst=dst)

    @property
    def empty(self) -> bool:
        return self.insert_src.size == 0 and self.delete_src.size == 0


@dataclasses.dataclass(frozen=True)
class AppliedUpdate:
    """The EFFECTIVE directed mutations of one batch after overlay dedup.

    Both directions of every undirected edge are present.  ``ins_is_new``
    distinguishes genuinely new edges from weight-lowerings of existing
    ones (the latter add a device slot but not out-degree).  Deleted edges
    carry the weight they had (the repair taint check needs it, §16).
    """

    ins_src: np.ndarray  # int64[k] directed
    ins_dst: np.ndarray  # int64[k]
    ins_w: Optional[np.ndarray]  # uint32[k] or None (unweighted)
    ins_is_new: np.ndarray  # bool[k]
    del_src: np.ndarray  # int64[m] directed
    del_dst: np.ndarray  # int64[m]
    del_w: Optional[np.ndarray]  # uint32[m] or None

    @property
    def empty(self) -> bool:
        return self.ins_src.size == 0 and self.del_src.size == 0

    @property
    def n_ops(self) -> int:
        return int(self.ins_src.size + self.del_src.size)


def _sym_dedup(src, dst, w):
    """ETL normalization of one batch: symmetrize, drop self-loops, dedup
    directed keys keeping the minimum weight.  Returns (keys, w|None)."""
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if w is not None:
        w = np.concatenate([w, w])
    keep = src != dst
    return unique_keys((src[keep] << 32) | dst[keep], None if w is None else w[keep])


class DeltaOverlay:
    """Host-authoritative streaming edge set over a base :class:`Graph`.

    The vertex set is FIXED (``n``/``n_real`` never change): growing the
    vertex space changes every static device shape and is a full-rebuild
    event by construction.  ``pending_ops`` counts directed mutations since
    the last compaction; :meth:`needs_compaction` trips once they exceed
    ``compact_ratio`` of the base edge count (or the partition slack
    overflows, whichever first — see ``apply_update_to_partition``).
    """

    def __init__(self, base: Graph, *, compact_ratio: float = 0.25):
        if not base._validated:
            base.validate()
        if compact_ratio <= 0:
            raise ValueError(f"compact_ratio must be > 0, got {compact_ratio}")
        if base.weights is not None and base.n_edges and base.weights.min() == 0:
            # same w >= 1 invariant as EdgeBatch: zero-weight edges break
            # the deletion-taint argument (the root itself could taint)
            raise GraphValidationError(
                "streaming overlay requires edge weights >= 1"
            )
        self.base = base
        self.compact_ratio = compact_ratio
        self._keys = (base.src.astype(np.int64) << 32) | base.dst.astype(
            np.int64
        )
        self._weights = (
            base.weights.copy() if base.weights is not None else None
        )
        self.pending_ops = 0
        self.batches_applied = 0
        self.compactions = 0

    # --- views ------------------------------------------------------------

    @property
    def weighted(self) -> bool:
        return self._weights is not None

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def n_edges(self) -> int:
        return int(self._keys.size)

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Current directed (src, dst, weights) in sorted-key order."""
        src = (self._keys >> 32).astype(np.int32)
        dst = (self._keys & 0xFFFFFFFF).astype(np.int32)
        return src, dst, self._weights

    def current_graph(self) -> Graph:
        """Materialize the current edge set as a validated CSR."""
        src, dst, w = self.edge_arrays()
        row_offsets = np.zeros(self.base.n + 1, dtype=np.int64)
        row_offsets[1:] = np.cumsum(np.bincount(src, minlength=self.base.n))
        g = Graph(
            n=self.base.n,
            n_real=self.base.n_real,
            src=src,
            dst=dst,
            row_offsets=row_offsets,
            symmetric=self.base.symmetric,
            weights=None if w is None else w.copy(),
        )
        g.validate()
        return g

    # --- mutation ---------------------------------------------------------

    def apply(self, batch: EdgeBatch) -> AppliedUpdate:
        """Fold one batch into the overlay; returns the EFFECTIVE directed
        mutations (after dedup against the current edge set) — exactly what
        :func:`apply_update_to_partition` and the repair seeds consume."""
        if self.weighted and batch.insert_src.size and batch.insert_weights is None:
            raise GraphValidationError(
                "weighted overlay requires insert weights"
            )
        if not self.weighted and batch.insert_weights is not None:
            raise GraphValidationError(
                "unweighted overlay got insert weights"
            )
        if batch.insert_src.size:
            hi = max(int(batch.insert_src.max()), int(batch.insert_dst.max()))
            lo = min(int(batch.insert_src.min()), int(batch.insert_dst.min()))
            if lo < 0 or hi >= self.base.n:
                raise GraphValidationError(
                    f"insert endpoint out of range [0, {self.base.n})"
                )

        # -- inserts: ETL-normalize, split new / weight-lowering / no-op --
        ins_key, ins_w = _sym_dedup(
            batch.insert_src, batch.insert_dst, batch.insert_weights
        )
        if self.weighted and ins_w is None:
            ins_w = np.zeros(ins_key.size, np.uint32)  # empty-insert batch
        pos = np.searchsorted(self._keys, ins_key)
        present = (pos < self._keys.size) & (
            self._keys[np.minimum(pos, self._keys.size - 1)] == ins_key
        ) if self._keys.size else np.zeros(ins_key.size, bool)
        if self.weighted:
            lowers = np.zeros(ins_key.size, bool)
            lowers[present] = ins_w[present] < self._weights[pos[present]]
            effective = ~present | lowers
        else:
            effective = ~present
        new_mask = ~present[effective]
        eff_key = ins_key[effective]
        eff_w = ins_w[effective] if self.weighted else None
        # merge: lower existing weights in place, insert the new keys sorted
        if self.weighted and eff_key.size:
            upd = ~new_mask
            upd_pos = pos[effective][upd]
            self._weights[upd_pos] = eff_w[upd]
        add_key = eff_key[new_mask]
        if add_key.size:
            at = np.searchsorted(self._keys, add_key)
            self._keys = np.insert(self._keys, at, add_key)
            if self.weighted:
                self._weights = np.insert(self._weights, at, eff_w[new_mask])

        # -- deletes: intersect with the current edge set -----------------
        del_key, _ = _sym_dedup(batch.delete_src, batch.delete_dst, None)
        if self._keys.size and del_key.size:
            dpos = np.searchsorted(self._keys, del_key)
            found = (dpos < self._keys.size) & (
                self._keys[np.minimum(dpos, self._keys.size - 1)] == del_key
            )
        else:
            found = np.zeros(del_key.size, bool)
        del_key = del_key[found]
        del_w = None
        if del_key.size:
            dpos = np.searchsorted(self._keys, del_key)
            if self.weighted:
                del_w = self._weights[dpos].copy()
            keep = np.ones(self._keys.size, bool)
            keep[dpos] = False
            self._keys = self._keys[keep]
            if self.weighted:
                self._weights = self._weights[keep]
        elif self.weighted:
            del_w = np.zeros(0, np.uint32)

        self.pending_ops += int(eff_key.size + del_key.size)
        self.batches_applied += 1
        return AppliedUpdate(
            ins_src=(eff_key >> 32),
            ins_dst=(eff_key & 0xFFFFFFFF),
            ins_w=eff_w,
            ins_is_new=new_mask,
            del_src=(del_key >> 32),
            del_dst=(del_key & 0xFFFFFFFF),
            del_w=del_w,
        )

    # --- compaction -------------------------------------------------------

    def needs_compaction(self) -> bool:
        return self.pending_ops > self.compact_ratio * max(
            self.base.n_edges, 1
        )

    def compact(self) -> Graph:
        """Materialize the current edge set and REBASE the overlay on it
        (the delta merge of §16); returns the fresh validated CSR."""
        g = self.current_graph()
        self.base = g
        self.pending_ops = 0
        self.compactions += 1
        return g

    # --- synthetic load ---------------------------------------------------

    def sample_batch(
        self,
        rng: np.random.Generator,
        n_insert: int,
        n_delete: int = 0,
        *,
        max_weight: int = 0,
    ) -> EdgeBatch:
        """A random batch against the CURRENT edge set: uniformly random
        insert endpoints over the real vertex range (weights uniform in
        ``[1, max_weight]`` when the overlay is weighted) and deletions
        sampled from existing edges."""
        n = self.base.n_real
        ins_s = rng.integers(0, n, size=n_insert)
        ins_d = rng.integers(0, n, size=n_insert)
        w = None
        if self.weighted:
            w = rng.integers(1, max(max_weight, 1) + 1, size=n_insert,
                             dtype=np.uint32)
        del_s = np.zeros(0, np.int64)
        del_d = np.zeros(0, np.int64)
        if n_delete and self._keys.size:
            pick = rng.choice(self._keys.size, size=min(n_delete,
                                                        self._keys.size),
                              replace=False)
            del_s = self._keys[pick] >> 32
            del_d = self._keys[pick] & 0xFFFFFFFF
        return EdgeBatch(insert_src=ins_s, insert_dst=ins_d,
                         insert_weights=w, delete_src=del_s,
                         delete_dst=del_d)


# ---------------------------------------------------------------------------
# Partition-aligned application
# ---------------------------------------------------------------------------


def _owners(pg, vids: np.ndarray) -> np.ndarray:
    return np.searchsorted(pg.v_start, vids, side="right") - 1


def apply_update_to_partition(pg, update: AppliedUpdate) -> bool:
    """Apply an :class:`AppliedUpdate` to the stacked ``[P, emax]`` arrays
    IN PLACE (host side; callers re-place on device afterwards).

    Returns ``False`` — with every array untouched — when any shard's
    static slack cannot hold its inserts (the compaction trigger).
    Inserted directed edge ``(u, v)`` appends to ``owner(u)``'s out buffer
    and ``owner(v)``'s in buffer; weight-lowerings append a duplicate slot
    (scatter-MIN keeps the lower proposal, so duplicates are harmless and
    cheaper than an in-place search); deletions compact every matching
    slot out of the active prefix.  ``deg_out`` tracks the DEDUPLICATED
    out-degree (weight-lowerings don't count)."""
    ins_u, ins_v = update.ins_src, update.ins_dst
    out_own = _owners(pg, ins_u)
    in_own = _owners(pg, ins_v)

    # capacity pre-check: refuse atomically, never half-apply
    out_add = np.bincount(out_own, minlength=pg.p) if ins_u.size else np.zeros(pg.p, np.int64)
    in_add = np.bincount(in_own, minlength=pg.p) if ins_u.size else np.zeros(pg.p, np.int64)
    if np.any(pg.edge_count + out_add > pg.emax) or np.any(
        pg.in_count + in_add > pg.emax
    ):
        return False

    weighted = pg.edge_weight is not None
    for i in range(pg.p):
        # -- inserts: append into the shard's slack -----------------------
        sel = out_own == i
        k = int(sel.sum())
        if k:
            lo = int(pg.edge_count[i])
            pg.edge_src[i, lo : lo + k] = ins_u[sel]
            pg.edge_dst[i, lo : lo + k] = ins_v[sel]
            if weighted:
                pg.edge_weight[i, lo : lo + k] = update.ins_w[sel]
            pg.edge_count[i] += k
            newsel = sel & update.ins_is_new
            np.add.at(
                pg.deg_out[i],
                (ins_u[newsel] - pg.v_start[i]).astype(np.int64),
                1,
            )
        sel = in_own == i
        k = int(sel.sum())
        if k:
            lo = int(pg.in_count[i])
            pg.in_src[i, lo : lo + k] = ins_u[sel]
            pg.in_dst[i, lo : lo + k] = ins_v[sel]
            if weighted:
                pg.in_weight[i, lo : lo + k] = update.ins_w[sel]
            pg.in_count[i] += k

    # -- deletes: compact matching slots out of the active prefix ---------
    if update.del_src.size:
        del_u, del_v = update.del_src, update.del_dst
        del_key = (del_u << 32) | del_v
        d_out = _owners(pg, del_u)
        d_in = _owners(pg, del_v)
        for i in range(pg.p):
            for (srcs, dsts, wts, cnt_name, own) in (
                (pg.edge_src, pg.edge_dst, pg.edge_weight, "edge_count", d_out),
                (pg.in_src, pg.in_dst, pg.in_weight, "in_count", d_in),
            ):
                keys_i = del_key[own == i]
                if not keys_i.size:
                    continue
                cnt_arr = getattr(pg, cnt_name)
                act = int(cnt_arr[i])
                slot_key = (
                    srcs[i, :act].astype(np.int64) << 32
                ) | dsts[i, :act].astype(np.int64)
                keep = ~np.isin(slot_key, keys_i)
                new_cnt = int(keep.sum())
                srcs[i, :new_cnt] = srcs[i, :act][keep]
                srcs[i, new_cnt:act] = 0
                dsts[i, :new_cnt] = dsts[i, :act][keep]
                dsts[i, new_cnt:act] = 0
                if wts is not None:
                    wts[i, :new_cnt] = wts[i, :act][keep]
                    wts[i, new_cnt:act] = 0
                cnt_arr[i] = new_cnt
            sel = d_out == i
            if sel.any():
                np.add.at(
                    pg.deg_out[i],
                    (del_u[sel] - pg.v_start[i]).astype(np.int64),
                    -1,
                )
    return True


def partition_edge_multiset(pg) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Sorted directed-edge keys (and per-key min weights) of the ACTIVE
    out-slots — the structural fingerprint used by the identity-swap check
    and the patch-equivalence tests.  Duplicate slots (weight-lowerings)
    collapse to their minimum, matching the overlay's dedup semantics."""
    keys, ws = [], []
    for i in range(pg.p):
        act = int(pg.edge_count[i])
        k = (pg.edge_src[i, :act].astype(np.int64) << 32) | pg.edge_dst[
            i, :act
        ].astype(np.int64)
        keys.append(k)
        if pg.edge_weight is not None:
            ws.append(pg.edge_weight[i, :act])
    key = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    if pg.edge_weight is None:
        return unique_keys(key)
    return unique_keys(key, np.concatenate(ws) if ws else np.zeros(0, np.uint32))


def graph_from_partition(pg, n_real: Optional[int] = None,
                         symmetric: bool = True) -> Graph:
    """Reassemble a validated :class:`Graph` from a partition's active
    out-slots (mutated or not) — how the service bootstraps its overlay
    without having kept the original CSR around."""
    key, w = partition_edge_multiset(pg)
    src = (key >> 32).astype(np.int32)
    dst = (key & 0xFFFFFFFF).astype(np.int32)
    row_offsets = np.zeros(pg.n + 1, dtype=np.int64)
    row_offsets[1:] = np.cumsum(np.bincount(src, minlength=pg.n))
    g = Graph(
        n=pg.n,
        n_real=int(n_real) if n_real is not None else pg.n,
        src=src,
        dst=dst,
        row_offsets=row_offsets,
        symmetric=symmetric,
        weights=w,
    )
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Update-stream persistence (``bfs_run --updates`` replay format)
# ---------------------------------------------------------------------------


def write_update_stream(path: str, batches: List[EdgeBatch]) -> None:
    """One JSON object per line per batch (replayable by ``bfs_run
    --updates`` and :func:`read_update_stream`)."""
    with open(path, "w") as f:
        for b in batches:
            doc = {
                "insert": {
                    "src": b.insert_src.tolist(),
                    "dst": b.insert_dst.tolist(),
                    "weights": (
                        None if b.insert_weights is None
                        else b.insert_weights.tolist()
                    ),
                },
                "delete": {
                    "src": b.delete_src.tolist(),
                    "dst": b.delete_dst.tolist(),
                },
            }
            f.write(json.dumps(doc) + "\n")


def read_update_stream(path: str) -> List[EdgeBatch]:
    batches = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            ins = doc.get("insert", {})
            dele = doc.get("delete", {})
            w = ins.get("weights")
            batches.append(EdgeBatch(
                insert_src=np.asarray(ins.get("src", []), np.int64),
                insert_dst=np.asarray(ins.get("dst", []), np.int64),
                insert_weights=None if w is None else np.asarray(w, np.uint32),
                delete_src=np.asarray(dele.get("src", []), np.int64),
                delete_dst=np.asarray(dele.get("dst", []), np.int64),
            ))
    return batches
