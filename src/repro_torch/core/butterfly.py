"""Butterfly communication schedule (the paper's core contribution).

The schedule is pure Python/NumPy data, so it can be

  * property-tested exhaustively (every P <= 64, every fanout),
  * simulated on the host to verify message/byte counts against the
    paper's analytical model (Sec. 3 of the paper),
  * replayed over simulated ranks by :mod:`repro_torch.core.collectives`.

This module is a copy of ``repro.core.butterfly``: the PyTorch port
imports nothing of the JAX package.  It holds the schedules, the byte
models of every sync (full-buffer, sparse, adaptive, Rabenseifner) and the
host simulators the port's collectives are tested against.

Terminology (paper Sec. 3):

  * ``P``       — number of compute nodes (simulated ranks here).
  * ``fanout``  — how many partners a node synchronizes with per round.
                  ``fanout=1`` in the paper == exchange with ONE partner per
                  round (pairwise recursive doubling).  We encode that as a
                  *digit size* of 2 (a pair exchanges), so paper-fanout ``f``
                  maps to digit size ``f + 1``?  No — the paper's Fig. 2
                  "fanout 4" synchronizes groups of 4 nodes per round
                  (16 nodes in 2 rounds), i.e. digit size 4 and 3 messages
                  sent per node per round.  Paper-fanout ``f`` therefore maps
                  to digit size ``max(2, f)`` with ``fanout 1 -> digit 2``
                  (one message sent per node per round, log2(P) rounds),
                  matching Fig. 1 exactly.
  * ``digit``   — mixed-radix digit of the rank id.  Round ``i`` synchronizes
                  all nodes whose rank differs only in digit ``i``.

Non-power-of-``f`` and non-power-of-two ``P`` are handled by mixed-radix
decomposition: ``P`` is factorized greedily into digits ``<= digit_size``;
a leftover prime ``> digit_size`` becomes its own (larger) digit — the paper
notes the degenerate single-digit case ``f = P`` is exactly all-to-all.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "digit_plan",
    "axes_digit_plan",
    "Round",
    "Schedule",
    "build_schedule",
    "messages_per_node",
    "total_messages",
    "bytes_per_node_allreduce",
    "bytes_per_node_rabenseifner",
    "bytes_per_node_all_to_all",
    "bytes_per_node_allgather",
    "sparse_round_capacities",
    "bytes_per_node_sparse",
    "expected_bytes_per_node_adaptive",
    "simulate_allreduce",
    "simulate_reduce_scatter_allgather",
    "simulate_or_sparse",
    "simulate_reduce_sparse",
    "peak_buffer_elems",
]

SPARSE_PAIR_BYTES = 8  # int32 word index + uint32 word on the wire
#: A sync's ranks: a rank count (one axis), or the sizes of the mesh axes
#: it runs over, in the order it runs them.
Ranks = Union[int, Sequence[int]]


def _digit_size(fanout: int) -> int:
    """Paper fanout -> mixed-radix digit size (see module docstring)."""
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    return max(2, fanout)


def digit_plan(p: int, fanout: int) -> List[int]:
    """Factorize ``p`` into mixed-radix digits, each ``<= max(2, fanout)``
    where possible.  ``prod(digits) == p`` always holds.

    Examples: ``digit_plan(16, 1) == [2, 2, 2, 2]`` (paper Fig. 1),
    ``digit_plan(16, 4) == [4, 4]`` (paper Fig. 2),
    ``digit_plan(12, 4) == [4, 3]``, ``digit_plan(13, 4) == [13]``.
    """
    if p < 1:
        raise ValueError(f"P must be >= 1, got {p}")
    d = _digit_size(fanout)
    digits: List[int] = []
    rem = p
    while rem > 1:
        # Greedy largest factor <= d; fall back to smallest prime factor.
        for cand in range(min(d, rem), 1, -1):
            if rem % cand == 0:
                digits.append(cand)
                rem //= cand
                break
        else:
            # rem's smallest factor exceeds d: take the smallest prime factor
            # (== rem itself if prime) as an oversized digit (all-to-all
            # within that digit group, the paper's f == CN degenerate case).
            f = _smallest_prime_factor(rem)
            digits.append(f)
            rem //= f
    return digits


def _smallest_prime_factor(n: int) -> int:
    for k in range(2, int(math.isqrt(n)) + 1):
        if n % k == 0:
            return k
    return n


@dataclasses.dataclass(frozen=True)
class Round:
    """One synchronization round of the butterfly network.

    ``perms[j]`` (for shift ``j`` in ``1..digit-1``) is a full permutation of
    ranks — ``perms[j][src] == dst`` — suitable for one ``Communicator.ppermute``.
    Each node sends ``digit - 1`` messages per round and receives the same.
    """

    digit: int
    stride: int
    perms: Tuple[Tuple[int, ...], ...]  # (digit-1) permutations, each len P

    @property
    def n_messages_per_node(self) -> int:
        return self.digit - 1


@dataclasses.dataclass(frozen=True)
class Schedule:
    p: int
    fanout: int
    digits: Tuple[int, ...]
    rounds: Tuple[Round, ...]

    @property
    def depth(self) -> int:
        return len(self.rounds)


def _partner(g: int, j: int, digit: int, stride: int) -> int:
    """Rank whose digit (at ``stride``) is ``j`` ahead of ``g``'s, cyclically."""
    dig = (g // stride) % digit
    return g + (((dig + j) % digit) - dig) * stride


def build_schedule(p: int, fanout: int, *, msb_first: bool = False) -> Schedule:
    """Build the full butterfly schedule for ``p`` ranks.

    ``msb_first=False`` (default) runs small-stride digits first — on a
    hierarchical machine, map the FAST interconnect to low strides so slow
    links (e.g. the inter-pod DCI) carry only the final round(s).
    """
    digits = digit_plan(p, fanout)
    order = list(range(len(digits)))
    if msb_first:
        order = order[::-1]
    strides = []
    s = 1
    for d in digits:
        strides.append(s)
        s *= d
    rounds: List[Round] = []
    for i in order:
        d, stride = digits[i], strides[i]
        perms = tuple(
            tuple(_partner(g, j, d, stride) for g in range(p)) for j in range(1, d)
        )
        rounds.append(Round(digit=d, stride=stride, perms=perms))
    return Schedule(p=p, fanout=fanout, digits=tuple(digits), rounds=tuple(rounds))


# ---------------------------------------------------------------------------
# Analytical model (paper Sec. 3 complexity analysis)
# ---------------------------------------------------------------------------


def axes_digit_plan(p: Ranks, fanout: int) -> List[int]:
    """The digits of a sync's rounds: :func:`digit_plan` of a rank count,
    or, for the sizes of mesh axes, each axis's plan in turn (the first
    axis first), as ``Communicator.rounds(fanout, axes)`` runs them."""
    if isinstance(p, (int, np.integer)):
        return digit_plan(int(p), fanout)
    return [d for a in p for d in digit_plan(int(a), fanout)]


def group_size(p: Ranks) -> int:
    """The ranks a sync over ``p`` (a count or the axes' sizes) reduces."""
    return int(p) if isinstance(p, (int, np.integer)) else math.prod(int(a) for a in p)


def messages_per_node(p: Ranks, fanout: int) -> int:
    """Messages *sent* by each node over the whole butterfly.

    Paper counts ``f * log_f(CN)``; we count the exact ``sum(d_i - 1)``
    (no self-message), which the paper's expression upper-bounds.  Over
    mesh axes (``p`` their sizes) the axes' rounds add up.
    """
    return sum(d - 1 for d in axes_digit_plan(p, fanout))


def total_messages(p: int, fanout: int) -> int:
    return p * messages_per_node(p, fanout)


def bytes_per_node_allreduce(p: Ranks, fanout: int, nbytes: int) -> int:
    """Bytes sent per node for the paper-style full-buffer butterfly
    (every round ships the whole O(V) frontier / gradient buffer)."""
    return messages_per_node(p, fanout) * nbytes


def bytes_per_node_rabenseifner(p: Ranks, fanout: int, nbytes: int) -> int:
    """Bytes sent per node for reduce-scatter + all-gather on the same
    butterfly wiring (beyond-paper optimization): ``2 * (P-1)/P * nbytes``
    for the power-of-digit case; computed exactly from the digit plan.
    Over mesh axes the stages of every axis split one buffer, so a buffer
    of a multiple of ``prod(p)`` bytes costs what the group of
    ``prod(p)`` ranks costs."""
    digits = axes_digit_plan(p, fanout)
    sent = 0
    size = nbytes
    for d in digits:  # reduce-scatter: send (d-1) chunks of size/d each round
        size //= d
        sent += (d - 1) * size
    # all-gather mirrors it
    return 2 * sent


def bytes_per_node_all_to_all(p: Ranks, nbytes: int) -> int:
    """Bytes sent per node by the all-to-all broadcast-merge: ``P - 1``
    ring shifts of the whole buffer, axis by axis over mesh axes
    (``sum(a - 1)`` buffers)."""
    sizes = (p,) if isinstance(p, (int, np.integer)) else tuple(p)
    return sum(int(a) - 1 for a in sizes) * nbytes


def bytes_per_node_allgather(p: Ranks, nbytes: int) -> int:
    """Bytes sent per node by the all-gather that stands for the
    compiler's collective: the buffer to each of the ``G - 1`` other
    ranks of the group (``G = prod(p)`` over mesh axes)."""
    return (group_size(p) - 1) * nbytes


def sparse_round_capacities(
    p: Ranks, fanout: int, capacity: int, n_words: int | None = None
) -> List[int]:
    """Per-round send capacity (in (idx, word) pairs) of the sparse butterfly.

    Round ``r`` ships up to ``capacity * prod(digits[:r])`` pairs — the
    union-growth bound: after ``r`` rounds each accumulator holds at most
    that many active words when every initial frontier fits ``capacity``.
    Clamped at ``n_words`` (a compaction can never exceed the dense size).
    Over mesh axes the digit product carries from one axis to the next.
    """
    caps: List[int] = []
    c = capacity
    for d in axes_digit_plan(p, fanout):
        caps.append(min(c, n_words) if n_words is not None else c)
        c *= d
    return caps


def bytes_per_node_sparse(
    p: Ranks,
    fanout: int,
    capacity: int,
    n_words: int | None = None,
    pair_bytes: int = SPARSE_PAIR_BYTES,
) -> int:
    """Wire bytes sent per node by :func:`collectives.butterfly_or_sparse`:
    ``(d_r - 1)`` messages of ``cap_r`` pairs per round (paper Sec. 3 model
    extended to the compact wire format)."""
    caps = sparse_round_capacities(p, fanout, capacity, n_words)
    return sum(
        (d - 1) * cap * pair_bytes
        for d, cap in zip(axes_digit_plan(p, fanout), caps)
    )


def expected_bytes_per_node_adaptive(
    p: Ranks,
    fanout: int,
    n_words: int,
    density: float,
    capacity: int,
    word_bytes: int = 4,
    *,
    density_threshold: float | None = None,
    mean_bits_per_word: float = 32.0,
) -> int:
    """Per-level wire bytes of the ADAPTIVE sync at a given active-WORD
    density (fraction of ``n_words`` nonzero on the densest rank).

    Mirrors both conditions of ``collectives.butterfly_or_adaptive``: the
    capacity fit (``density * n_words <= capacity``) and, when
    ``density_threshold`` is given, the popcount guard — modeled as
    ``active_words * mean_bits_per_word <= threshold * n_words * 32``
    (set ``mean_bits_per_word`` to the expected set bits per active word;
    32 is the pessimistic fully-populated-word case)."""
    active_words = math.ceil(density * n_words)
    sparse_ok = active_words <= min(capacity, n_words)
    if density_threshold is not None:
        popcount = active_words * mean_bits_per_word
        sparse_ok = sparse_ok and popcount <= density_threshold * n_words * 32
    if sparse_ok:
        return bytes_per_node_sparse(p, fanout, capacity, n_words)
    return bytes_per_node_allreduce(p, fanout, n_words * word_bytes)


def peak_buffer_elems(p: int, fanout: int, v: int) -> int:
    """Paper Contribution 4: intermediate buffers are bounded by O(f * V).

    One accumulator + (digit-1) in-flight receive buffers, each O(V)."""
    d = _digit_size(fanout)
    return d * v


# ---------------------------------------------------------------------------
# Host-side simulators (oracles for tests; mirror what the collectives do)
# ---------------------------------------------------------------------------


def simulate_allreduce(
    values: Sequence[np.ndarray],
    fanout: int,
    op: Callable[[np.ndarray, np.ndarray], np.ndarray] = np.add,
) -> List[np.ndarray]:
    """Simulate the full-buffer butterfly all-reduce on the host.

    Returns the per-rank results; every rank must end with op-reduce of all
    inputs.  This mirrors ``collectives.butterfly_allreduce`` exactly
    (same schedule, same merge order)."""
    p = len(values)
    sched = build_schedule(p, fanout)
    state = [np.array(v) for v in values]
    for rnd in sched.rounds:
        received: List[List[np.ndarray]] = [[] for _ in range(p)]
        for perm in rnd.perms:
            for src, dst in enumerate(perm):
                received[dst].append(state[src])
        state = [
            _merge_all(state[g], received[g], op) for g in range(p)
        ]
    return state


def _merge_all(acc, incoming, op):
    for r in incoming:
        acc = op(acc, r)
    return acc


def simulate_or_sparse(
    bitmaps: Sequence[np.ndarray],
    fanout: int,
    capacity: int,
    *,
    fallback: bool = True,
):
    """Host oracle for ``collectives.butterfly_or_sparse`` (+ its fallback).

    Mirrors the collective operation for operation: per round every rank
    compacts its CURRENT accumulator to the round capacity (ascending word
    index, truncating past capacity — same semantics as the size-bounded
    compaction of :func:`frontier.compact_words`), ships the pairs along the schedule's permutations, and
    scatter-ORs what it receives.  With ``fallback=True`` an initial count
    over ``capacity`` on ANY rank reroutes to the dense full-bitmap
    butterfly, exactly like the overflow guard.

    Returns ``(per_rank_bitmaps, stats)`` where ``stats`` records the mode
    taken and the analytic wire bytes per node for that mode.
    """
    p = len(bitmaps)
    n_words = int(bitmaps[0].size)
    state = [np.array(b, dtype=np.uint32) for b in bitmaps]
    cap0 = min(capacity, n_words)
    overflow = any(int(np.count_nonzero(b)) > cap0 for b in state)
    if fallback and overflow:
        merged = simulate_allreduce(state, fanout, op=np.bitwise_or)
        return merged, {
            "mode": "dense",
            "bytes_per_node": bytes_per_node_allreduce(p, fanout, n_words * 4),
        }

    sched = build_schedule(p, fanout)
    caps = sparse_round_capacities(p, fanout, capacity, n_words)
    for rnd, cap in zip(sched.rounds, caps):
        # compact once per rank against the pre-round accumulator
        compacts = []
        for g in range(p):
            idx = np.flatnonzero(state[g])[:cap]
            compacts.append((idx, state[g][idx]))
        for perm in rnd.perms:
            for src, dst in enumerate(perm):
                idx, vals = compacts[src]
                state[dst][idx] |= vals
    return state, {
        "mode": "sparse",
        "bytes_per_node": bytes_per_node_sparse(p, fanout, capacity, n_words),
    }


def simulate_reduce_sparse(
    buffers: Sequence[np.ndarray],
    fanout: int,
    capacity: int,
    *,
    combine: Callable[[np.ndarray, np.ndarray], np.ndarray],
    identity,
    ref: np.ndarray | None = None,
    fallback: bool = True,
):
    """Host oracle for ``collectives.butterfly_reduce_sparse`` — the monoid
    generalization of :func:`simulate_or_sparse` (DESIGN.md §14).

    Per round every rank compacts the words of its CURRENT accumulator that
    differ from ``ref`` (ascending index, truncating past the round
    capacity), ships ``(idx, vals)`` along the schedule's permutations, and
    combines what it receives.  ``ref`` defaults to the all-identity buffer
    (for OR that makes "changed" == "nonzero", as in :func:`simulate_or_sparse`).
    With ``fallback=True`` an initial changed count over ``capacity`` on
    ANY rank reroutes to the dense full-buffer butterfly, exactly like the
    overflow guard.  Inputs must satisfy the monotonicity contract of
    ``collectives.butterfly_reduce_sparse``: every change is a
    combine-improvement over the shared ``ref``.

    Returns ``(per_rank_buffers, stats)``; ``stats`` records the mode taken
    and the analytic wire bytes per node for that mode.
    """
    p = len(buffers)
    n_words = int(buffers[0].size)
    state = [np.array(b) for b in buffers]
    if ref is None:
        ref = np.full(n_words, identity, dtype=state[0].dtype)
    cap0 = min(capacity, n_words)
    overflow = any(int(np.count_nonzero(b != ref)) > cap0 for b in state)
    if fallback and overflow:
        merged = simulate_allreduce(state, fanout, op=combine)
        return merged, {
            "mode": "dense",
            "bytes_per_node": bytes_per_node_allreduce(
                p, fanout, n_words * state[0].itemsize
            ),
        }

    sched = build_schedule(p, fanout)
    caps = sparse_round_capacities(p, fanout, capacity, n_words)
    for rnd, cap in zip(sched.rounds, caps):
        # compact once per rank against the pre-round accumulator
        compacts = []
        for g in range(p):
            idx = np.flatnonzero(state[g] != ref)[:cap]
            compacts.append((idx, state[g][idx]))
        for perm in rnd.perms:
            for src, dst in enumerate(perm):
                idx, vals = compacts[src]
                state[dst][idx] = combine(state[dst][idx], vals)
    return state, {
        "mode": "sparse",
        "bytes_per_node": bytes_per_node_sparse(p, fanout, capacity, n_words),
    }


def simulate_reduce_scatter_allgather(
    values: Sequence[np.ndarray], fanout: int
) -> List[np.ndarray]:
    """Simulate Rabenseifner (recursive halving + doubling) on the butterfly
    wiring; oracle for ``collectives.butterfly_allreduce_rabenseifner``."""
    p = len(values)
    sched = build_schedule(p, fanout)
    n = values[0].size
    if n % p:
        raise ValueError(f"buffer size {n} must be divisible by P={p}")
    flat = [np.array(v).reshape(p, -1).astype(np.float64) for v in values]

    # --- reduce-scatter: process digits most-significant first so the kept
    # chunk range stays contiguous.
    rounds_msb = sorted(sched.rounds, key=lambda r: -r.stride)
    lo = [0] * p
    size = [p] * p
    bufs = [flat[g].copy() for g in range(p)]  # each starts with all chunks
    for rnd in rounds_msb:
        d, stride = rnd.digit, rnd.stride
        newsize = size[0] // d
        outgoing = {}
        for g in range(p):
            dig = (g // stride) % d
            outgoing[g] = {}
            for j in range(1, d):
                partner = _partner(g, j, d, stride)
                pdig = (dig + j) % d
                # send the sub-range that belongs to partner's digit
                outgoing[g][partner] = bufs[g][
                    lo[g] + pdig * newsize : lo[g] + (pdig + 1) * newsize
                ].copy()
        for g in range(p):
            dig = (g // stride) % d
            mylo = lo[g] + dig * newsize
            for j in range(1, d):
                partner = _partner(g, j, d, stride)
                bufs[g][mylo : mylo + newsize] += outgoing[partner][g]
            lo[g] = mylo
            size[g] = newsize
    # each rank now owns chunk == its rank id
    for g in range(p):
        assert size[g] == 1 and lo[g] == g, (g, lo[g], size[g])

    # --- all-gather: reverse order (least-significant first)
    rounds_lsb = sorted(rounds_msb, key=lambda r: r.stride)
    lo = list(range(p))
    size = [1] * p
    for rnd in rounds_lsb:
        d, stride = rnd.digit, rnd.stride
        outgoing = {}
        for g in range(p):
            outgoing[g] = bufs[g][lo[g] : lo[g] + size[g]].copy()
        for g in range(p):
            dig = (g // stride) % d
            base = lo[g] - dig * size[g]
            for j in range(1, d):
                partner = _partner(g, j, d, stride)
                pdig = (dig + j) % d
                bufs[g][base + pdig * size[g] : base + (pdig + 1) * size[g]] = (
                    outgoing[partner]
                )
            lo[g] = base
            size[g] = size[g] * d
    return [bufs[g].reshape(values[0].shape) for g in range(p)]
