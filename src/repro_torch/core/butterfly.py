"""Butterfly communication schedule (the paper's core contribution).

The schedule is pure Python/NumPy data, so it can be

  * property-tested exhaustively (every P <= 64, every fanout),
  * simulated on the host to verify message/byte counts against the
    paper's analytical model (Sec. 3 of the paper),
  * replayed over simulated ranks by :mod:`repro_torch.core.collectives`.

This module is a copy of the parts of ``repro.core.butterfly`` that the
dense syncs use (schedules, the full-buffer byte model and
``simulate_allreduce``; the sparse, adaptive and Rabenseifner byte models,
their simulators and ``msb_first`` come with the syncs that need them):
the PyTorch port imports nothing of the JAX package.

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
from typing import Callable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "digit_plan",
    "Round",
    "Schedule",
    "build_schedule",
    "messages_per_node",
    "total_messages",
    "bytes_per_node_allreduce",
    "simulate_allreduce",
]


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
    ranks — ``perms[j][src] == dst`` — suitable for one ``lax.ppermute``.
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


def build_schedule(p: int, fanout: int) -> Schedule:
    """Build the full butterfly schedule for ``p`` ranks, small-stride
    digits first (the reference's default order)."""
    digits = digit_plan(p, fanout)
    strides = []
    s = 1
    for d in digits:
        strides.append(s)
        s *= d
    rounds: List[Round] = []
    for d, stride in zip(digits, strides):
        perms = tuple(
            tuple(_partner(g, j, d, stride) for g in range(p)) for j in range(1, d)
        )
        rounds.append(Round(digit=d, stride=stride, perms=perms))
    return Schedule(p=p, fanout=fanout, digits=tuple(digits), rounds=tuple(rounds))


# ---------------------------------------------------------------------------
# Analytical model (paper Sec. 3 complexity analysis)
# ---------------------------------------------------------------------------


def messages_per_node(p: int, fanout: int) -> int:
    """Messages *sent* by each node over the whole butterfly.

    Paper counts ``f * log_f(CN)``; we count the exact ``sum(d_i - 1)``
    (no self-message), which the paper's expression upper-bounds.
    """
    return sum(d - 1 for d in digit_plan(p, fanout))


def total_messages(p: int, fanout: int) -> int:
    return p * messages_per_node(p, fanout)


def bytes_per_node_allreduce(p: int, fanout: int, nbytes: int) -> int:
    """Bytes sent per node for the paper-style full-buffer butterfly
    (every round ships the whole O(V) frontier / gradient buffer)."""
    return messages_per_node(p, fanout) * nbytes


# ---------------------------------------------------------------------------
# Host-side simulators (oracles for tests; mirror what the JAX collectives do)
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
