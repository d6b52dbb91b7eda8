"""The level loop of level-synchronous traversals, run on the host.

The port of ``repro.core.loop.traced_while``: where the JAX package stages
one ``lax.while_loop``, PyTorch runs eagerly, so the loop is a Python
loop whose condition reads one host value per level.  Per-level tracing
(the flight recorder) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, TypeVar

State = TypeVar("State")


def host_while(cond: Callable[[State], bool], step: Callable[[State], State],
               state: State) -> State:
    """``while cond(state): state = step(state)`` — ``lax.while_loop``'s
    contract, with ``cond`` evaluated on the host."""
    while cond(state):
        state = step(state)
    return state
