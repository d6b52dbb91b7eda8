"""The level loop of level-synchronous traversals, run on the host.

The port of ``repro.core.loop.traced_while``: where the JAX package stages
one ``lax.while_loop``, PyTorch runs eagerly, so the loop is a Python
loop whose condition reads host values the step produced.  It records
the flight recorder's rows (:mod:`repro_torch.core.flightrec`) and,
when asked, each level's wall time.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, TypeVar

import torch

from repro_torch.core import flightrec

State = TypeVar("State")


def host_while(cond: Callable[[State], bool],
               step: Callable[[State], Tuple[State, Optional[tuple]]],
               state: State, *, trace_buffer: Optional[torch.Tensor] = None,
               level_ms: Optional[list] = None,
               sync: Callable[[], None] = lambda: None) -> State:
    """``while cond(state): state = step(state)[0]`` — ``lax.while_loop``'s
    contract, with ``cond`` evaluated on the host.

    ``step(state) -> (next_state, rec)``: ``rec`` is ``(index, row)`` when
    a ``trace_buffer`` (``int32[L, TRACE_COLS]``) is given, and ``row`` is
    written at ``index``; levels at ``index >= L`` still run and their rows
    are dropped, never wrapped.  A list ``level_ms`` takes each step's wall
    time in ms, the clock stopping after ``sync()`` returns."""
    while cond(state):
        t0 = time.perf_counter()
        state, rec = step(state)
        if trace_buffer is not None:
            flightrec.record(trace_buffer, *rec)
        if level_ms is not None:
            sync()
            level_ms.append((time.perf_counter() - t0) * 1e3)
    return state
