"""The level loop of level-synchronous traversals, run on the host.

The port of ``repro.core.loop.traced_while``: where the JAX package stages
one ``lax.while_loop``, PyTorch runs eagerly, so the loop is a Python
loop whose condition reads host values the step produced.  It records
the flight recorder's rows (:mod:`repro_torch.core.flightrec`), a
``loop.level`` span around each step (:mod:`repro_torch.core.tracing`)
and, when asked, each level's wall time from that span's clock points.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, TypeVar

import torch

from repro_torch.core import flightrec, tracing

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
    are dropped, never wrapped.  Each step runs inside a ``loop.level``
    span (arg ``index``).  A list ``level_ms`` takes each step's wall time
    in ms, from the span's two clock points, the clock stopping after
    ``sync()`` returns."""
    level = tracing.span if level_ms is None else tracing.clocked
    index = 0
    while cond(state):
        with level("loop.level", index=index) as lvl:
            state, rec = step(state)
            if trace_buffer is not None:
                flightrec.record(trace_buffer, *rec)
            if level_ms is not None:
                sync()
        if level_ms is not None:
            level_ms.append((lvl.t1 - lvl.t0) * 1e3)
        index += 1
    return state
