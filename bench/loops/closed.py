"""The closed loop: the next unit is sent when the last one has finished,
so each unit is due when it is sent."""

import time


def window(step, next_unit, seconds, keep, traffic, rng):
    """Units sent one after another until one finishes past ``seconds``;
    ``keep(unit, out)`` is shown each unit and its output."""
    from bench.harness import Unit

    units = []
    deadline = time.perf_counter() + seconds
    while True:
        requests = next_unit()
        t0 = time.perf_counter()
        out = step(requests)
        unit = Unit(requests, t0, t0, time.perf_counter())
        units.append(unit)
        keep(unit, out)
        del out
        if unit.t1 >= deadline:
            return units
