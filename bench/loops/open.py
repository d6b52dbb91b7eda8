"""The open loop: units fall due at the mix's fixed rate (``rate_per_s``),
at even intervals or, with ``"arrivals": "poisson"``, at exponential ones
drawn from the seed.  A unit is sent when it is due, or when the one
before it has finished if that is later, and is timed from when it was
due, so the wait behind a late unit counts.  Every unit due inside the
window is sent and finished."""

import time


def window(step, next_unit, seconds, keep, traffic, rng):
    from bench.harness import Unit

    rate = float(traffic["rate_per_s"])
    poisson = traffic.get("arrivals", "even") == "poisson"
    units = []
    start = time.perf_counter()
    due = start
    while due < start + seconds:
        requests = next_unit()
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        t0 = time.perf_counter()
        out = step(requests)
        unit = Unit(requests, due, t0, time.perf_counter())
        units.append(unit)
        keep(unit, out)
        del out
        due += float(rng.exponential(1.0 / rate)) if poisson else 1.0 / rate
    return units
