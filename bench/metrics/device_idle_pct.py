"""``device_idle_pct``: the share of the traced units' own time in the
window (untraced, by the host's clock) in which the device did not work:
their busy time comes from ``torch.profiler`` as they run again, so the
tracer's host cost does not count as idle."""


def read(run):
    t, wall = run.traced, run.traced_untraced_s()
    if t is None or not t.busy_s or wall <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / wall)
