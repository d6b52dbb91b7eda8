"""``idle_ms_per_level``: the traced units' own time in the window
(untraced) less the device's busy time as they run again under
``torch.profiler``, over the levels the port's replay of them ran."""


def read(run):
    t, levels = run.traced, run.counters.get("levels")
    if t is None or not t.busy_s or not levels:
        return None
    return (run.traced_untraced_s() - t.busy_s) * 1e3 / levels
