"""``device_ms_per_search``: the device's busy time in the traced segment
(``torch.profiler``) over its searches: the part of a search the host's
pace does not move, steadier from run to run than the clocks."""


def read(run):
    t = run.traced
    if t is None or not t.busy_s or not run.traced_requests:
        return None
    return t.busy_s * 1e3 / run.traced_requests
