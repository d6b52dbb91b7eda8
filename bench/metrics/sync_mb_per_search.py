"""``sync_mb_per_search``: the largest rank's ``Communicator.bytes_sent`` over
the traced units' replay, per search (per lane in a wave), in MB."""


def read(run):
    if "sync_bytes" not in run.counters or not run.traced_requests:
        return None
    return run.counters["sync_bytes"] / run.traced_requests / 1e6
