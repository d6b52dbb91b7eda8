"""``search_ms_p50``: the median of every search in the window, by the
benchmark's clock around the port's search entry."""

import numpy as np


def read(run):
    return float(np.median(run.request_ms()))
