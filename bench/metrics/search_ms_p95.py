"""``search_ms_p95``: the 95th percentile of every search in the window, each
timed from when it was due (in a closed loop, its dispatch) to the
synchronise that ends it."""

import numpy as np


def read(run):
    return float(np.percentile(run.request_ms(), 95))
