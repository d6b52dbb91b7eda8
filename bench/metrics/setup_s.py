"""``setup_s``: from process start to the first timed search: inputs, the
port's ETL and placement, the kernel library's load, the warm-up."""


def read(run):
    return run.setup_s
