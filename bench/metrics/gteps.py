"""``gteps``: Graph500's TEPS over the whole window, in GTEP/s.  Each search
finished in the window counts the generated tuples inside its root's
component, self-loops and repeats included, as the reference counts them
(the check's ``tuples``); their sum over the window's seconds."""


def read(run):
    if "tuples" not in run.counts:
        return None
    return float(run.counts["tuples"].sum()) / run.window_s / 1e9
