"""``frontier_scatter_roofline``: the least bytes of the traced units' ``frontier_scatter``
calls (:mod:`bench.roofline`) at the card's published HBM rate, as a % of
the kernel's device time in the traced segment."""

from bench import roofline


def read(run):
    return roofline.share(run, "frontier_scatter")
