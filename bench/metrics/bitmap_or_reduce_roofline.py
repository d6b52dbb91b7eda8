"""``bitmap_or_reduce_roofline``: the least bytes of the traced units' ``bitmap_or_reduce``
calls (:mod:`bench.roofline`) at the card's published HBM rate, as a % of
the kernel's device time in the traced segment."""

from bench import roofline


def read(run):
    return roofline.share(run, "bitmap_or_reduce")
