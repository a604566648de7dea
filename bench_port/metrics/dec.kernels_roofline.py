"""dec.kernels_roofline: the least time of the window's decode work on
the card (`harness.roofline`) over the window's kernel time in the trace,
in %."""

from harness.readings import roofline_pct


def read(r):
    return roofline_pct(r)
