"""enc.fetch_mid_ms: the median over the window's rounds of the lane's
fetch from `early_chain` to `chain` (the probabilities, K7, the pass-2
launches), in ms."""

from harness.readings import median


def read(r):
    return median(r.span_ms("lane", "fetch_mid"))
