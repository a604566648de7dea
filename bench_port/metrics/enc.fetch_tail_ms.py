"""enc.fetch_tail_ms: the median over the window's rounds of the lane's
fetch after `chain` (the wire's d2h, or the token fetch, the header
coders and K14), in ms."""

from harness.readings import median


def read(r):
    return median(r.span_ms("lane", "fetch_tail"))
