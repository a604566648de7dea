"""enc.device_idle_pct: the share of the traced window in which no
kernel, copy or set ran on the card, in %."""

from harness.readings import idle_pct


def read(r):
    return idle_pct(r)
