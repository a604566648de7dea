"""dec.batch_p95_ms: the 95th percentile over the batches ready in the window
of the time from the start of a batch's dispatch to its RGB being ready on
the card, in ms."""

from harness.readings import percentile


def read(r):
    return percentile(r.latencies_ms(), 95)
