"""enc.batch_p95_ms: the 95th percentile over the batches back in the window
of the time from handing a batch's frames to the lane (its colour
conversion) to its files, in ms."""

from harness.readings import percentile


def read(r):
    return percentile(r.latencies_ms(), 95)
