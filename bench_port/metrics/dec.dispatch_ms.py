"""dec.dispatch_ms: the median over the window's batches of the lane's
`dispatch_decode_batch` (the C++ parse, `narrow_levels`,
`to_device_batch` and the launches), in ms."""

from harness.readings import median


def read(r):
    return median(r.span_ms("lane", "dispatch"))
