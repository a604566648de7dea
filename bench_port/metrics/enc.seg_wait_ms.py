"""enc.seg_wait_ms: the median over the window's rounds of the lane's
wait for the next batch's segments (K8's alphas and the k-means behind
`dispatch_seg_results`), in ms."""

from harness.readings import median


def read(r):
    return median(r.span_ms("lane", "seg_wait"))
