"""enc.finish_ms: the median over the window's batches of the host
finish on the caller's thread (`finish_frames_lossy_batch` or
`finish_frames_tokens`, and the RIFF wrap), in ms."""

from harness.readings import median


def read(r):
    return median(r.span_ms("main", "finish"))
