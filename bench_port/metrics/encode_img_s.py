"""encode_img_s: images whose files came back in the window, a second."""

from harness.readings import rate


def read(r):
    return rate(r)
