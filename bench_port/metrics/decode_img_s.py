"""decode_img_s: images whose RGB was ready on the card in the window, a second."""

from harness.readings import rate


def read(r):
    return rate(r)
