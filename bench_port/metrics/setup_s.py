"""setup_s: seconds from the process's start to the window's (imports, the CUDA
context, the libraries, the inputs from the seed, the warm-up rounds)."""


def read(r):
    return r.setup_s
