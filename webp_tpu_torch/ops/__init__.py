"""Decode kernels of the port: each module holds a CUDA kernel's wrapper and
its plain torch twin (see the module docstrings)."""
