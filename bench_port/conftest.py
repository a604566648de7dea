"""The harness's own tests: CPU rehearsals at tiny sizes with the port's
plain twins; tests marked `cuda` need a card and skip without one."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips with a reason without one")
