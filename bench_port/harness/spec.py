"""`BENCHMARK.json` resolved to a cell: its configuration, traffic mix,
metrics and their readers, each found by name.

- a configuration: `configs/<file>` as its entry names it;
- a traffic mix: `traffic/<traffic>.json`, whose "runner" names the module
  of this package that runs it;
- a metric: `metrics/<name>.py`, whose `read(readings)` returns the number
  or None (nothing to read: the metric is left out of the result).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the metric entries this cell reports with --trace 0
    per_layer: list    # ... and with --trace 1


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell of `workload`; KeyError names what is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "bench_port" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    runner(traffic)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layers = [m for m in bench["per_layer"] if _applies(m, workload)]
    for m in e2e + layers:
        reader(m["name"], root)
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layers)


def runner(traffic: dict):
    """The module of this package that runs a traffic mix."""
    return importlib.import_module(f"{__package__}.{traffic['runner']}")


_readers = {}


def reader(name: str, root: Path = ROOT):
    """The `read` function of `metrics/<name>.py`."""
    path = root / "bench_port" / "metrics" / f"{name}.py"
    if path not in _readers:
        if not path.is_file():
            raise KeyError(f"no reader {path.relative_to(root)} for metric {name!r}")
        spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[path] = mod.read
    return _readers[path]
