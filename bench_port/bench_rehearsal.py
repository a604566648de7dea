"""Tiny CPU rehearsals of the cells for the harness's tests: the port's
plain twins at 32x32, batches of 2 from a pool of 3, two workers.  The
tests rehearse the cells of `BENCHMARK.json` and those that `later.json`
keeps for a later PR alike."""

from __future__ import annotations

import json
import time

import run
from harness import spec

TINY = {"config": {"width": 32, "height": 32},
        "traffic": {"batch": 2, "pool": 3, "stride": 1, "warmup_rounds": 1,
                    "check_workers": 2, "gen_workers": 2,
                    "sample_batches": 2}}
SEED = 2**31 + 12345  # over 32 signed bits, as the benchmark's seeds may be


def with_later(bench: dict) -> dict:
    """BENCHMARK.json with the entries of `later.json` added back."""
    later = json.loads((spec.BENCH_DIR / "later.json").read_text())
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += later[key]
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in later["add_workloads_to"]:
            m["workloads"] = m["workloads"] + later["add_workloads_to"][m["name"]]
    return out


BENCH = with_later(spec.load())


def rehearse(workload: str, trace: bool = False, seed: int = SEED, **kw) -> dict:
    """One run of `workload` on the CPU at the tiny size."""
    return run.run_cell(BENCH, workload, seed, 0.5, trace, device="cpu",
                        t_start=time.perf_counter(), overrides=TINY, **kw)


def outcome(workload: str, trace: bool = True, seed: int = SEED, config: dict = None, **kw):
    """The runner's `Outcome` of one tiny CPU run (`config` overrides more)."""
    cell = spec.resolve(BENCH, workload)
    cell = cell._replace(config={**cell.config, **TINY["config"], **(config or {})},
                         traffic={**cell.traffic, **TINY["traffic"]})
    return spec.runner(cell.traffic).run(cell, seed, 0.5, trace, "cpu", time.perf_counter(),
                                         log=lambda line: None, **kw)
