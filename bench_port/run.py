"""The benchmark of the PyTorch and CUDA port (`webp_tpu_torch`), one run of one cell.

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for: it resolves the workload of `BENCHMARK.json`, runs its traffic mix's
runner (set-up, warm-up, the measured window, then the check against the
plain reference), and prints as its last line one JSON object with
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `checks`: each number compared with its limit, which
are also the last lines on standard error.  Without a card, with fewer
cards than the cell asks for, or when jax, jaxlib, flax or the JAX package
was loaded in this process, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "webp_tpu")
HOST_LOOP = 2_000_000


def host_probe_ms() -> float:
    """The time of a fixed single-thread Python loop, in ms: the host's own
    speed, which moves between runs, beside the run's readings."""
    t0 = time.perf_counter()
    sum(i * i for i in range(HOST_LOOP))
    return (time.perf_counter() - t0) * 1e3


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `webp_tpu_torch` is not `webp_tpu`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, overrides: dict = None,
             control: bool = False, fault=None, root: Path = ROOT) -> dict:
    """The result of one run of `workload` on `device` (the harness's tests
    run it on the CPU, with `overrides` {"config": {...}, "traffic": {...}}
    merged into the cell's files, `control` or a `fault`)."""
    from harness import spec
    from harness.loop import log_err

    cell = spec.resolve(bench, workload, root)
    if overrides:
        cell = cell._replace(config={**cell.config, **overrides.get("config", {})},
                             traffic={**cell.traffic, **overrides.get("traffic", {})})
    out = spec.runner(cell.traffic).run(cell, seed, seconds, trace, device,
                                        T_START if t_start is None else t_start,
                                        control=control, fault=fault, log=log_err)
    log_err(f"[window] images a 5 s slice: {out.readings.slices(5.0)}")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], root)(out.readings)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    correct = out.failed == 0 and out.attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dict(out.device)}
    summary = out.readings.trace
    if trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from harness import spec
    from harness.loop import log_err as err

    bench = spec.load()
    cell = spec.resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        err(f"modules that the port's benchmark may not load were loaded: {found}")
        return 3
    err(f"[host] a fixed single-thread Python loop took {host_probe_ms():.1f} ms")
    for name, c in result["checks"].items():
        err(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
