"""Sets of runs of one cell, and the spreads that its bounds are set from.

    python3 bench_port/spreads.py run --workload <name> --out <dir> --seeds <n> [<n> ...]
        [--seconds <s>] [--trace 0|1]
    python3 bench_port/spreads.py report <set A dir> <set B dir>

`run` runs `run.py` once a seed, one process after another, and keeps each
run's standard output and error as `<dir>/<workload>.<seed>.<trace>.out`
and `.err`.  `report` reads the result lines of two such sets (the same
seeds in both) and prints, per cell and end-to-end metric, each set's
spread (the distance between the first and third quartiles of
`statistics.quantiles(values, n=4)`, over the median), the trimmed spread
(each set's run farthest from its median left out, the two sets' mean),
set B's median against set A's, and five times the widest spread.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda k: abs(values[k] - med))
    return values[:far] + values[far + 1:]


def read_set(folder: Path) -> dict:
    """{workload: {metric: [values in seed order]}} of a set's untraced runs."""
    out = {}
    for path in sorted(folder.glob("*.0.out")):
        workload = path.name.rsplit(".", 3)[0]
        lines = path.read_text().strip().splitlines()
        if not lines:
            continue
        result = json.loads(lines[-1])
        for name, m in result["metrics"].items():
            out.setdefault(workload, {}).setdefault(name, []).append(m["value"])
        out[workload].setdefault("correct", []).append(float(result["correct"]))
    return out


def report(set_a: Path, set_b: Path) -> None:
    a, b = read_set(set_a), read_set(set_b)
    for workload in sorted(set(a) & set(b)):
        print(workload)
        for name in sorted(a[workload]):
            va, vb = a[workload][name], b[workload].get(name, [])
            if name == "correct":
                print(f"  correct: {int(sum(va))} of {len(va)} / {int(sum(vb))} of {len(vb)}")
                continue
            if len(va) < 3 or len(vb) < 3:
                continue
            sa, sb = spread(va), spread(vb)
            mean_trim = (spread(trimmed(va)) + spread(trimmed(vb))) / 2
            change = statistics.median(vb) / statistics.median(va) - 1
            print(f"  {name}: medians {statistics.median(va):.4f} / {statistics.median(vb):.4f} "
                  f"(B vs A {100 * change:+.2f}%); spreads {sa:.4f} / {sb:.4f}; "
                  f"trimmed {mean_trim:.4f}; 5 x widest {5 * max(sa, sb):.4f}")
            print(f"    A {[round(v, 4) for v in va]}")
            print(f"    B {[round(v, 4) for v in vb]}")


def run_set(workload: str, seeds: list, seconds: float, trace: int, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for seed in seeds:
        stem = out / f"{workload}.{seed}.{trace}"
        with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
            rc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", workload,
                                 "--seed", str(seed), "--seconds", str(seconds),
                                 "--trace", str(trace)], stdout=fo, stderr=fe,
                                cwd=str(BENCH_DIR.parent)).returncode
        tail = Path(f"{stem}.out").read_text().strip().splitlines()[-1:] or ["(no result)"]
        print(f"{workload} seed {seed} trace {trace} rc {rc}: {tail[0][:400]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--workload", required=True)
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--seconds", type=float)
    r.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p = sub.add_parser("report")
    p.add_argument("set_a", type=Path)
    p.add_argument("set_b", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "report":
        report(args.set_a, args.set_b)
        return 0
    if args.seconds is None:
        args.seconds = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())["run_seconds"]
    run_set(args.workload, args.seeds, args.seconds, args.trace, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
