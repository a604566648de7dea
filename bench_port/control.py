"""The control of a cell's check, at the cell's own size on the card.

    python bench_port/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell with the control in the port's place
(the encode: the port's method 3, three B modes tried and no trellis; the
decode: the reference's decode with simple chroma upsampling), checked as
the benchmark checks it: each line gives the numbers compared and whether
the run came out correct, which a sound check refuses.  All seeds run in
this one process.  The benchmark's own runs never run it.
"""

import json
import sys
import time

import run


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from harness import spec

    bench = spec.load()
    for seed in args.seeds:
        res = run.run_cell(bench, args.workload, seed, args.seconds, False,
                           t_start=time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"],
                          "device": res["device"]["kind"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
