"""Readings for the output check's limits (portbench/check.py), the runs
of many seeds in one process:

    python -m portbench.calibrate --workload NAME --seeds 1,2,3 --seconds S
    python -m portbench.calibrate --workload NAME --seeds 1,2,3 --seconds S \\
        --control tf32

Each seed is one run of the cell as portbench.run makes it (its own
slots, window and sample), at the cell's own size.  Without --control the
program's readings (the lower reading of each number); with it, the
reference in that precision put in the program's place (the upper).
Prints one JSON line a seed.  The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    from portbench import run
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, readings = run.run_cell(args.workload, seed, args.seconds,
                                        False, control=args.control,
                                        t_start=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "readings": readings,
                          "correct": result["correct"],
                          "metrics": result["metrics"],
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
