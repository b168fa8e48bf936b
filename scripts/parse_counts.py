"""The native parse's counts over one run of a benchmark cell.

The run is `portbench.run.run_cell` with the program's recorder
(`BatchDecoder.trace`) switched on in the serving decoder; the script sums
the counters parse_fused_bands, parse_general_bands,
parse_gain_table_misses, parse_workers and parse_tail_ns over the chunks
the decoder parsed (warm-up chunks included), and gives beside them the
mean a chunk of parse_workers, parse_tail_ns and the `parse.native` span,
and the CPUs the process may run on (its affinity mask) and the host's
count.  It prints one JSON line.

On a card, from the repository root:
    python3 scripts/parse_counts.py --workload lc256k.bulk --seed 7
On the CPU, at a small size:
    python3 scripts/parse_counts.py --workload lc256k.bulk --seed 7 \\
        --device cpu --streams 8 --seconds 2
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from aacjax_torch.runtime.batch import PARSE_COUNTERS  # noqa: E402
from aacjax_torch.runtime.stats import Trace  # noqa: E402
from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=None,
                    help="override the cell's stream count (CPU runs)")
    args = ap.parse_args(argv)

    traces = []

    def tamper(dec, serve):
        dec.trace = Trace()
        traces.append(dec.trace)
        return serve

    traffic = {"streams": args.streams} if args.streams else None
    line, _ = run.run_cell(args.workload, args.seed, args.seconds, False,
                           device=args.device, tamper=tamper,
                           traffic=traffic)
    tr = traces[0]
    counts = {n: sum(v for (k, _), v in tr.counters.items() if k == n)
              for n in PARSE_COUNTERS}
    chunks = sorted({c for k, c in tr.counters if k == PARSE_COUNTERS[0]})
    native_ms = [(s.t1_ns - s.t0_ns) * 1e-6 for s in tr.spans
                 if s.name == "parse.native" and s.t1_ns]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": line.get("device"), "correct": line.get("correct"),
        "chunks_counted": len(chunks), **counts,
        "parse_workers_mean": (counts["parse_workers"] / len(chunks)
                               if chunks else None),
        "parse_tail_ns_mean": (counts["parse_tail_ns"] / len(chunks)
                               if chunks else None),
        "parse_native_ms_mean": (sum(native_ms) / len(native_ms)
                                 if native_ms else None),
        "affinity_cpus": len(os.sched_getaffinity(0)),
        "cpu_count": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
