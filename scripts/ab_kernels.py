#!/usr/bin/env python3
"""Time the port's hand-written kernels of one tree on one CUDA GPU.

    python3 scripts/ab_kernels.py --tree DIR

DIR holds a checkout of the repository (this one, or an archive of another
commit).  The script builds DIR's kernels and runs DIR's own
`chip_smoke.phase_kernels` (every kernel at its chip_smoke shapes against
its plain version: CUDA events over 10 back-to-back calls, median of 20,
and torch.profiler device time), then prints its `kernel ...` lines, one
per kernel and shape, each tagged with the tree (`[parent]` or `[change]`).
`scripts/ab_kernels.sh PARENT_TREE` runs parent, change, change, parent in
one call, so that the spread of each time between two runs of one tree
stands beside the difference between the trees.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    from aacjax_torch.kernels import _build
    tag = "parent" if tree != REPO else "change"
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _build.build()
            smoke.phase_kernels(torch, torch.device("cuda"))
    except BaseException:
        print(out.getvalue()[-4000:])
        raise
    for line in out.getvalue().splitlines():
        if line.startswith("kernel "):
            print(f"[{tag}] {line}")


if __name__ == "__main__":
    main()
