#!/usr/bin/env python3
"""Peak resident memory of one pytest process (no xdist) that runs the
given test ids in order, on the CPU:

    python3 scripts/test_rss.py TEST_ID [TEST_ID ...]

Prints `peak_rss_gib=<x> rc=<pytest exit code>`.  Running a test alone and
again after another module in the same process shows what that module
leaves behind for the tests an xdist worker runs after it.
"""
from __future__ import annotations

import os
import resource
import subprocess
import sys


def main() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rc = subprocess.call([sys.executable, "-m", "pytest", "-q", "-p",
                          "no:cacheprovider", "-p", "no:randomly", "-n", "0",
                          *sys.argv[1:]], env=env,
                         stdout=subprocess.DEVNULL)
    kib = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    print(f"peak_rss_gib={kib / 2**20:.2f} rc={rc}")


if __name__ == "__main__":
    main()
