"""The host parse of an LC chunk (`BatchDecoder._parse_native`: one call
into native/libaacparse.so, then the compaction), mean ms a chunk over the
window: host spans named `parse` (routes/lc.py)."""
import numpy as np


def read(run):
    d = run.host_s("parse")
    return float(np.mean(d)) * 1e3 if d else None
