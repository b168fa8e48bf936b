"""The HE host phase of a chunk (`BatchDecoder._he_host_phase`: the core
parse, the SBR parse with its payload cache, the pack and staging), mean
ms a chunk over the window: host spans named `he_host` (routes/he.py)."""
import numpy as np


def read(run):
    d = run.host_s("he_host")
    return float(np.mean(d)) * 1e3 if d else None
