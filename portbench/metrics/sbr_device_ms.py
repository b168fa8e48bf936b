"""The SBR program's device time a chunk (the `runtime.graphs` replay that
`BatchDecoder._sbr_dispatch` enqueues), mean ms over the window: CUDA
events recorded on the decoder's compute stream around each dispatch
(`sbr_device`, routes/he.py)."""
import numpy as np


def read(run):
    d = run.device_s("sbr_device")
    return float(np.mean(d)) * 1e3 if d else None
