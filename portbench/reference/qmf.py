"""The SBR QMF banks' constants in float64: the prototype filter c(n) of
ISO/IEC 14496-3 (from sbr_tables.npz), the 32-band analysis modulation
and the 64-band synthesis modulation and tap map.  The arithmetic is that
of the port's kernels/qmf.py, kept here in float64 throughout (the port
stores its tables as float32)."""
from __future__ import annotations

import functools
import pathlib

import numpy as np

_SBR_NPZ = pathlib.Path(__file__).parent / "sbr_tables.npz"

ANA_BANDS = 32      # analysis bands (core rate)
SYN_BANDS = 64      # synthesis bands (2x rate)
ANA_TAPS = 320      # downsampled prototype length
SYN_TAPS = 640
ANA_HIST = ANA_TAPS - ANA_BANDS   # 288 samples carried between frames
SYN_HIST = 9        # v-vectors carried between frames


@functools.lru_cache(maxsize=None)
def prototype() -> np.ndarray:
    """[640] float64 QMF prototype filter c(n)."""
    return np.load(_SBR_NPZ)["qmf_window_us"].astype(np.float64)


@functools.lru_cache(maxsize=None)
def _analysis_consts():
    """(2 c(2n) [320], Re and Im of the modulation [64, 32])."""
    c = prototype()
    win_ds = 2.0 * c[::2]
    n = np.arange(64, dtype=np.float64)
    k = np.arange(ANA_BANDS, dtype=np.float64)
    ang = np.pi / 64.0 * (k[:, None] + 0.5) * (2.0 * n[None, :] - 0.5)
    m = np.exp(1j * ang)                        # [32, 64]
    return win_ds, m.real.T.copy(), m.imag.T.copy()


@functools.lru_cache(maxsize=None)
def _synthesis_consts():
    """(Re and Im of the modulation [128, 64], the windowed taps' past
    slot, v row and weight, each [10, 64])."""
    c = prototype()
    n = np.arange(128, dtype=np.float64)
    k = np.arange(SYN_BANDS, dtype=np.float64)
    ang = np.pi / 128.0 * (k[None, :] + 0.5) * (2.0 * n[:, None] + 257.0)
    m = np.exp(1j * ang) / 64.0                 # [128, 64]
    gsel = np.zeros(SYN_TAPS, np.int64)
    for i in range(5):
        gsel[128 * i:128 * i + 64] = 256 * i + np.arange(64)
        gsel[128 * i + 64:128 * i + 128] = 256 * i + 192 + np.arange(64)
    q = gsel.reshape(10, 64)
    return m.real, m.imag, q // 128, q % 128, c.reshape(10, 64)
