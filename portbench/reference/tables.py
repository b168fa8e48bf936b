"""Static tables for AAC-LC decoding, generated from closed forms and spec
data: either derived from a closed-form expression, or a constant table
mandated by ISO/IEC 14496-3 (sample rates, scalefactor-band offsets, TNS
coefficient and band tables).

Correspondence with the JavaScript decoder the port was modelled on:
  - SWB offset tables            tables.js:34-155
  - SWB window counts            tables.js:157-163
  - SCALEFACTOR_TABLE 2^((i-200)/4)   tables.js:168-176
  - IQ = |q|^(4/3)               tables.js:182-191 (computed directly; that
                                 decoder's 8191-entry table NaNs on escape
                                 values >= 8191)
  - SAMPLE_RATES                 tables.js:193-196
  - sine / KBD windows           filter_bank.js:46-86
  - TNS coef tables & max bands  tns.js:50-66
"""
from __future__ import annotations

import functools

import numpy as np

# --------------------------------------------------------------------------
# Sample rates (ISO/IEC 14496-3 samplingFrequencyIndex)
# --------------------------------------------------------------------------
SAMPLE_RATES = np.array(
    [96000, 88200, 64000, 48000, 44100, 32000,
     24000, 22050, 16000, 12000, 11025, 8000, 7350], dtype=np.int32)

# --------------------------------------------------------------------------
# Scalefactor-band (SWB) offsets per sampling-frequency index.
# ISO/IEC 14496-3 tables 4.110-4.128; numerically identical to the
# reference's tables.js:34-155 by necessity (spec constants).
# --------------------------------------------------------------------------
_SWB_1024_96 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 64,
                72, 80, 88, 96, 108, 120, 132, 144, 156, 172, 188, 212, 240,
                276, 320, 384, 448, 512, 576, 640, 704, 768, 832, 896, 960,
                1024]
_SWB_128_96 = [0, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 92, 128]
_SWB_1024_64 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 64,
                72, 80, 88, 100, 112, 124, 140, 156, 172, 192, 216, 240, 268,
                304, 344, 384, 424, 464, 504, 544, 584, 624, 664, 704, 744,
                784, 824, 864, 904, 944, 984, 1024]
_SWB_128_64 = [0, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 92, 128]
_SWB_1024_48 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64, 72, 80,
                88, 96, 108, 120, 132, 144, 160, 176, 196, 216, 240, 264,
                292, 320, 352, 384, 416, 448, 480, 512, 544, 576, 608, 640,
                672, 704, 736, 768, 800, 832, 864, 896, 928, 1024]
_SWB_128_48 = [0, 4, 8, 12, 16, 20, 28, 36, 44, 56, 68, 80, 96, 112, 128]
_SWB_1024_32 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64, 72, 80,
                88, 96, 108, 120, 132, 144, 160, 176, 196, 216, 240, 264,
                292, 320, 352, 384, 416, 448, 480, 512, 544, 576, 608, 640,
                672, 704, 736, 768, 800, 832, 864, 896, 928, 960, 992, 1024]
_SWB_1024_24 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 52, 60, 68, 76,
                84, 92, 100, 108, 116, 124, 136, 148, 160, 172, 188, 204,
                220, 240, 260, 284, 308, 336, 364, 396, 432, 468, 508, 552,
                600, 652, 704, 768, 832, 896, 960, 1024]
_SWB_128_24 = [0, 4, 8, 12, 16, 20, 24, 28, 36, 44, 52, 64, 76, 92, 108, 128]
_SWB_1024_16 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 100, 112, 124,
                136, 148, 160, 172, 184, 196, 212, 228, 244, 260, 280, 300,
                320, 344, 368, 396, 424, 456, 492, 532, 572, 616, 664, 716,
                772, 832, 896, 960, 1024]
_SWB_128_16 = [0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 60, 72, 88, 108, 128]
_SWB_1024_8 = [0, 12, 24, 36, 48, 60, 72, 84, 96, 108, 120, 132, 144, 156,
               172, 188, 204, 220, 236, 252, 268, 288, 308, 328, 348, 372,
               396, 420, 448, 476, 508, 544, 580, 620, 664, 712, 764, 820,
               880, 944, 1024]
_SWB_128_8 = [0, 4, 8, 12, 16, 20, 24, 28, 36, 44, 52, 60, 72, 88, 108, 128]

_A = functools.partial(np.array, dtype=np.int32)

# Indexed by samplingFrequencyIndex 0..12.  Index 12 (7350 Hz) uses the
# 8000 Hz tables per ISO/IEC 14496-3 (the reference defines only 12 entries,
# tables.js:127-155, and crashes on a legal 7350 Hz stream).
SWB_OFFSET_1024 = [
    _A(_SWB_1024_96), _A(_SWB_1024_96), _A(_SWB_1024_64), _A(_SWB_1024_48),
    _A(_SWB_1024_48), _A(_SWB_1024_32), _A(_SWB_1024_24), _A(_SWB_1024_24),
    _A(_SWB_1024_16), _A(_SWB_1024_16), _A(_SWB_1024_16), _A(_SWB_1024_8),
    _A(_SWB_1024_8),
]

SWB_OFFSET_128 = [
    _A(_SWB_128_96), _A(_SWB_128_96), _A(_SWB_128_64), _A(_SWB_128_48),
    _A(_SWB_128_48), _A(_SWB_128_48), _A(_SWB_128_24), _A(_SWB_128_24),
    _A(_SWB_128_16), _A(_SWB_128_16), _A(_SWB_128_16), _A(_SWB_128_8),
    _A(_SWB_128_8),
]

SWB_SHORT_WINDOW_COUNT = np.array(
    [12, 12, 12, 14, 14, 14, 15, 15, 15, 15, 15, 15, 15], dtype=np.int32)
SWB_LONG_WINDOW_COUNT = np.array(
    [41, 41, 47, 49, 49, 51, 47, 47, 43, 43, 43, 40, 40], dtype=np.int32)


# --------------------------------------------------------------------------
# TNS (ISO/IEC 14496-3 §4.6.9)
# --------------------------------------------------------------------------
TNS_MAX_ORDER = 20
TNS_MAX_BANDS_1024 = np.array(
    [31, 31, 34, 40, 42, 51, 46, 46, 42, 42, 42, 39, 39], dtype=np.int32)
TNS_MAX_BANDS_128 = np.array(
    [9, 9, 10, 14, 14, 14, 14, 14, 14, 14, 14, 14, 14], dtype=np.int32)


def _tns_coef_table(coef_res: int, coef_compress: int) -> np.ndarray:
    """Quantized TNS reflection-coefficient tables (ISO/IEC 14496-3
    §4.6.9.3 inverse quantization of transmitted codes).  Closed form,
    verified numerically against tns.js:50-63 to float32 precision:

      n = 2^(coef_res+3);  iqfac = (n/2 - 0.5)/(pi/2);  iqfac_m = (n/2 + 0.5)/(pi/2)
      full[i] = -sin(i / iqfac)        for i in [0, n/2)
      full[i] =  sin((n-i) / iqfac_m)  for i in [n/2, n)

    coef_compress=1 keeps the inner half of codes: full[0:m/2] ++ full[3m/2:2m]
    where m = n/2.  Indexed by the raw transmitted code (coefLen bits).
    """
    n = 1 << (coef_res + 3)
    iqfac = (n / 2 - 0.5) / (np.pi / 2.0)
    iqfac_m = (n / 2 + 0.5) / (np.pi / 2.0)
    full = np.zeros(n, dtype=np.float64)
    for i in range(n):
        if i < n // 2:
            full[i] = -np.sin(i / iqfac)
        else:
            full[i] = np.sin((n - i) / iqfac_m)
    if coef_compress:
        m = n // 2
        return np.concatenate([full[: m // 2], full[m + m // 2:]]).astype(np.float32)
    return full.astype(np.float32)


# TNS_TABLES[2*coef_compress + coef_res], matching tns.js:63 layout.
TNS_TABLES = [
    _tns_coef_table(0, 0),  # TNS_COEF_0_3
    _tns_coef_table(1, 0),  # TNS_COEF_0_4
    _tns_coef_table(0, 1),  # TNS_COEF_1_3
    _tns_coef_table(1, 1),  # TNS_COEF_1_4
]

# --------------------------------------------------------------------------
# Scalefactor gain and inverse quantization (closed forms)
# --------------------------------------------------------------------------
SF_OFFSET = 200
SF_DELTA = 60


def scalefactor_gain(sf_index: np.ndarray | int) -> np.ndarray:
    """2^((i - 200)/4) — tables.js:168-176 evaluated directly."""
    return np.power(2.0, (np.asarray(sf_index, dtype=np.float64) - SF_OFFSET) / 4.0)


# --------------------------------------------------------------------------
# Windows (closed forms from filter_bank.js:46-86)
# --------------------------------------------------------------------------
def sine_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin((i + 0.5) * (np.pi / (2.0 * n)))


def kbd_window(alpha: float, n: int) -> np.ndarray:
    """Kaiser-Bessel-derived window via the same 50-term Bessel series the
    reference uses (filter_bank.js:54-79), evaluated in float64."""
    pin = np.pi / n
    alpha2 = (alpha * pin) ** 2
    f = np.zeros(n, dtype=np.float64)
    acc = 0.0
    for k in range(n):
        tmp = k * (n - k) * alpha2
        bessel = 1.0
        for j in range(50, 0, -1):
            bessel = bessel * tmp / (j * j) + 1.0
        acc += bessel
        f[k] = acc
    return np.sqrt(f / (acc + 1.0))


@functools.lru_cache(maxsize=None)
def long_window(shape: int, n: int = 1024) -> np.ndarray:
    """shape 0 = sine, 1 = KBD(alpha=4)."""
    return sine_window(n) if shape == 0 else kbd_window(4.0, n)


@functools.lru_cache(maxsize=None)
def short_window(shape: int, n: int = 128) -> np.ndarray:
    """shape 0 = sine, 1 = KBD(alpha=6)."""
    return sine_window(n) if shape == 0 else kbd_window(6.0, n)


# --------------------------------------------------------------------------
# IMDCT (ISO/IEC 14496-3 §4.6.11.2), by one DCT-IV:
#
#   x[n] = (2/N) * sum_k X[k] cos(2*pi/N * (n + 0.5 + N/4) * (k + 0.5))
#
# with u = t + h/2 the IMDCT phase equals the DCT-IV phase at index u, and
# indices past h fold back with a sign flip.
# --------------------------------------------------------------------------
def imdct_via_dct4(X: np.ndarray) -> np.ndarray:
    """[..., h] spectra -> [..., 2h] time."""
    from scipy.fft import dct
    h = X.shape[-1]
    D = dct(X, type=4, axis=-1) / (2.0 * h)
    out = np.empty(X.shape[:-1] + (2 * h,), np.float64)
    out[..., : h // 2] = D[..., h // 2:]
    out[..., h // 2: 3 * h // 2] = -D[..., ::-1]
    out[..., 3 * h // 2:] = -D[..., : h // 2]
    return out
