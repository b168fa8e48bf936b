"""Static tables for AAC-LC decoding, generated from closed forms and spec data.

Everything here is either (a) derived from a closed-form expression verified
against the reference implementation (see SURVEY.md §1 L0), or (b) a constant
table mandated by ISO/IEC 14496-3 (sample rates, scalefactor-band offsets,
TNS coefficient/band tables).  Nothing is a runtime lookup on the hot path:
the device-side kernels consume *matrices* built from these tables once per
process (see aacjax.kernels.filterbank).

Reference behavior being reproduced (citations into /root/reference/):
  - SWB offset tables            tables.js:34-155
  - SWB window counts            tables.js:157-163
  - SCALEFACTOR_TABLE 2^((i-200)/4)   tables.js:168-176
  - IQ = |q|^(4/3)               tables.js:182-191 (we compute directly; the
                                 reference's 8191-entry table silently NaNs on
                                 escape values >= 8191 - SURVEY.md §7)
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
# 960-sample frame mode (frameLengthFlag=1) SWB tables — spec constants
# (ISO/IEC 14496-3) with no closed form and absent from the reference
# (decoder.js:83-84 rejects the mode); extracted by symbol from the system
# libavcodec and cross-validated by extracting the 1024/128 tables the
# same way and matching them bit-for-bit against the independently
# embedded tables above (tools/extract_ffmpeg_tables.py,
# tests/test_tables.py).
# --------------------------------------------------------------------------
def _load_960():
    import pathlib
    d = np.load(pathlib.Path(__file__).parent / "host"
                / "aac_960_tables.npz")
    def per_index(offs, counts):
        return [np.ascontiguousarray(offs[i][: int(counts[i]) + 1])
                for i in range(13)]
    return (per_index(d["swb_offset_960"], d["num_swb_960"]),
            per_index(d["swb_offset_120"], d["num_swb_120"]),
            d["num_swb_960"].astype(np.int32),
            d["num_swb_120"].astype(np.int32))


SWB_OFFSET_960, SWB_OFFSET_120, SWB_LONG_WINDOW_COUNT_960, \
    SWB_SHORT_WINDOW_COUNT_120 = _load_960()


def _load_pred_sfb_max():
    import pathlib
    d = np.load(pathlib.Path(__file__).parent / "host"
                / "aac_960_tables.npz")
    return d["pred_sfb_max"].astype(np.int32)


def _load_ld():
    import pathlib
    d = np.load(pathlib.Path(__file__).parent / "host"
                / "aac_960_tables.npz")
    def per_index(offs, counts):
        return [np.ascontiguousarray(offs[i][: max(int(counts[i]), 0) + 1])
                for i in range(13)]
    return (per_index(d["swb_offset_512"], d["num_swb_512"]),
            per_index(d["swb_offset_480"], d["num_swb_480"]),
            d["num_swb_512"].astype(np.int32),
            d["num_swb_480"].astype(np.int32),
            d["tns_max_bands_512"].astype(np.int32),
            d["tns_max_bands_480"].astype(np.int32))


# AAC-LD (AOT 23) 512/480-sample frame tables — extracted like the 960
# tables above (modes undefined at a sampling rate have zero band counts)
SWB_OFFSET_512, SWB_OFFSET_480, NUM_SWB_512, NUM_SWB_480, \
    TNS_MAX_BANDS_512, TNS_MAX_BANDS_480 = _load_ld()


def eld_window(frame_len: int) -> np.ndarray:
    """AAC-ELD low-delay synthesis window (ISO/IEC 14496-3 §4.6.20.2
    class constants, 4N - N/4 taps; extracted like the tables above).
    Only the first 3N taps shape decoder output — validated by impulse-
    response identification against libavcodec (tests/test_eld.py)."""
    import pathlib
    d = np.load(pathlib.Path(__file__).parent / "host"
                / "aac_960_tables.npz")
    return d[f"eld_window_{frame_len}"].astype(np.float64)


def eld_synthesis_matrix(frame_len: int = 512) -> np.ndarray:
    """[N, 4N] low-delay synthesis operator: a frame's N spectral
    coefficients map to 4N output samples (the last N only partially
    covered — the window has 4N - N/4 taps), accumulated at N-sample
    stride across 4 frames:

        M[n, k] = -(1/N) * w_eld[n] * cos(pi/N * (n - (N/4 - 1/2)) * (k + 1/2))

    Identified from libavcodec's ELD decode by unit-impulse probing
    (residual ~1e-13 relative on every segment, the float32 window's own
    noise floor) and matching the per-row gains bit-for-bit to
    ff_aac_eld_window_*.  On TPU this makes the whole ELD filterbank one
    MXU matmul + a 4-segment shifted overlap-add (3N carry per
    channel)."""
    N = frame_len
    w = np.zeros(4 * N)
    w[: len(eld_window(N))] = eld_window(N)
    n = np.arange(4 * N, dtype=np.float64)
    k = np.arange(N, dtype=np.float64)
    C = np.cos(np.pi / N * np.outer(n - (N / 4.0 - 0.5), k + 0.5))
    return np.ascontiguousarray((-(1.0 / N) * w[:, None] * C).T)


# Main-profile backward prediction: highest predicted sfb per sampling
# index (ISO/IEC 14496-3 Table 4.128; extracted like the tables above)
PRED_SFB_MAX = _load_pred_sfb_max()

# AAC-LTP (AOT 4) prediction-coefficient codebook (ISO/IEC 14496-3
# Table 4.69; float32 values extracted by symbol from libavcodec's
# ltp_coef, the conformance oracle for tests/test_ltp.py)
LTP_COEF = np.array([0.570828974246979, 0.696615993976593,
                     0.813004016876221, 0.911303997039795,
                     0.984899997711182, 1.067893981933594,
                     1.194601058959961, 1.369532942771912], np.float64)

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


def inverse_quantize(q: np.ndarray) -> np.ndarray:
    """sign(q) * |q|^(4/3), computed directly (no 8191-entry clamp —
    escape-coded values can exceed the reference table; SURVEY.md §7)."""
    q = np.asarray(q, dtype=np.float64)
    return np.sign(q) * np.power(np.abs(q), 4.0 / 3.0)


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
    """shape 0 = sine, 1 = KBD(alpha=4); length 1024 (960 in
    frameLengthFlag mode — same alpha, per ISO/IEC 14496-3 §4.6.11.3).

    Lengths 512/480 are AAC-LD frames, where shape selects the LD pair
    instead: 0 = sine, 1 = the LD low-overlap window (ISO/IEC 14496-3
    §4.6.20.2; libavcodec imdct_and_windowing_ld) — zeros for the first
    3n/8 samples, an n/4-sample sine rise, then ones.  Dispatching on n
    here means every window consumer (device tables, model decoder) gets
    the LD shapes without plumbing a separate flag."""
    if n in (512, 480):
        if shape == 0:
            return sine_window(n)
        q = n // 4
        z = (n - q) // 2
        return np.concatenate([np.zeros(z), sine_window(q), np.ones(z)])
    return sine_window(n) if shape == 0 else kbd_window(4.0, n)


@functools.lru_cache(maxsize=None)
def short_window(shape: int, n: int = 128) -> np.ndarray:
    """shape 0 = sine, 1 = KBD(alpha=6); length 128 (120 in 960 mode)."""
    return sine_window(n) if shape == 0 else kbd_window(6.0, n)


# --------------------------------------------------------------------------
# IMDCT synthesis matrices.
#
# The reference computes the N-point IMDCT via an N/4 complex FFT with
# pre/post twiddles (mdct.js:62-115, fft.js).  On TPU the right shape for
# this computation is a dense matmul on the MXU: a [N/2, N] matrix applied
# to a batch of spectra.  The closed form (ISO/IEC 14496-3 §4.6.11.2, and
# equivalent to the reference's twiddle pipeline, verified in tests):
#
#   x[n] = (2/N) * sum_k X[k] cos(2*pi/N * (n + 0.5 + N/4) * (k + 0.5))
#
# The reference's MDCT tables bake in sqrt(2/N) twice => overall 2/N scale.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def imdct_matrix(n: int) -> np.ndarray:
    """[n//2, n] float64 matrix M with x = X @ M."""
    half = n // 2
    k = np.arange(half, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    return (2.0 / n) * np.cos(
        2.0 * np.pi / n * (t + 0.5 + n / 4.0) * (k + 0.5))


# O(n log n) host-side equivalents of the imdct_matrix products, for the
# fp64 reference/LTP path (the device keeps the matmul form — that IS the
# right TPU mapping, SURVEY.md §2.9).  Both reduce to one DCT-IV via the
# cos(pi(2m+1)(2k+1)/4h) fold: with u = t + h/2, the IMDCT phase
# (t+0.5+N/4)(k+0.5)*2pi/N equals the DCT-IV phase at index u, and indices
# past h fold back with a sign flip.  Verified against imdct_matrix for
# every frame length in tests/test_tables.py.

def imdct_via_dct4(X: np.ndarray, workers: int | None = None) -> np.ndarray:
    """[..., h] spectra -> [..., 2h] time; equals X @ imdct_matrix(2h).
    workers=-1 parallelizes across leading rows (bit-identical: pocketfft
    splits rows, never a single transform)."""
    from scipy.fft import dct
    h = X.shape[-1]
    D = dct(X, type=4, axis=-1, workers=workers) / (2.0 * h)
    out = np.empty(X.shape[:-1] + (2 * h,), np.float64)
    out[..., : h // 2] = D[..., h // 2:]
    out[..., h // 2: 3 * h // 2] = -D[..., ::-1]
    out[..., 3 * h // 2:] = -D[..., : h // 2]
    return out


def mdct_via_dct4(x: np.ndarray, workers: int | None = None) -> np.ndarray:
    """[..., 2h] time -> [..., h] spectra; equals
    x @ (imdct_matrix(2h).T * 2h) — the exact PR dual used by LTP.
    workers as in imdct_via_dct4."""
    from scipy.fft import dct
    h = x.shape[-1] // 2
    f = np.zeros(x.shape[:-1] + (h,), np.float64)
    f[..., h // 2:] += x[..., : h // 2]
    f -= x[..., h // 2: 3 * h // 2][..., ::-1]
    f[..., : h // 2] -= x[..., 3 * h // 2:]
    return dct(f, type=4, axis=-1, workers=workers)
