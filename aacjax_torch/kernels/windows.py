"""Window/IMDCT constant tables for the device filterbank.

All tables are generated from the closed forms in aacjax.tables (which
reproduce the reference's filter_bank.js:46-86 window generation and the
mdct.js twiddle pipeline, verified in tests/test_tables.py) and are laid
out for branch-free per-frame selection on device:

  F_TABLE[seq*2 + prev_shape]  — first-half window applied to imdct[:L]
  S_TABLE[seq*2 + cur_shape]   — second-half window applied to imdct[L:]
                                 (this becomes the next frame's overlap)
  RISE/FALL                    — L/8-sample short-window halves for the
                                 EIGHT_SHORT intra-frame overlap-add

The composite LONG_START / LONG_STOP windows (ones/zeros padding around a
short-window transition, filter_bank.js:120-141 and 180-202) are baked into
F/S rows so the device code is a single gather + multiply per half.

Everything is parametrized by the frame length L: 1024 (default) or 960
(frameLengthFlag mode, which the reference rejects — decoder.js:83-84);
the short length is L//8 and the composite padding mid = (L - L//8)//2.
"""
from __future__ import annotations

import functools

import numpy as np

from aacjax_torch import tables

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3

LONG_LEN = 1024
SHORT_LEN = 128
MID = (LONG_LEN - SHORT_LEN) // 2  # 448 (420 in 960 mode)


def mid(long_len: int = LONG_LEN) -> int:
    return (long_len - long_len // 8) // 2


@functools.lru_cache(maxsize=None)
def first_half_windows(long_len: int = LONG_LEN) -> np.ndarray:
    """[8, L] float32: F_TABLE[seq*2 + prev_shape]."""
    short_len = long_len // 8
    m = mid(long_len)
    out = np.zeros((8, long_len), np.float64)
    for prev in (0, 1):
        wl = tables.long_window(prev, long_len)
        ws = tables.short_window(prev, short_len)
        out[ONLY_LONG * 2 + prev] = wl
        out[LONG_START * 2 + prev] = wl
        # EIGHT_SHORT first half is handled by the short path; keep zeros so
        # an accidental selection is loud in tests.
        out[LONG_STOP * 2 + prev] = np.concatenate(
            [np.zeros(m), ws, np.ones(m)])
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def second_half_windows(long_len: int = LONG_LEN) -> np.ndarray:
    """[8, L] float32: S_TABLE[seq*2 + cur_shape]."""
    short_len = long_len // 8
    m = mid(long_len)
    out = np.zeros((8, long_len), np.float64)
    for cur in (0, 1):
        wl = tables.long_window(cur, long_len)
        ws = tables.short_window(cur, short_len)
        out[ONLY_LONG * 2 + cur] = wl[::-1]
        out[LONG_START * 2 + cur] = np.concatenate(
            [np.ones(m), ws[::-1], np.zeros(m)])
        out[LONG_STOP * 2 + cur] = wl[::-1]
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def short_rise(long_len: int = LONG_LEN) -> np.ndarray:
    """[2, L/8] float32: rising short window per shape."""
    short_len = long_len // 8
    return np.stack([tables.short_window(0, short_len),
                     tables.short_window(1, short_len)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def short_fall(long_len: int = LONG_LEN) -> np.ndarray:
    """[2, L/8] float32: falling short window per shape."""
    return short_rise(long_len)[:, ::-1].copy()


@functools.lru_cache(maxsize=None)
def imdct_long_matrix(long_len: int = LONG_LEN) -> np.ndarray:
    """[L, 2L] float32 — IMDCT as a single MXU matmul."""
    return tables.imdct_matrix(2 * long_len).astype(np.float32)


@functools.lru_cache(maxsize=None)
def imdct_short_matrix(long_len: int = LONG_LEN) -> np.ndarray:
    """[L/8, L/4] float32."""
    return tables.imdct_matrix(long_len // 4).astype(np.float32)
