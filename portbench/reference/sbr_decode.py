"""SBR reconstruction (numpy reference path): QMF analysis of the core
signal, high-frequency generation (patching + inverse filtering),
envelope adjustment, and QMF synthesis to the 2x output rate
(ISO/IEC 14496-3 §4.6.18.5-4.6.18.7).

This is the correctness-first implementation used by the streaming
decoder; the batched TPU pipeline reuses aacjax.kernels.qmf for the
filterbanks.  Validated against libavcodec decoding the same streams
(tests/test_sbr.py) — the reference has no SBR at all.

Timeline bookkeeping: one core frame contributes 32 QMF slots.  The
X_low buffer spans 40 slots (8 carried), HF generation covers the
current 32, and envelope borders t in [0,16] map to slot 2t of the
current frame.  Envelope overhang past the frame (VAR classes) is
processed when those slots arrive (borders clamp to the frame and the
trailing envelope's parameters carry into the next frame's leading
slots via the saved gain state).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.reference import sbr as S
from portbench.reference import qmf

RATE = 2           # QMF slots per envelope time unit
SLOTS = 32         # QMF slots per core frame
HIST = 8           # carried X_low slots
# Envelope time 0 sits 6 slots before the nominal frame start (the spec's
# envelope-adjustment offset): with the 8-slot X_low history, envelope
# time t maps to buffer slot ADJ + 2t, and the frame's output window is
# buffer slots [ADJ, ADJ+32) — verified against libavcodec, whose output
# aligns exactly under this timing (tests/test_sbr.py).
ADJ = 2

_BW_TAB = np.array([0.0, 0.75, 0.9, 0.98])
_EPS = np.float32(1e-12)
_EPS0 = 1e-12


@dataclass
class SBRChannelProc:
    """Per-channel persistent DSP state."""
    x_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(qmf.ANA_HIST, np.float64))
    v_hist: np.ndarray = field(
        default_factory=lambda: np.zeros((qmf.SYN_HIST, 128), np.float64))
    xlow_hist: np.ndarray = field(
        default_factory=lambda: np.zeros((HIST, 32), np.complex128))
    bw: np.ndarray = field(default_factory=lambda: np.zeros(5))
    invf_prev: np.ndarray | None = None
    index_noise: int = 0
    index_sine: int = 0
    la_prev: int = -1
    s_index_prev: np.ndarray | None = None   # sinusoid persistence [m]
    # VAR-class envelope overhang: adjusted HF slots past the frame end
    # (buffer slots [34, 40)) carried into the next frame's X, plus the
    # previous frame's final envelope border (FFmpeg's Y double-buffer +
    # t_env_num_env_old)
    y_tail: np.ndarray = field(
        default_factory=lambda: np.zeros((6, 64), np.complex128))
    t_env_last: int = 0
    # the arithmetic's precision (precision.py): the QMF planes, the
    # generated and the adjusted high band and the output pass through it
    rnd: object = None

    def r(self, x):
        return x if self.rnd is None else self.rnd(x)


def _qmf_analysis_np(x: np.ndarray, hist: np.ndarray):
    """Numpy mirror of kernels.qmf.analysis for one channel (float64)."""
    win_ds, mr, mi = qmf._analysis_consts()
    win = win_ds
    m = mr + 1j * mi                              # [64, 32]
    buf = np.concatenate([hist, x])
    S_ = len(x) // 32
    X = np.zeros((S_, 32), np.complex128)
    for line in range(S_):
        seg = buf[32 * line:32 * line + 320][::-1]
        u = (seg * win).reshape(5, 64).sum(axis=0)
        X[line] = u @ m
    return X, buf[-qmf.ANA_HIST:]


def _qmf_synthesis_np(X: np.ndarray, vhist: np.ndarray):
    """Numpy mirror of kernels.qmf.synthesis for one channel."""
    mr, mi, taps_j, taps_r, taps_w = qmf._synthesis_consts()
    m = mr + 1j * mi                              # [128, 64]
    S_, _ = X.shape
    v = np.real(X @ m.T)                          # [S, 128]
    vall = np.concatenate([vhist[::-1], v], axis=0)
    out = np.zeros((S_, 64))
    for s_ in range(S_):
        contrib = vall[s_ + 9 - taps_j, taps_r]   # [10, 64]
        out[s_] = (contrib * taps_w).sum(axis=0)
    return out.reshape(-1), vall[-1:-10:-1]


def _chirp(proc: SBRChannelProc, invf: np.ndarray) -> np.ndarray:
    """Chirp-factor smoothing (§4.6.18.5): a transition between NONE and
    LOW inverse filtering targets 0.6 instead of the table value."""
    nq = len(invf)
    if proc.invf_prev is None or len(proc.invf_prev) != nq:
        proc.invf_prev = np.zeros(nq, np.int64)
    new_bw = np.where(invf + proc.invf_prev == 1, 0.6, _BW_TAB[invf])
    old = proc.bw[:nq]
    bw = np.where(new_bw < old, 0.75 * new_bw + 0.25 * old,
                  0.90625 * new_bw + 0.09375 * old)
    bw = np.where(bw < 0.015625, 0.0, bw)
    proc.bw[:nq] = bw
    proc.invf_prev = invf.copy()
    return bw


def _lpc(x: np.ndarray) -> tuple[complex, complex]:
    """2nd-order covariance LPC over a 40-slot subband line (§4.6.18.6.2).

    Whitening filter x[n] + a0 x[n-1] + a1 x[n-2]; normal equations with
    phi(i,j) = sum_n x[n-i] conj(x[n-j]) over n in [2, 40):
        a1 = (phi01 phi12 - phi02 phi11) / (phi11 phi22 - |phi12|^2/rel)
        a0 = -(phi01 + a1 conj(phi12)) / phi11
    (rel = 1.000001, the spec's relaxation)."""
    def c(i, j):
        return np.sum(x[2 - i:len(x) - i] * np.conj(x[2 - j:len(x) - j]))
    c01 = c(0, 1)
    c02 = c(0, 2)
    c11 = np.real(c(1, 1))
    c12 = c(1, 2)
    c22 = np.real(c(2, 2))
    d = c11 * c22 - (abs(c12) ** 2) / 1.000001
    a1 = (c01 * c12 - c02 * c11) / d if d else 0.0
    a0 = -(c01 + a1 * np.conj(c12)) / c11 if c11 else 0.0
    if abs(a0) ** 2 >= 16.0 or abs(a1) ** 2 >= 16.0:
        return 0.0, 0.0
    return complex(a0), complex(a1)


def _hf_gen(xlow: np.ndarray, t: S.SBRTables, bw: np.ndarray) -> np.ndarray:
    """X_high [40, 64] from X_low [40, 32] via patches + inverse filtering."""
    xhigh = np.zeros((HIST + SLOTS, 64), np.complex128)
    # noise band of each HF subband k
    f_noise = np.asarray(t.f_noise)
    g = 0
    for i in range(t.num_patches):
        for x in range(t.patch_num_subbands[i]):
            k = t.kx + g
            p = t.patch_start_subband[i] + x
            nb = int(np.searchsorted(f_noise, k, side="right") - 1)
            nb = min(max(nb, 0), len(bw) - 1)
            b = bw[nb]
            src = xlow[:, p]
            a0, a1 = _lpc(src)
            line = src.copy()
            if b > 0.0:
                line[ADJ:] = (src[ADJ:] + b * a0 * src[ADJ - 1:-1]
                              + (b * b) * a1 * src[ADJ - 2:-2])
            xhigh[:, k] = line
            g += 1
    return xhigh


def _map_bands(values: np.ndarray, table: np.ndarray, kx: int,
               m: int) -> np.ndarray:
    """Spread per-band values to per-subband [m] over `table` borders."""
    out = np.zeros(m)
    for b in range(len(table) - 1):
        out[int(table[b]) - kx: int(table[b + 1]) - kx] = values[b]
    return out


def process_channel(proc: SBRChannelProc, core_pcm: np.ndarray,
                    frame: S.SBRFrame, ch: int,
                    e_orig_q: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Apply SBR to one channel's core frame; returns 2x-rate PCM
    [2 * len(core_pcm)]."""
    t = frame.tables
    h = frame.header
    cd = frame.channels[ch]
    g = cd.grid
    e_orig, q_orig = e_orig_q

    # --- analysis of the core signal ------------------------------------
    # The envelope/noise dequant offsets (+7/+6, FFmpeg-identical) assume
    # QMF values computed on full-scale (32768) PCM; scale in and out so
    # E_curr lands in the same units as E_orig and the "+1" guards in the
    # gain formulas carry the same (negligible) weight.
    X32, proc.x_hist = _qmf_analysis_np(core_pcm.astype(np.float64) * 32768.0,
                                        proc.x_hist)
    X32 = proc.r(X32)
    xlow = np.concatenate([proc.xlow_hist, X32], axis=0)  # [40, 32]
    proc.xlow_hist = xlow[-HIST:].copy()

    # --- HF generation ----------------------------------------------------
    bw = _chirp(proc, cd.invf_mode)
    xhigh = proc.r(_hf_gen(xlow, t, bw))                 # [40, 64]

    # --- envelope adjustment ---------------------------------------------
    m = t.m
    kx = t.kx
    la = S.l_a(g)
    num_env = g.num_env
    # envelope borders may overhang the frame by up to 3 t-units (VAR
    # classes); the 40-slot buffer holds ADJ + 2*19, and the adjusted
    # overhang slots carry into the next frame's X via y_tail
    t_env = np.minimum(g.t_env[: num_env + 1], 19)
    t_q = np.minimum(g.t_q[: g.num_noise + 1], 19)

    s_prev = proc.s_index_prev
    if s_prev is None or len(s_prev) != m:
        s_prev = np.zeros(m, bool)
    # sinusoid index mapping: a harmonic starts at/after the transient
    # envelope or persists from the previous frame
    f_high = np.asarray(t.f_high)
    s_index = np.zeros((num_env, m), bool)
    add = cd.add_harmonic
    for e in range(num_env):
        for b in range(t.n_high):
            if not add[b]:
                continue
            mm = (int(f_high[b]) + int(f_high[b + 1])) // 2 - kx
            if e >= la or s_prev[mm]:
                s_index[e, mm] = True
    proc.s_index_prev = s_index[-1].copy() if num_env else s_prev

    y = np.zeros((HIST + SLOTS, 64), np.complex128)
    noise_tab = S._consts()["noise_table"]
    noise_c = noise_tab[:, 0] + 1j * noise_tab[:, 1]

    prev_la = proc.la_prev
    for e in range(num_env):
        res = int(g.freq_res[e + 1])
        ftab = t.freq_table(res)
        e_mapped = _map_bands(e_orig[e], ftab, kx, m)
        nenv = 0
        if g.num_noise > 1 and g.t_env[e] >= t_q[1]:
            nenv = 1
        q_mapped = _map_bands(q_orig[nenv], np.asarray(t.f_noise), kx, m)
        # s_mapped: sinusoid anywhere in the (freq-res) band containing m
        s_mapped = np.zeros(m, bool)
        for b in range(len(ftab) - 1):
            lo, hi = int(ftab[b]) - kx, int(ftab[b + 1]) - kx
            if s_index[e, lo:hi].any():
                s_mapped[lo:hi] = True

        lo_slot = ADJ + RATE * int(t_env[e])
        hi_slot = ADJ + RATE * int(t_env[e + 1])
        if hi_slot <= lo_slot:
            continue
        seg = xhigh[lo_slot:hi_slot, kx: kx + m]
        if h.interpol_freq:
            e_curr = np.mean(np.abs(seg) ** 2, axis=0)
        else:
            e_curr = np.zeros(m)
            for b in range(len(ftab) - 1):
                lo, hi = int(ftab[b]) - kx, int(ftab[b + 1]) - kx
                e_curr[lo:hi] = np.mean(np.abs(seg[:, lo:hi]) ** 2)

        delta = 0 if (e == la or e == prev_la) else 1
        q_m = np.sqrt(e_mapped * q_mapped / (1.0 + q_mapped))
        s_m = np.where(s_index[e],
                       np.sqrt(e_mapped / (1.0 + q_mapped)), 0.0)
        gain = np.where(
            s_mapped,
            np.sqrt(e_mapped * q_mapped
                    / ((1.0 + e_curr) * (1.0 + q_mapped))),
            np.sqrt(e_mapped / ((1.0 + e_curr)
                                * (1.0 + q_mapped * delta)))) + _EPS0

        # limiter + boost per limiter band
        limgain = float(S._consts()["limgain"][h.limiter_gains])
        f_lim = np.asarray(t.f_lim)
        for b in range(t.n_lim):
            lo, hi = int(f_lim[b]) - kx, int(f_lim[b + 1]) - kx
            if hi <= lo:
                continue
            sum_o = float(np.sum(e_mapped[lo:hi]))
            sum_c = float(np.sum(e_curr[lo:hi]))
            gmax = min(limgain * np.sqrt((_EPS0 + sum_o) / (_EPS0 + sum_c)),
                       1e5)
            q_m[lo:hi] = np.minimum(q_m[lo:hi],
                                    q_m[lo:hi] * gmax / gain[lo:hi])
            gain[lo:hi] = np.minimum(gain[lo:hi], gmax)
            sum_b = float(np.sum(
                e_curr[lo:hi] * gain[lo:hi] ** 2
                + s_m[lo:hi] ** 2
                + (delta * (s_m[lo:hi] == 0.0)) * q_m[lo:hi] ** 2))
            boost = min(np.sqrt((_EPS0 + sum_o) / (_EPS0 + sum_b)),
                        1.584893192)
            gain[lo:hi] *= boost
            q_m[lo:hi] *= boost
            s_m[lo:hi] *= boost

        # assembly over the envelope's slots
        transient = (e == la or e == prev_la)
        for i in range(lo_slot, hi_slot):
            y[i, kx: kx + m] = xhigh[i, kx: kx + m] * gain
            if not transient:
                idx = (proc.index_noise + np.arange(1, m + 1)) & 0x1FF
                noise = np.where(s_m == 0.0, q_m * noise_c[idx], 0.0)
                y[i, kx: kx + m] += noise
            # sinusoids
            if s_m.any():
                phase = proc.index_sine & 3
                signs = np.where(((np.arange(m) + kx) & 1) == 1, -1.0, 1.0)
                if phase == 0:
                    y[i, kx: kx + m] += s_m
                elif phase == 1:
                    y[i, kx: kx + m] += 1j * s_m * signs
                elif phase == 2:
                    y[i, kx: kx + m] -= s_m
                else:
                    y[i, kx: kx + m] -= 1j * s_m * signs
            proc.index_noise = (proc.index_noise + m) & 0x1FF
            proc.index_sine = (proc.index_sine + 1) & 3
    proc.la_prev = 0 if la == num_env else -1
    y = proc.r(y)

    # --- final X ------------------------------------------------------------
    # output window = buffer slots [ADJ, ADJ+32); six further slots of
    # lookahead (low bands only — FFmpeg's sbr_x_gen leaves the HF of the
    # lookahead zero) feed the Parametric Stereo hybrid filterbank.  The
    # first i_temp slots take the PREVIOUS frame's adjusted overhang
    # (this frame's first envelope starts at the overhang border).
    i_temp = max(0, RATE * proc.t_env_last - SLOTS)
    proc.t_env_last = int(t_env[num_env]) if num_env else 0
    X = np.zeros((SLOTS + 6, 64), np.complex128)
    X[:, :kx] = xlow[ADJ: ADJ + SLOTS + 6, :kx]
    X[:SLOTS, kx: kx + m] = y[ADJ: ADJ + SLOTS, kx: kx + m]
    if i_temp:
        X[:i_temp, kx: kx + m] = proc.y_tail[:i_temp, kx: kx + m]
    proc.y_tail = y[ADJ + SLOTS: ADJ + SLOTS + 6].copy()
    pcm, proc.v_hist = _qmf_synthesis_np(X[:SLOTS], proc.v_hist)
    return proc.r(pcm) * (1.0 / 32768.0)
