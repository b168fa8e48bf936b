"""Parametric Stereo reconstruction (numpy reference path): hybrid
filterbank analysis/synthesis, transient-aware decorrelation (allpass
cascade), and the IID/ICC stereo mixing with per-envelope interpolation
(ISO/IEC 14496-3 §8.6.4, baseline PS).

Operates in the QMF domain on the mono SBR output (the adjusted X plane
with 6 slots of lookahead, see sbr_decode.process_channel(return_x)) and
emits the left/right QMF planes for two synthesis filterbanks.

Validated against libavcodec decoding the same self-generated HE-AAC v2
streams (tests/test_ps.py).  Hybrid-filter phases and the dequantization
tables come from the libavcodec extraction (ps_tables.npz).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from aacjax_torch.host import ps as P

SLOTS = 32
LOOK = 6                 # lookahead slots feeding the hybrid FIR
AP_LINKS = 3
MAX_DELAY = 14
NR_ALLPASS = (30, 50)    # per is34
SHORT_DELAY_BAND = (42, 62)
NR_BANDS = (71, 91)
NR_PAR_BANDS = (20, 34)  # parameter bands after fine mapping

_A = np.array([0.65143905753106, 0.56471812200776, 0.48954165955695])
_PEAK_DECAY = 0.76592833836465
_TRANSIENT_IMPACT = 1.5
_A_SMOOTH = 0.25
_DECAY_SLOPE = 0.05


def _make_filter(proto: np.ndarray, bands: int) -> np.ndarray:
    """[bands, 7] complex sub-filter bank from a 7-tap prototype
    (FFmpeg make_filters_from_proto)."""
    q = np.arange(bands)[:, None]
    n = np.arange(7)[None, :]
    theta = 2.0 * np.pi * (q + 0.5) * (n - 6) / bands
    return proto[None, :] * (np.cos(theta) - 1j * np.sin(theta))


def _init_tables():
    t = P.tables()
    out = {}
    out["f20_0_8"] = _make_filter(t["g0_q8"].astype(np.float64), 8)
    out["f34_0_12"] = _make_filter(t["g0_q12"].astype(np.float64), 12)
    out["f34_1_8"] = _make_filter(t["g1_q8"].astype(np.float64), 8)
    out["f34_2_4"] = _make_filter(t["g2_q4"].astype(np.float64), 4)
    out["k_to_i_20"] = t["k_to_i_20"].astype(np.int64)
    out["k_to_i_34"] = t["k_to_i_34"].astype(np.int64)
    out["iid_par_dequant"] = t["iid_par_dequant"].astype(np.float64)
    out["acos_icc_invq"] = t["acos_icc_invq"].astype(np.float64)

    # allpass fractional-delay phasors (FFmpeg ps_init): band center
    # frequencies in QMF units; below the f_center tables the centers are
    # fractional (stored x8), above they are k - 0.5-offset integers
    links = t["frac_delay_links"].astype(np.float64)  # [0.43, 0.75, 0.347]
    for is34, (fc_key, div, nap, off) in enumerate(
            (("f_center_20", 8.0, 30, 6.5),
             ("f_center_34", 24.0, 50, 26.5))):
        fc_tab = t[fc_key].astype(np.float64) / div
        phi = np.zeros(nap, np.complex128)
        qf = np.zeros((nap, AP_LINKS), np.complex128)
        for k in range(nap):
            # table entries cover the hybrid sub-bands; direct QMF bands
            # sit at k - off (= QMF band center in band units)
            f_center = fc_tab[k] if k < len(fc_tab) else k - off
            theta = -np.pi * 0.39 * f_center
            phi[k] = np.cos(theta) + 1j * np.sin(theta)
            for m in range(AP_LINKS):
                th = -np.pi * links[m] * f_center
                qf[k, m] = np.cos(th) + 1j * np.sin(th)
        out[f"phi_fract_{is34}"] = phi
        out[f"q_fract_{is34}"] = qf

    # mixing-A gain LUT HA[46][8][4] (FFmpeg ps_tableinit)
    iid_lin = out["iid_par_dequant"]
    alpha = 0.5 * out["acos_icc_invq"]
    ha = np.zeros((46, 8, 4))
    for iid in range(46):
        c = iid_lin[iid]
        c1 = np.sqrt(2.0) / np.sqrt(1.0 + c * c)
        c2 = c * c1
        for icc in range(8):
            a = alpha[icc]
            beta = a * (c1 - c2) / np.sqrt(2.0)
            ha[iid, icc, 0] = c2 * np.cos(beta + a)
            ha[iid, icc, 1] = c1 * np.cos(beta - a)
            ha[iid, icc, 2] = c2 * np.sin(beta + a)
            ha[iid, icc, 3] = c1 * np.sin(beta - a)
    out["HA"] = ha

    # IPD/OPD smoothed-phase LUT [8,8,8] -> normalized complex
    # (FFmpeg ps_tableinit pd_re/im_smooth): 0.25*oldest + 0.5*mid + cur
    cosv = t["ipdopd_cos"].astype(np.float64)
    sinv = t["ipdopd_sin"].astype(np.float64)
    pd0 = (0.25 * (cosv + 1j * sinv))[:, None, None]
    pd1 = (0.5 * (cosv + 1j * sinv))[None, :, None]
    pd2 = (cosv + 1j * sinv)[None, None, :]
    sm = pd0 + pd1 + pd2
    out["pd_smooth"] = (sm / np.abs(sm)).reshape(-1)  # [512]
    return out


_T = None


def _tables():
    global _T
    if _T is None:
        _T = _init_tables()
    return _T


# parameter-band upsampling maps, recovered from the libavcodec binary
# (inlined map_idx_10_to_34 / map_idx_20_to_34 in stereo_processing) and
# verified against its output (tests/test_ps.py)
_MAP_10_TO_34 = np.array(
    [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5,
     6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9])


def _map_20_to_34(par: np.ndarray) -> np.ndarray:
    """20 -> 34 parameter upsample; entries 1 and 4 average their
    neighbours with round-toward-zero integer division."""
    idx = np.array([0, 0, 1, 2, 2, 3, 4, 4, 5, 5, 6, 7, 8, 8, 9, 9,
                    10, 11, 12, 13, 14, 14, 15, 15, 16, 16, 17, 17,
                    18, 18, 18, 18, 19, 19])
    out = par[idx]
    out[1] = int(par[0] + par[1]) // 2 if (par[0] + par[1]) >= 0 else \
        -((-int(par[0] + par[1])) // 2)
    out[4] = int(par[2] + par[3]) // 2 if (par[2] + par[3]) >= 0 else \
        -((-int(par[2] + par[3])) // 2)
    return out


def _map_h_34_to_20(par: np.ndarray) -> np.ndarray:
    """libavcodec map_val_34_to_20: averaging downsample of a per-
    34-parameter-band float track to 20 bands (applied to the persisted
    H matrices on a band-scheme switch)."""
    q = par
    out = np.zeros_like(par)
    out[0] = (2 * q[0] + q[1]) / 3
    out[1] = (q[1] + 2 * q[2]) / 3
    out[2] = (2 * q[3] + q[4]) / 3
    out[3] = (q[4] + 2 * q[5]) / 3
    out[4] = (q[6] + q[7]) / 2
    out[5] = (q[8] + q[9]) / 2
    out[6] = q[10]
    out[7] = q[11]
    out[8] = (q[12] + q[13]) / 2
    out[9] = (q[14] + q[15]) / 2
    out[10] = q[16]
    out[11] = q[17]
    out[12] = q[18]
    out[13] = q[19]
    out[14] = (q[20] + q[21]) / 2
    out[15] = (q[22] + q[23]) / 2
    out[16] = (q[24] + q[25]) / 2
    out[17] = (q[26] + q[27]) / 2
    out[18] = (q[28] + q[29] + q[30] + q[31]) / 4
    out[19] = (q[32] + q[33]) / 2
    return out


def _map_h_20_to_34(par: np.ndarray) -> np.ndarray:
    """libavcodec map_val_20_to_34 (nearest/averaged upsample)."""
    p = par
    out = np.zeros_like(par)
    out[0] = p[0]
    out[1] = (p[0] + p[1]) / 2
    out[2] = p[1]
    out[3] = p[2]
    out[4] = (p[2] + p[3]) / 2
    out[5] = p[3]
    out[6] = p[4]
    out[7] = p[4]
    out[8] = p[5]
    out[9] = p[5]
    out[10] = p[6]
    out[11] = p[7]
    out[12] = p[8]
    out[13] = p[8]
    out[14] = p[9]
    out[15] = p[9]
    out[16] = p[10]
    out[17] = p[11]
    out[18] = p[12]
    out[19] = p[13]
    out[20] = p[14]
    out[21] = p[14]
    out[22] = p[15]
    out[23] = p[15]
    out[24] = p[16]
    out[25] = p[16]
    out[26] = p[17]
    out[27] = p[17]
    out[28] = p[18]
    out[29] = p[18]
    out[30] = p[19]
    out[31] = p[19]
    out[32] = p[19]
    out[33] = p[19]
    return out


@dataclass
class PSProc:
    """Per-stream persistent PS DSP state."""
    in_hist: np.ndarray = field(
        default_factory=lambda: np.zeros((5, LOOK), np.complex128))
    delay: np.ndarray = field(
        default_factory=lambda: np.zeros((91, MAX_DELAY), np.complex128))
    ap_delay: np.ndarray = field(
        default_factory=lambda: np.zeros((50, AP_LINKS, 5), np.complex128))
    peak_decay_nrg: np.ndarray = field(
        default_factory=lambda: np.zeros(34))
    power_smooth: np.ndarray = field(default_factory=lambda: np.zeros(34))
    peak_decay_diff: np.ndarray = field(default_factory=lambda: np.zeros(34))
    h_prev: np.ndarray = field(
        default_factory=lambda: np.zeros((34, 4), np.complex128))
    ps_prev: object = None                            # last PSData
    is34_prev: bool | None = None
    # IPD/OPD 6-bit phase histories per (remapped) parameter band
    ipd_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(34, np.int64))
    opd_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(34, np.int64))
    # Imaginary H components per envelope SLOT (libavcodec H11[1][e+1]
    # etc.): with IPD/OPD active, bands >= the scheme's IPD cut are
    # never rewritten, so their stale per-slot values keep being
    # interpolated — permanently, e.g. after a 34->20 band-scheme
    # switch (slots 1+ are not even remapped; only env slot 0 is).
    h_slot_imag: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 34, 4)))


def _hybrid_filter(x: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """13-tap conjugate-symmetric FIR (FFmpeg ps_hybrid_analysis):
    x [T+12] complex input, filt [bands, 7] -> [bands, T] complex."""
    T = len(x) - 12
    bands = filt.shape[0]
    out = np.zeros((bands, T), np.complex128)
    fr, fi = filt.real, filt.imag
    for j in range(6):
        in0 = x[j: j + T]
        in1 = x[12 - j: 12 - j + T]
        s_re = in0.real + in1.real
        d_im = in0.imag - in1.imag
        s_im = in0.imag + in1.imag
        d_re = in0.real - in1.real
        out += (fr[:, j, None] * s_re - fi[:, j, None] * d_im) \
            + 1j * (fr[:, j, None] * s_im + fi[:, j, None] * d_re)
    mid = x[6: 6 + T]
    out += fr[:, 6, None] * (mid.real + 1j * mid.imag)
    return out


_G1_Q2 = np.array([0.0, 0.01899487526049, 0.0, -0.07293139167538,
                   0.0, 0.30596630545168, 0.5])


def _hybrid2(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Real 2-band split (FFmpeg hybrid2_re): returns (in+op, in-op)."""
    mid = _G1_Q2[6] * buf[6: 6 + SLOTS]
    op = (_G1_Q2[1] * (buf[1: 1 + SLOTS] + buf[11: 11 + SLOTS])
          + _G1_Q2[3] * (buf[3: 3 + SLOTS] + buf[9: 9 + SLOTS])
          + _G1_Q2[5] * (buf[5: 5 + SLOTS] + buf[7: 7 + SLOTS]))
    return mid + op, mid - op


def hybrid_analysis(proc: PSProc, X: np.ndarray, is34: bool) -> np.ndarray:
    """X [38, 64] (32 slots + 6 lookahead) -> hybrid channels
    s [NR_BANDS, 32].  Keeps the 6-slot input history per low QMF band."""
    t = _tables()
    nb = NR_BANDS[is34]
    s = np.zeros((nb, SLOTS), np.complex128)
    ins = []
    for i in range(5):
        buf = np.concatenate([proc.in_hist[i], X[:, i]])  # [6+38]
        ins.append(buf)
        proc.in_hist[i] = buf[SLOTS: SLOTS + LOOK]
    if not is34:
        sub = _hybrid_filter(ins[0][: SLOTS + 12], t["f20_0_8"])  # [8, 32]
        # 8 complex sub-bands fold to 6 (fold order recovered from the
        # libavcodec binary: singles 6,7,0,1 then pairs 2+5 and 3+4)
        s[0] = sub[6]
        s[1] = sub[7]
        s[2] = sub[0]
        s[3] = sub[1]
        s[4] = sub[2] + sub[5]
        s[5] = sub[3] + sub[4]
        # bands 1 and 2: 13-tap real 2-band split (prototype g1_Q2; only
        # taps 1/3/5/6 are nonzero — values confirmed against the
        # libavcodec binary constants)
        for qmf_band, base, rev in ((1, 6, 1), (2, 8, 0)):
            s[base + rev], s[base + 1 - rev] = _hybrid2(ins[qmf_band])
        for i in range(61):
            s[10 + i] = X[:SLOTS, i + 3]
    else:
        s[0:12] = _hybrid_filter(ins[0][: SLOTS + 12], t["f34_0_12"])
        s[12:20] = _hybrid_filter(ins[1][: SLOTS + 12], t["f34_1_8"])
        s[20:24] = _hybrid_filter(ins[2][: SLOTS + 12], t["f34_2_4"])
        s[24:28] = _hybrid_filter(ins[3][: SLOTS + 12], t["f34_2_4"])
        s[28:32] = _hybrid_filter(ins[4][: SLOTS + 12], t["f34_2_4"])
        for i in range(59):
            s[32 + i] = X[:SLOTS, i + 5]
    return s


def hybrid_synthesis(s: np.ndarray, is34: bool) -> np.ndarray:
    """Hybrid channels [NR_BANDS, 32] -> QMF plane [32, 64]."""
    X = np.zeros((SLOTS, 64), np.complex128)
    if not is34:
        X[:, 0] = s[0:6].sum(axis=0)
        X[:, 1] = s[6] + s[7]
        X[:, 2] = s[8] + s[9]
        for i in range(61):
            X[:, i + 3] = s[10 + i]
    else:
        X[:, 0] = s[0:12].sum(axis=0)
        X[:, 1] = s[12:20].sum(axis=0)
        X[:, 2] = s[20:24].sum(axis=0)
        X[:, 3] = s[24:28].sum(axis=0)
        X[:, 4] = s[28:32].sum(axis=0)
        for i in range(59):
            X[:, i + 5] = s[32 + i]
    return X


def decorrelate(proc: PSProc, s: np.ndarray, is34: bool) -> np.ndarray:
    """Transient-attenuated allpass decorrelation (FFmpeg decorrelate)."""
    t = _tables()
    nb = NR_BANDS[is34]
    nap = NR_ALLPASS[is34]
    sdb = SHORT_DELAY_BAND[is34]
    k_to_i = t["k_to_i_34"] if is34 else t["k_to_i_20"]
    npar = NR_PAR_BANDS[is34]

    # per-parameter-band power + transient gain, per slot
    power = np.zeros((npar, SLOTS))
    for k in range(nb):
        power[k_to_i[k]] += np.abs(s[k]) ** 2
    tgain = np.ones((npar, SLOTS))
    for i in range(npar):
        for n in range(SLOTS):
            decayed = _PEAK_DECAY * proc.peak_decay_nrg[i]
            proc.peak_decay_nrg[i] = max(decayed, power[i, n])
            proc.power_smooth[i] += _A_SMOOTH * (power[i, n]
                                                 - proc.power_smooth[i])
            proc.peak_decay_diff[i] += _A_SMOOTH * (
                proc.peak_decay_nrg[i] - power[i, n] - proc.peak_decay_diff[i])
            denom = _TRANSIENT_IMPACT * proc.peak_decay_diff[i]
            if denom > proc.power_smooth[i]:
                tgain[i, n] = proc.power_smooth[i] / denom

    d = np.zeros_like(s)
    phi = t[f"phi_fract_{int(is34)}"]
    qf = t[f"q_fract_{int(is34)}"]
    decay_cutoff = (10, 32)[is34]
    for k in range(nb):
        g = tgain[k_to_i[k]]
        # update the plain delay line for this band
        line = np.concatenate([proc.delay[k], s[k]])
        proc.delay[k] = line[-MAX_DELAY:]
        if k < nap:
            gds = np.clip(1.0 - _DECAY_SLOPE * (k - decay_cutoff), 0.0, 1.0)
            ag = _A * gds
            # allpass cascade on the 2-slot-delayed signal
            x_in = line[MAX_DELAY - 2: MAX_DELAY - 2 + SLOTS] * phi[k]
            ap = proc.ap_delay[k]
            out = np.zeros(SLOTS, np.complex128)
            buf = [np.concatenate([ap[m], np.zeros(SLOTS, np.complex128)])
                   for m in range(AP_LINKS)]
            for n in range(SLOTS):
                cur = x_in[n]
                for m in range(AP_LINKS):
                    link_delay = buf[m][n + 2 - m]
                    nxt = link_delay * qf[k, m] - ag[m] * cur
                    buf[m][n + 5] = cur + ag[m] * nxt
                    cur = nxt
                out[n] = cur
            for m in range(AP_LINKS):
                proc.ap_delay[k][m] = buf[m][SLOTS: SLOTS + 5]
            d[k] = g * out
        elif k < sdb:
            d[k] = g * line[MAX_DELAY - 14: MAX_DELAY - 14 + SLOTS]
        else:
            d[k] = g * line[MAX_DELAY - 1: MAX_DELAY - 1 + SLOTS]
    return d


@functools.lru_cache(maxsize=None)
def _conj_mask(is34: bool, nb: int) -> np.ndarray:
    m = np.zeros(nb, bool)
    if is34:
        m[9:14] = True
    else:
        m[:2] = True
    return m


def _par_row(par: np.ndarray, e: int, npar: int) -> np.ndarray:
    """Map a transmitted iid/icc row to the processing resolution
    (FFmpeg map_idx_10_to_20 / 10_to_34 / 20_to_34)."""
    row = par[e]
    if len(row) == npar:
        return row
    if npar == 20:                    # 10 -> 20: repeat each entry
        return np.repeat(row, 2)
    if len(row) == 10:                # 10 -> 34
        return row[_MAP_10_TO_34]
    return _map_20_to_34(row)         # 20 -> 34


def _phase_row(par: np.ndarray, e: int, is34: bool, cut: int) -> np.ndarray:
    row = par[e]
    if not is34:
        if len(row) == 5:
            row = np.concatenate([np.repeat(row, 2), [0]])
    else:
        if len(row) == 5:
            row = np.pad(row, (0, 5))[_MAP_10_TO_34]
        elif len(row) == 11:
            row = _map_20_to_34(np.pad(row, (0, 9)))
    return row[:cut]


def resolve_frame_indices(ps: "P.PSData", ipd_hist: np.ndarray,
                          opd_hist: np.ndarray):
    """Resolve one frame's PS parameters to LUT indices — shared between
    the numpy reference path and the batched-device packer so both have
    identical semantics.

    Returns (ha_idx [num_env, npar], icc_idx [num_env, npar],
    opd_pd / ipd_pd [num_env, 17] 9-bit smoothed-phase indices where 0
    means identity, ipdopd flag).  Advances the 6-bit phase histories in
    place.  When ipdopd is off this frame the histories FREEZE — ffmpeg
    only ever resets them on a band-scheme switch, so an explicit
    enable_ipdopd=0 frame resumes from the pre-off phase state
    (tests/test_ps.py::test_ps_ipdopd_explicit_off_resume)."""
    is34 = ps.is34
    npar = NR_PAR_BANDS[is34]
    fine = ps.enable_iid and ps.iid_mode >= 3
    off = 30 if fine else 7
    num_env = ps.num_env
    cut = 17 if is34 else 11
    ipdopd = bool(ps.enable_ipdopd and ps.ipd_par is not None)
    ha = np.full((num_env, npar), 7, np.int64)
    ic = np.zeros((num_env, npar), np.int64)
    opd_pd = np.zeros((num_env, 17), np.int64)
    ipd_pd = np.zeros((num_env, 17), np.int64)
    for e in range(num_env):
        if ps.enable_iid:
            ha[e] = _par_row(ps.iid_par, e, npar) + off
        if ps.enable_icc:
            ic[e] = _par_row(ps.icc_par, e, npar)
        if ipdopd:
            ipd = _phase_row(ps.ipd_par, e, is34, cut)
            opd = _phase_row(ps.opd_par, e, is34, cut)
            oi = opd_hist[:cut] * 8 + opd
            ii = ipd_hist[:cut] * 8 + ipd
            opd_hist[:cut] = oi & 0x3F
            ipd_hist[:cut] = ii & 0x3F
            opd_pd[e, :cut] = oi
            ipd_pd[e, :cut] = ii
    return ha, ic, opd_pd, ipd_pd, ipdopd


def apply_ps(proc: PSProc, X: np.ndarray, ps: "P.PSData | None"
             ) -> tuple[np.ndarray, np.ndarray]:
    """Mono QMF plane X [38, 64] -> (Xl, Xr) [32, 64] stereo planes."""
    t = _tables()
    if ps is None:
        ps = proc.ps_prev
    if ps is None:
        # no parameters yet: duplicate mono
        return X[:SLOTS].copy(), X[:SLOTS].copy()
    proc.ps_prev = ps
    is34 = ps.is34
    if proc.is34_prev is not None and is34 != proc.is34_prev:
        # band-count switch: the decorrelator/transient state is laid
        # out per band scheme, so restart it — EXACTLY the buffer set
        # libavcodec memsets (delay, ap_delay, peak/power trackers).
        # The hybrid input history (raw low-QMF line, scheme-
        # independent) persists.  Sample-exact vs the oracle through
        # 34<->20<->10 flips incl. the flip frame itself
        # (tests/test_ps.py::test_ps_band_scheme_flip_sample_exact).
        proc.delay[:] = 0
        proc.ap_delay[:] = 0
        proc.peak_decay_nrg[:] = 0
        proc.power_smooth[:] = 0
        proc.peak_decay_diff[:] = 0
        # the persisted H matrices are REMAPPED to the new scheme's
        # parameter bands (libavcodec map_val_34_to_20/_20_to_34),
        # component-wise per column
        remap = _map_h_20_to_34 if is34 else _map_h_34_to_20
        for col in range(4):
            proc.h_prev[:, col] = remap(proc.h_prev[:, col])
        # ... and the running IPD/OPD phase accumulators restart
        # (libavcodec ipdopd_reset); they are mod-64 RUNNING sums, so
        # a mismatch here would never decay
        proc.ipd_hist[:] = 0
        proc.opd_hist[:] = 0
    proc.is34_prev = is34
    k_to_i = t["k_to_i_34"] if is34 else t["k_to_i_20"]
    npar = NR_PAR_BANDS[is34]
    nb = NR_BANDS[is34]

    s = hybrid_analysis(proc, X, is34)
    d = decorrelate(proc, s, is34)

    # mixing matrices per envelope, then per-slot linear interpolation
    l = np.zeros((nb, SLOTS), np.complex128)
    r = np.zeros((nb, SLOTS), np.complex128)
    num_env = ps.num_env
    ipd_cut = 17 if is34 else 11
    ha, ic, opd_pd, ipd_pd, ipdopd = resolve_frame_indices(
        ps, proc.ipd_hist, proc.opd_hist)

    # FFmpeg interpolates real-only matrices when ipdopd is off — but
    # it does NOT clear the stored imaginary components; they are
    # simply unread that frame and resume if IPD/OPD returns.
    prev_h = (proc.h_prev if ipdopd
              else proc.h_prev.real.astype(np.complex128))
    last_stop = -1
    for e in range(num_env):
        h_target = t["HA"][ha[e], ic[e]].astype(np.complex128)  # [npar,4]
        if ipdopd:
            opd_c = t["pd_smooth"][opd_pd[e, :ipd_cut]]
            adj = opd_c * np.conj(t["pd_smooth"][ipd_pd[e, :ipd_cut]])
            h_target[:ipd_cut, 0] *= opd_c
            h_target[:ipd_cut, 1] *= adj
            h_target[:ipd_cut, 2] *= opd_c
            h_target[:ipd_cut, 3] *= adj
            # bands >= the IPD cut inherit this envelope SLOT's stale
            # imaginary H (never rewritten in libavcodec)
            slot = proc.h_slot_imag[min(e + 1, 4)]
            h_target[ipd_cut:npar] = (h_target[ipd_cut:npar].real
                                      + 1j * slot[ipd_cut:npar])
            slot[:ipd_cut] = h_target[:ipd_cut].imag
        start = int(ps.border_position[e])
        stop = int(ps.border_position[e + 1])
        stop = min(stop, SLOTS - 1)
        width = 1.0 / max(stop - start, 1)
        hstep = (h_target - prev_h[:npar]) * width

        # Hybrid channels with negative center frequencies (k<=1 in
        # 20-band mode, 9<=k<=13 in 34-band) NEGATE the imaginary H at
        # the interpolation START only — the step still aims at the
        # un-negated target, so their phase track runs -im_prev ->
        # +im_target (libavcodec stereo_processing does exactly this;
        # recovered from its binary and pinned by tests/test_ps.py).
        imneg = -prev_h[:npar].imag.copy()
        imneg_step = (h_target.imag - imneg) * width
        cmask = _conj_mask(is34, nb)

        def mix(h, h_imneg, n):
            hk = h[k_to_i[:nb]]
            if h_imneg is not None:
                alt = hk.real + 1j * h_imneg[k_to_i[:nb]]
                hk = np.where(cmask[:, None], alt, hk)
            l[:, n] = s[:, n] * hk[:, 0] + d[:, n] * hk[:, 2]
            r[:, n] = s[:, n] * hk[:, 1] + d[:, n] * hk[:, 3]

        h = prev_h[:npar].copy()
        for n in range(start + 1, stop + 1):
            h = h + hstep
            imneg = imneg + imneg_step
            mix(h, imneg, n)
        prev_h = np.zeros((34, 4), np.complex128)
        prev_h[:npar] = h_target
        last_stop = stop
    if 0 <= last_stop < SLOTS - 1:
        # envelopes ended before the frame did: hold the final matrices
        for n in range(last_stop + 1, SLOTS):
            mix(prev_h[:npar], None, n)
    if not ipdopd:
        # ffmpeg's unconditional env-slot-0 copy carries the stored
        # imaginary components through real-only frames untouched
        prev_h = prev_h.real + 1j * proc.h_slot_imag[min(num_env, 4)]
    proc.h_prev = prev_h
    xl = hybrid_synthesis(l, is34)
    xr = hybrid_synthesis(r, is34)
    return xl, xr
