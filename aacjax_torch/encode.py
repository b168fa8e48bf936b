"""Production AAC-LC encoder: psychoacoustic model + rate control.

The reference is decode-only; this closes the loop so aacjax can both
produce and consume AAC.  Built on the syntax writers shared with the
test encoder (aacjax.testing.encoder), adding what makes an encoder
*real* rather than a fixture generator:

  - window-sequence switching: PCM-domain transient detection drives the
    LONG_START -> EIGHT_SHORT -> LONG_STOP state machine, with grouping
    derived from the attack position (pre-echo control),
  - a psychoacoustic model (simplified 3GPP TS 26.403 shape): per-SFB
    energies spread across bands with up/down masking slopes, an
    absolute-threshold-of-hearing floor, and a signal-to-mask offset,
    yielding a per-band allowed-distortion threshold,
  - distortion-controlled quantization: per-band scalefactors found by
    vectorized bisection so measured quantization noise sits at the
    threshold,
  - rate control: exact Huffman bit costing (vectorized over the frame
    from the codebook length tables) with a global scalefactor offset
    bisected to meet the per-frame bit budget, smoothed by a bit
    reservoir,
  - per-band M/S stereo decision on common-window frames (the decoder's
    stereo_ms butterfly is l+r / l-r, so M=(L+R)/2, S=(L-R)/2 is sent),
  - per-band codebook selection by exact cost between the two books of
    each magnitude class.

All per-frame analysis (MDCT, band energies, quantization trials, bit
costs) is batched numpy over [frames, channels, bins]; only the final
bitstream write is serial.  The decode pipeline is the correctness
oracle (tests/test_encode.py: roundtrip SNR, libavcodec cross-check,
bitrate accuracy).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host import huffman
from aacjax_torch.host.asc import StreamConfig, make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.host.syntax import _reflection_to_lpc
from aacjax_torch.testing.encoder import (ChannelSpec, CPESpec, TnsFilterSpec,
                                    adts_frame, analysis_matrix, end_frame,
                                    quantize_band, write_cpe, write_sce)

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3

# band-book codes shared with the bitstream writer
NOISE_BT, INTENSITY2_BT, INTENSITY_BT = 13, 14, 15


@__import__("functools").lru_cache(maxsize=8)
def _analysis_matrix_cached(n: int) -> np.ndarray:
    """Forward-MDCT matrices are pure functions of the length; generating
    the 2048-point one costs ~2 s, so share across encoder instances."""
    return analysis_matrix(n)


@__import__("functools").lru_cache(maxsize=4)
def _eld_analysis_matrix_cached(N: int) -> np.ndarray:
    """ELD analysis operator [6N, N]: the exact FIR dual of the decoder's
    biorthogonal low-delay synthesis bank, computed by polyphase
    inversion — M(u) = sum_j M_j u^j (the synthesis operator's four N x N
    blocks) has a finite inverse A(u) with u^1 delay and five significant
    blocks (the sixth is ~1e-9; kept for the exact 210 dB roundtrip).
    spec_t = [x_{t-5} .. x_t] @ A — five frames of HISTORY, zero
    lookahead, so the encoder stays low-delay."""
    M = tables.eld_synthesis_matrix(N)
    Mj = [M[:, j * N:(j + 1) * N] for j in range(4)]
    K, d, n_blocks = 16, 1, 6
    w = np.exp(2j * np.pi * np.arange(K) / K)
    Au = [np.linalg.inv(sum(Mj[j] * (wm ** j) for j in range(4)))
          * (wm ** d) for wm in w]
    Ai = [np.real(sum(Au[m] * w[m] ** (-i) for i2 in [0] for m in range(K))
                  / K) for i in range(n_blocks)]
    return np.ascontiguousarray(np.vstack(Ai[::-1]))


# ---------------------------------------------------------------------------
# Vectorized Huffman bit costing (exact codeword lengths from the books)
# ---------------------------------------------------------------------------
def _build_cost_luts():
    """Dense length LUTs per spectral book, indexed by the mixed-radix
    symbol tuple; plus the scalefactor-delta length table."""
    luts = {}
    for b in range(1, 12):
        tbl = huffman.SPECTRAL_BOOKS[b - 1]
        n = 4 if b in huffman.QUAD_BOOKS else 2
        unsigned = huffman.UNSIGNED[b - 1]
        vals = tbl.values[:, :n].astype(np.int64)
        lav = int(np.max(np.abs(vals)))
        radix = lav + 1 if unsigned else 2 * lav + 1
        offs = 0 if unsigned else lav
        arr = np.zeros(radix ** n, np.uint8)
        idx = np.zeros(len(vals), np.int64)
        for j in range(n):
            idx = idx * radix + (vals[:, j] + offs)
        arr[idx] = tbl.lens
        luts[b] = (arr, radix, offs, n, unsigned, lav)
    sf_len = np.zeros(121, np.uint8)
    for i in range(len(huffman.SF_BOOK.values)):
        sf_len[int(huffman.SF_BOOK.values[i, 0])] = huffman.SF_BOOK.lens[i]
    return luts, sf_len


_COST_LUTS, _SF_LEN = _build_cost_luts()


def spectral_bits(q: np.ndarray, book: int) -> int:
    """Exact bit count to Huffman-code quantized values `q` (len % n == 0)
    with `book`, including sign bits and book-11 escape sequences."""
    arr, radix, offs, n, unsigned, lav = _COST_LUTS[book]
    v = q.astype(np.int64).reshape(-1, n)
    if book == huffman.ESC_BOOK:
        a = np.abs(v)
        sym = np.minimum(a, huffman.ESC_FLAG)
        idx = (sym[:, 0] + offs) * radix + (sym[:, 1] + offs)
        bits = int(arr[idx].sum()) + int(np.count_nonzero(sym))
        esc = a[a >= huffman.ESC_FLAG]
        if esc.size:
            nbits = np.maximum(
                np.floor(np.log2(esc)).astype(np.int64), 4)
            bits += int(np.sum(2 * nbits - 3))
        return bits
    if unsigned:
        sym = np.abs(v)
        sign_bits = int(np.count_nonzero(sym))
    else:
        sym = v
        sign_bits = 0
    idx = np.zeros(len(sym), np.int64)
    for j in range(n):
        idx = idx * radix + (sym[:, j] + offs)
    return int(arr[idx].sum()) + sign_bits


# magnitude-class candidate books: (threshold LAV, [books to cost])
_BOOK_CLASSES = [(1, (1, 2)), (2, (3, 4)), (4, (5, 6)), (7, (7, 8)),
                 (12, (9, 10)), (8191, (11,))]


def choose_book(q: np.ndarray) -> tuple[int, int]:
    """Cheapest legal codebook for a band: (book, bits).  q all-zero
    bands use book 0 at 0 bits."""
    m = int(np.max(np.abs(q))) if q.size else 0
    if m == 0:
        return 0, 0
    for lav, books in _BOOK_CLASSES:
        if m <= lav:
            costs = [(spectral_bits(q, b), b) for b in books]
            bits, book = min(costs)
            return book, bits
    raise ValueError(f"quantized magnitude {m} exceeds the escape limit")


def _book_tuple_bits(sub: np.ndarray, sub_ptr: np.ndarray,
                     book: int) -> np.ndarray:
    """Per-band bit counts for coding each band of the concatenated
    values `sub` (band boundaries sub_ptr, every width % n == 0) with
    one book.  Vectorized version of spectral_bits over many bands."""
    arr, radix, offs, n, unsigned, _lav = _COST_LUTS[book]
    nb = len(sub_ptr) - 1
    if not len(sub):
        return np.zeros(nb, np.int64)
    v = sub.reshape(-1, n)
    if book == huffman.ESC_BOOK:
        a = np.abs(v)
        sym = np.minimum(a, huffman.ESC_FLAG)
        tup = arr[(sym[:, 0] + offs) * radix + (sym[:, 1] + offs)] \
            .astype(np.int64)
        tup += np.count_nonzero(sym, axis=1)
        esc = np.where(a >= huffman.ESC_FLAG,
                       2 * np.maximum(np.floor(np.log2(np.maximum(a, 1)))
                                      .astype(np.int64), 4) - 3, 0)
        tup += esc.sum(axis=1)
    else:
        sym = np.abs(v) if unsigned else v
        idx = np.zeros(len(sym), np.int64)
        for j in range(n):
            idx = idx * radix + (sym[:, j] + offs)
        tup = arr[idx].astype(np.int64)
        if unsigned:
            tup += np.count_nonzero(sym, axis=1)
    return np.add.reduceat(tup, sub_ptr[:-1] // n)


def bands_books_and_bits(q: np.ndarray, ptr: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-band codebook selection + exact bit cost over the
    band-concatenated quantized spectrum `q` (boundaries ptr).
    Returns (books [nb], bits [nb]); all-zero bands get book 0."""
    nb = len(ptr) - 1
    widths = np.diff(ptr)
    aq = np.abs(q)
    maxs = np.maximum.reduceat(aq, ptr[:-1]) if len(q) else \
        np.zeros(nb, np.int64)
    maxs = np.where(widths > 0, maxs, 0)
    books = np.zeros(nb, np.int64)
    bits = np.zeros(nb, np.int64)
    prev_lav = 0
    band_ids = np.repeat(np.arange(nb), widths)
    for lav, cands in _BOOK_CLASSES:
        sel = (maxs > prev_lav) & (maxs <= lav)
        prev_lav = lav
        if not np.any(sel):
            continue
        emask = sel[band_ids]
        sub = q[emask]
        sub_widths = widths[sel]
        sub_ptr = np.concatenate([[0], np.cumsum(sub_widths)])
        costs = np.stack([_book_tuple_bits(sub, sub_ptr, b)
                          for b in cands])
        best = np.argmin(costs, axis=0)
        books[sel] = np.asarray(cands)[best]
        bits[sel] = costs[best, np.arange(costs.shape[1])]
    return books, bits


# ---------------------------------------------------------------------------
# Psychoacoustic model
# ---------------------------------------------------------------------------
def _ath_energy(offsets: np.ndarray, sample_rate: int, frame: int,
                n_bins: int) -> np.ndarray:
    """Absolute threshold of hearing as per-band allowed energy in the
    coefficient domain (input convention: full-scale sine ~ 32768 amp
    mapped to ~96 dB SPL)."""
    centers = 0.5 * (offsets[:-1] + offsets[1:])
    f_khz = np.maximum(centers * sample_rate / (2.0 * n_bins), 40.0) / 1000.0
    ath_spl = (3.64 * f_khz ** -0.8
               - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
               + 1e-3 * f_khz ** 4)
    widths = (offsets[1:] - offsets[:-1]).astype(np.float64)
    # 0 dBFS sine: amplitude 32768 -> coefficient energy scales with the
    # MDCT normalization; fold the calibration into one constant
    full_scale = (32768.0 ** 2) * frame / 4.0
    return widths * full_scale * 10.0 ** ((ath_spl - 96.0) / 10.0)


@dataclass
class PsyParams:
    smr_db: float = 23.0          # signal-to-mask offset
    spread_up_db: float = 1.2     # masking rolloff per band, upward
    spread_down_db: float = 2.6   # downward


def psy_thresholds(band_energy: np.ndarray, ath: np.ndarray,
                   p: PsyParams) -> np.ndarray:
    """Allowed noise energy per band.  band_energy [..., n_bands]."""
    up = 10.0 ** (-p.spread_up_db / 10.0)
    down = 10.0 ** (-p.spread_down_db / 10.0)
    spread = band_energy.copy()
    for b in range(1, spread.shape[-1]):          # masker below -> above
        spread[..., b] = np.maximum(spread[..., b], spread[..., b - 1] * up)
    for b in range(spread.shape[-1] - 2, -1, -1):  # masker above -> below
        spread[..., b] = np.maximum(spread[..., b], spread[..., b + 1] * down)
    thr = spread * 10.0 ** (-p.smr_db / 10.0)
    return np.maximum(thr, ath)


# ---------------------------------------------------------------------------
# Quantization: distortion-controlled scalefactors
# ---------------------------------------------------------------------------
def _band_distortion(coefs: np.ndarray, sf: int) -> float:
    q = quantize_band(coefs, sf)
    gain = tables.scalefactor_gain(sf - 100 + tables.SF_OFFSET)
    rec = np.sign(q) * np.abs(q).astype(np.float64) ** (4.0 / 3.0) * gain
    d = coefs - rec
    return float(d @ d)


def sf_for_threshold(coefs: np.ndarray, thr: float, hi: int = 230) -> int:
    """Largest scalefactor whose measured quantization distortion stays
    at or below thr.  The lower bound is the smallest sf whose quantized
    magnitudes fit the 8191 escape limit (below it quantize_band clips
    and distortion stops being monotone in sf)."""
    m = float(np.max(np.abs(coefs)))
    # need (m / 2^((sf-100)/4))^0.75 <= 8191  =>  sf >= 100 + 4*log2(m/8191^(4/3))
    lo = int(np.ceil(100.0 + 4.0 * (np.log2(max(m, 1e-30))
                                    - (4.0 / 3.0) * np.log2(8191.0))))
    lo = max(lo, 0)
    if _band_distortion(coefs, lo) > thr:
        return lo
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if _band_distortion(coefs, mid) <= thr:
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Window decision
# ---------------------------------------------------------------------------
def detect_transients(pcm: np.ndarray, frame: int) -> np.ndarray:
    """Per-frame attack flags + attack sub-block index.

    A frame is transient when one of its 8 sub-blocks jumps well above
    the running loudness of the preceding blocks (pre-echo risk for a
    2048-sample window).  Returns [n_frames, 2] (flag, attack_window)."""
    mono = pcm.mean(axis=1) if pcm.ndim == 2 else pcm
    n_frames = len(mono) // frame
    sub = frame // 8
    e = (mono[: n_frames * frame] ** 2).reshape(n_frames * 8, sub).sum(axis=1)
    e = np.maximum(e, 1e-9)
    out = np.zeros((n_frames, 2), np.int64)
    hist = float(np.mean(e[:8]))
    for f in range(n_frames):
        blocks = e[f * 8:(f + 1) * 8]
        attack = -1
        for w in range(8):
            if blocks[w] > 10.0 * hist and blocks[w] > 1e4 * sub:
                attack = w
                break
            hist = 0.7 * hist + 0.3 * float(blocks[w])
        if attack >= 0:
            out[f] = (1, attack)
            hist = float(np.mean(blocks))
    return out


def window_sequence_plan(transient: np.ndarray) -> np.ndarray:
    """Map per-frame transient flags to a legal window-sequence chain.

    Transition rules (a frame's left half must mirror its predecessor's
    right half): ONLY_LONG/LONG_STOP -> {ONLY_LONG, LONG_START};
    LONG_START/EIGHT_SHORT -> {EIGHT_SHORT, LONG_STOP}.  An attack frame
    becomes EIGHT_SHORT; its predecessor LONG_START (or EIGHT_SHORT when
    it was already short-entered); its successor LONG_STOP."""
    n = len(transient)
    seq = np.full(n, ONLY_LONG, np.int64)
    for f in range(n):
        if transient[f, 0]:
            seq[f] = EIGHT_SHORT
    for f in range(n):
        if seq[f] != EIGHT_SHORT or f == 0:
            continue
        if seq[f - 1] == ONLY_LONG:
            seq[f - 1] = LONG_START
    for f in range(1, n):
        if seq[f - 1] in (LONG_START, EIGHT_SHORT):
            if seq[f] == ONLY_LONG:
                seq[f] = LONG_STOP
            elif seq[f] == LONG_START:
                # a START for the NEXT attack but entered from a short
                # exit: only EIGHT_SHORT has the short-rise left half
                seq[f] = EIGHT_SHORT
    return seq


def grouping_for_attack(attack_w: int) -> list[int]:
    """Short-window grouping around the attack: long pre-group (smears
    nothing), fine groups at and after the attack."""
    w = int(np.clip(attack_w, 0, 7))
    if w == 0:
        return [1, 1, 6]
    if w >= 6:
        return [w, 8 - w]
    return [w, 1, 7 - w]


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Coding tools: TNS analysis, PNS detection, intensity stereo
# ---------------------------------------------------------------------------
def _levinson(r: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin on autocorrelation r[0..order].  Returns
    (reflection coefficients k[1..order], prediction error per order
    err[0..order]).  Convention: order-1 predictor y[n] ~ k1*y[n-1], so
    k feeds the decoder's reflection-to-LPC conversion directly
    (host/syntax._reflection_to_lpc; verified by the tns roundtrip
    test)."""
    a = np.zeros(order + 1)
    k = np.zeros(order + 1)
    err = np.zeros(order + 1)
    err[0] = r[0]
    for m in range(1, order + 1):
        if err[m - 1] <= 0:
            err[m:] = err[m - 1]
            break
        acc = r[m] - np.dot(a[1:m], r[m - 1:0:-1])
        km = acc / err[m - 1]
        k[m] = km
        prev = a[1:m].copy()
        a[m] = km
        a[1:m] = prev - km * prev[::-1]
        err[m] = err[m - 1] * (1.0 - km * km)
    return k[1:], err


# 4-bit TNS coefficient table (coef_res=1, coef_compress=0): the exact
# values the decoder reconstructs (tables.TNS_TABLES layout)
_TNS_Q_TABLE = tables.TNS_TABLES[1]


def tns_analyze(spec: np.ndarray, start: int, end: int,
                max_order: int = 12, gain_min: float = 1.35
                ) -> tuple[np.ndarray, list[int]] | None:
    """Pick a TNS filter for spectral region [start, end): Levinson on the
    region's autocorrelation, order chosen where the prediction-gain curve
    flattens, reflection coefficients quantized to the decoder's 4-bit
    table.  Returns (decoder-form lpc, coef table indices) or None when
    prediction gain is below gain_min (TNS would spend bits for nothing)."""
    y = spec[start:end]
    n = len(y)
    if n < 2 * max_order:
        return None
    r = np.array([float(y[:n - i] @ y[i:]) for i in range(max_order + 1)])
    if r[0] <= 0:
        return None
    r[0] *= 1.0001  # tiny white-noise floor stabilizes the recursion
    k, err = _levinson(r, max_order)
    gains = r[0] / np.maximum(err[1:], 1e-30)
    if float(gains[-1]) < gain_min:
        return None
    # smallest order achieving 95% of the max achievable log-gain
    target = 0.95 * np.log(gains[-1])
    order = int(np.searchsorted(np.log(np.maximum(gains, 1.0)), target) + 1)
    order = min(max(order, 1), max_order)
    idxs = [int(np.argmin(np.abs(_TNS_Q_TABLE - kk))) for kk in k[:order]]
    # drop trailing taps that quantized to zero coefficients
    while order > 1 and abs(float(_TNS_Q_TABLE[idxs[order - 1]])) < 1e-9:
        order -= 1
    refl = _TNS_Q_TABLE[idxs[:order]]
    if np.all(np.abs(refl) < 1e-9):
        return None
    lpc = _reflection_to_lpc(np.asarray(refl, np.float32)).astype(np.float64)
    # measured gain with the quantized filter: residual energy of the FIR
    x = tns_fir(spec, start, end, lpc)[start:end]
    e_res = float(x @ x)
    if e_res <= 0 or r[0] / e_res < gain_min:
        return None
    return lpc, idxs[:order]


def tns_fir(spec: np.ndarray, start: int, end: int,
            lpc: np.ndarray) -> np.ndarray:
    """The analysis (all-zero) filter inverse to the decoder's AR pass
    (refdec.apply_tns): x[n] = y[n] + sum_i lpc[i-1] * y[n-i], history
    zero before the region start — i.e. one convolution with [1, lpc].
    Returns a copy with [start, end) replaced by the residual."""
    out = spec.copy()
    y = spec[start:end]
    out[start:end] = np.convolve(y, np.concatenate(([1.0], lpc)))[:len(y)]
    return out


def spectral_flatness(p: np.ndarray) -> float:
    """Geometric / arithmetic mean of the band's power spectrum: ->1 for
    noise, ->0 for tones."""
    p = np.maximum(p, 1e-12)
    return float(np.exp(np.mean(np.log(p))) / np.mean(p))


class AACEncoder:
    """AAC encoder producing ADTS (encode), LOAS/LATM (encode_loas) or
    raw payloads (encode_frames, for LATM/MP4 muxing).

    Profiles: AAC-LC (default, 1024- or 960-sample frames), ER AAC-LC
    (AOT 17) and low-delay AAC-LD (AOT 23, 512/480-sample frames —
    ~1.5-frame algorithmic latency for conferencing; always-long
    windows, ER element layout).  960/ER/LD streams have no ADTS
    representation — use encode_loas / encode_frames.

    pcm convention matches the decoder output: float, full scale 32768
    (int16 range).  `bitrate` is the total target across channels."""

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: int = 128_000, psy: PsyParams | None = None,
                 tns: bool = True, pns: bool = True,
                 intensity: bool = True, cutoff_hz: float | None = None,
                 profile: int = 2, frame_length: int | None = None):
        if channels not in (1, 2):
            raise ValueError("AACEncoder supports mono and stereo")
        if profile not in (2, 17, 23, 39):
            raise ValueError(f"unsupported encode profile {profile}")
        if frame_length is None:
            frame_length = 512 if profile in (23, 39) else 1024
        legal = {2: (1024, 960), 17: (1024, 960), 23: (512, 480),
                 39: (512, 480)}[profile]
        if frame_length not in legal:
            raise ValueError(
                f"profile {profile} frame_length must be one of {legal}")
        try:
            sample_index = list(tables.SAMPLE_RATES).index(sample_rate)
        except ValueError:
            raise ValueError(f"unsupported sample rate {sample_rate}")
        self.profile = profile
        self._er = profile in (17, 23, 39)
        self._eld = profile == 39
        self.config: StreamConfig = parse_asc(
            make_asc(profile, sample_index, channels,
                     frame_length=frame_length))
        self.sample_rate = sample_rate
        self.channels = channels
        self.bitrate = bitrate
        self.psy = psy or PsyParams()
        self._frame = self.config.frame_length
        self._amat_long = _analysis_matrix_cached(2 * self._frame)
        self._amat_short = _analysis_matrix_cached(2 * self._frame // 8)
        self._win_long = None  # built lazily per shape need
        # bandwidth cutoff from per-channel rate (classic encoder rule of
        # thumb; keeps bits where masking can use them)
        per_ch = bitrate / channels
        if cutoff_hz is None:
            cutoff_hz = min(0.45 * sample_rate,
                            4000.0 + per_ch * 0.12, 20000.0)
        cutoff_hz = min(cutoff_hz, 0.5 * sample_rate)
        self._cutoff_bin = int(cutoff_hz / (sample_rate / 2.0) * self._frame)
        self._reservoir = 0.0
        self._reservoir_cap = 6.0 * bitrate * self._frame / sample_rate
        # coding tools (long windows): TNS noise shaping, perceptual
        # noise substitution, intensity stereo
        self.use_tns = tns
        # PNS stays off in ER syntax (conservative: matches the content
        # every ER decoder is known to accept)
        self.use_pns = pns and not self._er
        self.use_is = intensity and channels == 2
        hz_per_bin = sample_rate / (2.0 * self._frame)
        self._tns_start_hz = 1500.0
        self._pns_start_bin = int(4000.0 / hz_per_bin)
        self._is_start_bin = int(4500.0 / hz_per_bin)

    # -- analysis -------------------------------------------------------------
    def _window_long(self, seq: int) -> np.ndarray:
        F = self._frame
        S = F // 8
        MID = (F - S) // 2
        rise = tables.long_window(0, F)
        srise = tables.short_window(0, S)
        w = np.zeros(2 * F)
        if seq == ONLY_LONG:
            w[:F] = rise
            w[F:] = rise[::-1]
        elif seq == LONG_START:
            w[:F] = rise
            w[F:F + MID] = 1.0
            w[F + MID:F + MID + S] = srise[::-1]
        elif seq == LONG_STOP:
            w[MID:MID + S] = srise
            w[MID + S:F] = 1.0
            w[F:] = rise[::-1]
        return w

    def _mdct_long(self, seg: np.ndarray, seq: int) -> np.ndarray:
        return (seg * self._window_long(seq)) @ self._amat_long

    def _mdct_eld(self, seg6: np.ndarray) -> np.ndarray:
        """ELD low-delay analysis: one [6N] sliding segment (5 frames of
        history, zero lookahead) -> N coefficients."""
        return seg6 @ _eld_analysis_matrix_cached(self._frame)

    def _mdct_short(self, seg: np.ndarray) -> np.ndarray:
        """8 short MDCTs over the frame's span: window w covers
        [MID + w*S, MID + w*S + 2S) of the 2F span (decoder places its
        short IMDCTs at the same offsets, kernels/windows.py MID)."""
        F = self._frame
        S = F // 8
        MID = (F - S) // 2
        srise = tables.short_window(0, S)
        wfull = np.concatenate([srise, srise[::-1]])
        segs = np.stack([seg[MID + w * S: MID + w * S + 2 * S]
                         for w in range(8)])
        return (segs * wfull) @ self._amat_short  # [8, S]

    # -- per-frame coding -----------------------------------------------------
    @staticmethod
    def _vquant(bx: np.ndarray, sf_el: np.ndarray) -> np.ndarray:
        """Mid-tread AAC quantizer over the band-concatenated spectrum
        with a per-element scalefactor vector."""
        gain = np.exp2((sf_el - 100.0) / 4.0)
        c = np.floor(np.power(np.abs(bx) / gain, 0.75) + 0.4054)
        return np.sign(bx) * np.minimum(c, 8191.0)

    def _analyze_channel(self, coefs, seq: int, grouping,
                         offsets: np.ndarray, max_sfb: int,
                         thr: np.ndarray,
                         override: dict | None = None) -> dict:
        """Per-band analysis for one channel, in band-concatenated flat
        form for vectorized requantization:
          bx   — all candidate bands' coefficients, concatenated
          ptr  — band boundaries into bx
          dest — grouped-layout spectrum index for every bx element
          base_sf — coarsest sf meeting the psy threshold (capped at the
                    band's zeroing point so negative rate offsets
                    re-admit masked bands loudest-first)
          fit_sf  — finest legal sf (8191 escape-limit fit).

        base_sf comes from the analytic noise model of the 4/3-power
        quantizer — noise ~ 0.148 * gain^1.5 * sum(sqrt|x|) — refined by
        two measured-distortion correction steps."""
        n_groups = len(grouping) if grouping else 1
        S = self._frame // 8 if seq == EIGHT_SHORT else self._frame
        glens = list(grouping) if grouping else [1]
        group_starts = np.concatenate(
            [[0], np.cumsum([glen * S for glen in glens])])
        chunks, dests, meta = [], [], []
        idx = 0
        for g, glen in enumerate(glens):
            for sfb in range(max_sfb):
                a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                if seq == EIGHT_SHORT:
                    band = np.concatenate(
                        [coefs[g][w * S + a: w * S + b] for w in range(glen)])
                    dest = np.concatenate(
                        [np.arange(group_starts[g] + w * S + a,
                                   group_starts[g] + w * S + b)
                         for w in range(glen)])
                else:
                    band = coefs[g][a:b]
                    dest = np.arange(a, b)
                if (band.size and float(band @ band) > 1e-6 * band.size
                        and not (override and idx in override)):
                    chunks.append(band)
                    dests.append(dest)
                    meta.append((idx, g, sfb))
                idx += 1
        nb = len(chunks)
        layout = dict(glens=glens, S=S, n_groups=n_groups, max_sfb=max_sfb,
                      seq=seq)
        if nb == 0:
            return dict(bx=np.zeros(0), ptr=np.zeros(1, np.int64),
                        dest=np.zeros(0, np.int64),
                        idxs=np.zeros(0, np.int64),
                        base_sf=np.zeros(0, np.int64),
                        fit_sf=np.zeros(0, np.int64),
                        override=override or {}, **layout)
        bx = np.concatenate(chunks)
        ptr = np.concatenate([[0], np.cumsum([len(c) for c in chunks])]) \
            .astype(np.int64)
        widths = np.diff(ptr)
        m = np.maximum.reduceat(np.abs(bx), ptr[:-1])
        lg = np.log2(np.maximum(m, 1e-30))
        fit_sf = np.maximum(np.ceil(
            100.0 + 4.0 * (lg - (4.0 / 3.0) * np.log2(8191.0))), 0) \
            .astype(np.int64)
        zero_sf = np.ceil(
            100.0 + 4.0 * (lg - (4.0 / 3.0) * np.log2(0.5946))) \
            .astype(np.int64)
        thr_b = np.array([float(thr[g, sfb]) for _, g, sfb in meta])
        # analytic base: noise(sf) ~ 0.1481 * g^1.5 * sum(sqrt|x|)
        sq = np.add.reduceat(np.sqrt(np.abs(bx)), ptr[:-1])
        g_t = np.power(thr_b / np.maximum(0.1481 * sq, 1e-30), 2.0 / 3.0)
        base = np.floor(100.0 + 4.0 * np.log2(np.maximum(g_t, 1e-30))) \
            .astype(np.int64)
        base = np.clip(base, fit_sf, zero_sf)
        # refine: measure, step down where noise overshoots the threshold
        for _ in range(2):
            sf_el = np.repeat(base, widths).astype(np.float64)
            q = self._vquant(bx, sf_el)
            rec = np.sign(q) * np.power(np.abs(q), 4.0 / 3.0) \
                * np.exp2((sf_el - 100.0) / 4.0)
            d = np.add.reduceat((bx - rec) ** 2, ptr[:-1])
            over = d > thr_b
            if not np.any(over):
                break
            step = np.ceil(np.log2(np.maximum(d / thr_b, 1.0)) / 0.375) \
                .astype(np.int64)
            base = np.clip(base - np.where(over, np.maximum(step, 1), 0),
                           fit_sf, zero_sf)
        return dict(bx=bx, ptr=ptr, dest=np.concatenate(dests),
                    idxs=np.array([i for i, _, _ in meta], np.int64),
                    base_sf=base, fit_sf=fit_sf,
                    override=override or {}, **layout)

    @staticmethod
    def _sf_track_bits(books: np.ndarray, sfs: np.ndarray) -> int:
        """Exact scalefactor-payload cost with the three DPCM tracks the
        syntax interleaves (spectrum / noise / intensity — the writer's
        write_scale_factors walk).  Each track's deltas chain only
        through its own bands, so the three subsequences cost
        independently (vectorized: this sits inside the rate-control
        bisection's hot loop)."""
        nz = np.nonzero(books)[0]
        if not nz.size:
            return 0
        b = books[nz]
        s = sfs[nz]
        bits = 0
        sm = b <= 11
        seq = s[sm]
        if seq.size:
            d = np.diff(seq, prepend=seq[0])  # gg == first coded sf
            bits += int(_SF_LEN[np.clip(d + 60, 0, 120)].sum())
        seq = s[b == NOISE_BT]
        if seq.size:
            bits += 9  # first noise delta is a 9-bit PCM word
            d = np.diff(seq)
            bits += int(_SF_LEN[np.clip(d + 60, 0, 120)].sum())
        seq = s[b >= INTENSITY2_BT]
        if seq.size:
            d = np.diff(seq, prepend=0)
            bits += int(_SF_LEN[np.clip(d + 60, 0, 120)].sum())
        return bits

    def _emit_cost(self, an: dict, sf_offset: int):
        """Quantize at base_sf + offset and return (books, sfs, q_flat,
        bits) where books/sfs are in the (group, sfb) layout and bits is
        the exact channel payload cost (spectral + sf + section + side).
        Noise/intensity override bands keep their fixed book/sf — only
        the spectrum track moves with the rate offset."""
        n_bands_layout = an["n_groups"] * an["max_sfb"]
        books = np.zeros(n_bands_layout, np.int64)
        sfs = np.zeros(n_bands_layout, np.int64)
        for i, (b, s) in an["override"].items():
            books[i] = b
            sfs[i] = s
        if not len(an["bx"]):
            side = 8 + (15 if an["seq"] == EIGHT_SHORT else 11) + 3
            bits = side + 4 + 9 if not an["override"] else (
                side + self._section_bits(books, an)
                + self._sf_track_bits(books, sfs))
            return books, sfs, np.zeros(0, np.int64), bits
        sf_band = np.clip(an["base_sf"] + sf_offset, an["fit_sf"], 255)
        widths = np.diff(an["ptr"])
        q = self._vquant(an["bx"], np.repeat(sf_band, widths)
                         .astype(np.float64)).astype(np.int64)
        bbooks, bbits = bands_books_and_bits(q, an["ptr"])
        books[an["idxs"]] = bbooks
        sfs[an["idxs"]] = np.where(bbooks > 0, sf_band, 0)
        bits = int(bbits.sum())
        bits += self._section_bits(books, an)
        bits += self._sf_track_bits(books, sfs)
        # global_gain + ics_info + pulse/tns/gain flags
        bits += 8 + (15 if an["seq"] == EIGHT_SHORT else 11) + 3
        return books, sfs, q, bits

    @staticmethod
    def _section_bits(books: np.ndarray, an: dict) -> int:
        sect_bits = 3 if an["seq"] == EIGHT_SHORT else 5
        esc = (1 << sect_bits) - 1
        bk2 = books.reshape(an["n_groups"], an["max_sfb"])
        bits = 0
        for g in range(an["n_groups"]):
            row = bk2[g]
            change = np.nonzero(np.diff(row))[0]
            runs = np.diff(np.concatenate([[0], change + 1,
                                           [an["max_sfb"]]]))
            bits += int(np.sum(4 + sect_bits * (runs // esc + 1)))
        return bits

    def _materialize(self, an: dict, books, sfs, q,
                     tns_spec=None) -> ChannelSpec:
        """Scatter the flat quantized values into the grouped-layout
        spectrum and build the ChannelSpec for the bitstream writer."""
        quant = np.zeros(self._frame, np.int64)
        if len(q):
            # zero out bands whose book collapsed to 0 (all-zero quant)
            keep = np.repeat(books[an["idxs"]] > 0, np.diff(an["ptr"]))
            quant[an["dest"][keep]] = q[keep]
        spec_idx = np.nonzero((books >= 1) & (books <= 11))[0]
        gg = int(np.clip(sfs[spec_idx[0]], 0, 255)) if spec_idx.size else 120
        return ChannelSpec(
            window_sequence=an["seq"], window_shape=0,
            max_sfb=an["max_sfb"],
            grouping=(list(an["glens"]) if an["seq"] == EIGHT_SHORT
                      else None),
            global_gain=gg, band_books=books, band_sf=sfs, quant=quant,
            tns=tns_spec)

    # -- public ---------------------------------------------------------------
    def encode_frames(self, pcm: np.ndarray,
                      fil_payloads: list[bytes] | None = None
                      ) -> list[bytes]:
        """Encode PCM [n, channels] to raw_data_block payloads.  Output
        has the standard 1-frame encoder delay plus a final flush frame.

        fil_payloads: optional per-output-frame FIL extension payloads
        (e.g. SBR data from the HE-AAC encoder), written between the
        channel element and END."""
        F = self._frame
        nch = self.channels
        pcm = np.asarray(pcm, np.float64).reshape(-1, nch)
        n_frames = pcm.shape[0] // F
        if pcm.shape[0] % F:
            pad = F - pcm.shape[0] % F
            pcm = np.concatenate([pcm, np.zeros((pad, nch))])
            n_frames += 1
        padded = np.concatenate(
            [np.zeros((F, nch)), pcm, np.zeros((2 * F, nch))], axis=0)
        trans = detect_transients(
            np.concatenate([np.zeros((F, nch)), pcm]), F)
        seq = window_sequence_plan(trans)
        if self.profile in (23, 39):
            # AAC-LD/ELD frames are always long (ISO/IEC 14496-3
            # §4.6.20.2); the short frame itself bounds pre-echo
            seq = np.zeros_like(seq)
        if self._eld:
            # the low-delay analysis reads 5 frames of HISTORY and no
            # lookahead; one flush frame drains the u^1 system delay
            padded_eld = np.concatenate(
                [np.zeros((5 * F, nch)), pcm, np.zeros((F, nch))],
                axis=0)
        off_l = self.config.swb_offsets_long
        off_s = self.config.swb_offsets_short
        # bandwidth cutoff -> coded band counts
        max_sfb_l = int(np.searchsorted(off_l, self._cutoff_bin, "left"))
        max_sfb_l = min(max(max_sfb_l, 1), self.config.swb_count_long)
        cutoff_s = self._cutoff_bin // 8
        max_sfb_s = int(np.searchsorted(off_s, cutoff_s, "left"))
        max_sfb_s = min(max(max_sfb_s, 1), self.config.swb_count_short)
        ath_l = _ath_energy(off_l[:max_sfb_l + 1], self.sample_rate, F, F)
        # short-window ATH: full_scale scales with the transform length,
        # so the calibration constant must use the SHORT length (F/8) —
        # the long constant left the floor ~9 dB too permissive on
        # transient frames.  ath_s is per WINDOW; the per-group threshold
        # scales by the group's window count where group energies sum
        ath_s = _ath_energy(off_s[:max_sfb_s + 1], self.sample_rate,
                            F // 8, F // 8)
        bits_per_frame = self.bitrate * F / self.sample_rate

        # plan the whole file's window sequences, then run every
        # non-short frame's forward MDCT as ONE batched matmul per
        # sequence type (the per-frame [2F]x[2F,F] products dominate the
        # analysis cost; BLAS amortizes them)
        n_payloads = n_frames + 1
        fseq_plan = [
            int(seq[f]) if f < len(seq) else (
                LONG_STOP if int(seq[-1]) in (LONG_START, EIGHT_SHORT)
                else ONLY_LONG)
            for f in range(n_payloads)]
        coefs_long = np.zeros((n_payloads, nch, F))
        if self._eld:
            segs = np.stack([padded_eld[f * F:(f + 6) * F].T
                             for f in range(n_payloads)])   # [P, ch, 6F]
            A = _eld_analysis_matrix_cached(F)
            coefs_long = (segs.reshape(-1, 6 * F) @ A).reshape(
                n_payloads, nch, F)
        else:
            for s_kind in (ONLY_LONG, LONG_START, LONG_STOP):
                rows = [f for f in range(n_payloads)
                        if fseq_plan[f] == s_kind]
                if not rows:
                    continue
                win = self._window_long(s_kind)
                segs = np.stack([padded[f * F:(f + 2) * F].T * win
                                 for f in rows])            # [p, ch, 2F]
                coefs_long[rows] = (segs.reshape(-1, 2 * F)
                                    @ self._amat_long).reshape(
                    len(rows), nch, F)

        payloads: list[bytes] = []
        for f in range(n_payloads):
            fseq = fseq_plan[f]
            # attack sub-block -> short-window index: short window k of
            # frame f starts at sample MID + 128k = 448 + 128k, i.e. ~3.5
            # sub-blocks into the frame
            grouping = (grouping_for_attack(int(trans[f, 1]) - 3
                                            if trans[f, 0] else 4)
                        if fseq == EIGHT_SHORT and f < len(trans) else
                        ([8] if fseq == EIGHT_SHORT else None))
            offsets = off_s if fseq == EIGHT_SHORT else off_l
            max_sfb = max_sfb_s if fseq == EIGHT_SHORT else max_sfb_l
            ath = ath_s if fseq == EIGHT_SHORT else ath_l
            seg = padded[f * F:(f + 2) * F]

            # channel coefficients in grouped layout [n_groups, ...]
            ch_coefs = []
            for ch in range(nch):
                if fseq == EIGHT_SHORT:
                    c8 = self._mdct_short(seg[:, ch])  # [8, S]
                    glens = grouping
                    rows, pos = [], 0
                    for glen in glens:
                        rows.append(c8[pos:pos + glen].reshape(-1))
                        pos += glen
                    ch_coefs.append(rows)
                else:
                    ch_coefs.append([coefs_long[f, ch].copy()])

            glens = grouping or [1]
            n_groups = len(glens)
            S = F // 8 if fseq == EIGHT_SHORT else F
            if fseq == EIGHT_SHORT:
                # band_energy sums |X|^2 over the group's glen windows;
                # the per-window ATH floor scales with the same count
                ath = np.asarray(glens, np.float64)[:, None] * ath_s

            def band_energy(rows):
                e = np.zeros((n_groups, max_sfb))
                for g, glen in enumerate(glens):
                    for sfb in range(max_sfb):
                        a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                        x = (np.concatenate([rows[g][w * S + a: w * S + b]
                                             for w in range(glen)])
                             if fseq == EIGHT_SHORT else rows[g][a:b])
                        e[g, sfb] = float(x @ x)
                return e

            # --- coding-tool decisions (long windows only) ---------------
            long_frame = fseq != EIGHT_SHORT
            overrides: list[dict] = [dict() for _ in range(nch)]
            tns_side = None   # (decoder lpc, (start,end) bins, filter spec)
            if self.use_tns and long_frame and max_sfb > 1:
                # LD AND ELD decoders clamp TNS regions at the LD band
                # table (syntax.py resolve paths); the analysis FIR must
                # cover exactly the region the AR pass will invert
                tmax = (self.config.tns_max_bands_ld
                        if self.profile in (23, 39)
                        else int(tables.TNS_MAX_BANDS_1024[
                            self.config.sample_index]))
                mmm = min(tmax, max_sfb)
                hz_per_bin = self.sample_rate / (2.0 * F)
                start_bin = int(self._tns_start_hz / hz_per_bin)
                start_band = max(0, min(
                    int(np.searchsorted(offsets[:mmm + 1], start_bin,
                                        "right")) - 1, mmm - 1))
                ra, rb = int(offsets[start_band]), int(offsets[mmm])
                probe = (ch_coefs[0][0] if nch == 1
                         else (ch_coefs[0][0] + ch_coefs[1][0]) * 0.5)
                got = tns_analyze(probe, ra, rb)
                if got is not None:
                    lpc, idxs = got
                    # decoder partitions regions top-down from swb_count
                    filt = TnsFilterSpec(
                        length_bands=(self.config.swb_count_long
                                      - start_band),
                        order=len(idxs), direction=0, coef_res=1,
                        coef_compress=0, coef_indices=idxs)
                    tns_side = (lpc, (ra, rb), filt)

            # PNS: noise-like high bands -> parametric noise (skipped on
            # TNS frames — the decoder's AR pass would run over decoded
            # noise, so the filter history would diverge from analysis)
            if self.use_pns and long_frame and tns_side is None:
                for ch in range(nch):
                    row = ch_coefs[ch][0]
                    for sfb in range(max_sfb):
                        a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                        if a < self._pns_start_bin:
                            continue
                        band = row[a:b]
                        e = float(band @ band)
                        if e <= 1e-6 * (b - a):
                            continue
                        if spectral_flatness(band * band) < 0.12:
                            continue  # tonal band: quantize normally
                        nsf = int(np.clip(round(2.0 * np.log2(e)),
                                          -100, 155))
                        overrides[ch][sfb] = (NOISE_BT, nsf)

            # Intensity stereo: correlated high bands -> left carries the
            # waveform, right reconstructs as scale*left (scale =
            # 0.5^(pos/4), book 15 in-phase / 14 out-of-phase)
            if self.use_is and long_frame and nch == 2:
                l0, r0 = ch_coefs[0][0], ch_coefs[1][0]
                for sfb in range(max_sfb):
                    a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                    if a < self._is_start_bin:
                        continue
                    if sfb in overrides[0] or sfb in overrides[1]:
                        continue
                    lb, rb_ = l0[a:b], r0[a:b]
                    el, er = float(lb @ lb), float(rb_ @ rb_)
                    if el <= 1e-9 or er <= 1e-9:
                        continue
                    c = float(lb @ rb_) / np.sqrt(el * er)
                    if abs(c) < 0.8:
                        continue
                    pos = int(np.clip(round(2.0 * np.log2(el / er)),
                                      -100, 100))
                    book = INTENSITY_BT if c > 0 else INTENSITY2_BT
                    overrides[1][sfb] = (book, pos)

            # M/S decision (stereo, same window everywhere by design)
            ms_used = None
            if nch == 2:
                e_l = band_energy(ch_coefs[0])
                e_r = band_energy(ch_coefs[1])
                mid = [(l + r) * 0.5 for l, r in
                       zip(ch_coefs[0], ch_coefs[1])]
                side = [(l - r) * 0.5 for l, r in
                        zip(ch_coefs[0], ch_coefs[1])]
                e_m = band_energy(mid)
                e_s = band_energy(side)
                ms_used = (e_m + e_s) < 0.8 * (e_l + e_r) + 1e-12
                # tool bands opt out of M/S: the decoder skips the
                # butterfly on noise/intensity bands, and ms_used on an
                # intensity band means phase-flip, not M/S
                for ch_ov in overrides:
                    for sfb in ch_ov:
                        ms_used[:, sfb] = False
                for g in range(n_groups):
                    for sfb in range(max_sfb):
                        if ms_used[g, sfb]:
                            a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                            sl = (slice(a, b) if fseq != EIGHT_SHORT else
                                  None)
                            for w in range(glens[g] if fseq == EIGHT_SHORT
                                           else 1):
                                s2 = (slice(w * S + a, w * S + b)
                                      if fseq == EIGHT_SHORT else sl)
                                ch_coefs[0][g][s2] = mid[g][s2]
                                ch_coefs[1][g][s2] = side[g][s2]
                thr_l = psy_thresholds(e_l, ath, self.psy)
                thr_r = psy_thresholds(e_r, ath, self.psy)
                thr = np.minimum(thr_l, thr_r)
                thrs = [thr, thr]
            else:
                thrs = [psy_thresholds(band_energy(ch_coefs[0]), ath,
                                       self.psy)]

            # TNS analysis filtering AFTER the M/S transform: the same
            # filter on both channels commutes with the (linear) M/S and
            # intensity reconstructions, so the decoder's AR pass inverts
            # it exactly on L and R
            if tns_side is not None:
                lpc, (ra, rb), _filt = tns_side
                for ch in range(nch):
                    ch_coefs[ch][0] = tns_fir(ch_coefs[ch][0], ra, rb, lpc)

            # short-window TNS: one order<=5 filter per 128-sample window
            # where prediction gain warrants it (transient frames)
            tns_short = None    # per-window filter lists for the writer
            if self.use_tns and not long_frame and max_sfb > 1:
                S_ = F // 8
                mmm = min(int(tables.TNS_MAX_BANDS_128[
                    self.config.sample_index]), max_sfb)
                hz_per_bin = self.sample_rate / (2.0 * S_)
                start_bin = int(self._tns_start_hz / hz_per_bin)
                start_band = max(0, min(
                    int(np.searchsorted(offsets[:mmm + 1], start_bin,
                                        "right")) - 1, mmm - 1))
                ra, rb = int(offsets[start_band]), int(offsets[mmm])
                flat = [np.concatenate(ch_coefs[ch]) for ch in range(nch)]
                probe = flat[0] if nch == 1 else (flat[0] + flat[1]) * 0.5
                win_filters: list[tuple | None] = []
                for wdw in range(8):
                    got = (tns_analyze(probe[wdw * S_:(wdw + 1) * S_],
                                       ra, rb, max_order=5, gain_min=1.5)
                           if rb - ra >= 12 else None)
                    win_filters.append(got)
                if any(g is not None for g in win_filters):
                    lists = []
                    for wdw, got in enumerate(win_filters):
                        if got is None:
                            lists.append([])
                            continue
                        lpc, idxs = got
                        lists.append([TnsFilterSpec(
                            length_bands=(self.config.swb_count_short
                                          - start_band),
                            order=len(idxs), direction=0, coef_res=1,
                            coef_compress=0, coef_indices=idxs)])
                        for ch in range(nch):
                            flat[ch][wdw * S_:wdw * S_ + S_] = tns_fir(
                                flat[ch][wdw * S_:(wdw + 1) * S_],
                                ra, rb, lpc)
                    tns_short = lists
                    for ch in range(nch):
                        pos = 0
                        for g, row in enumerate(ch_coefs[ch]):
                            ch_coefs[ch][g] = flat[ch][pos:pos + len(row)]
                            pos += len(row)

            # rate control — the classic two-loop: per-band base
            # scalefactors from the psy threshold (inner), then a global
            # offset bisected on exact Huffman bits to meet the budget
            # (outer).  Negative offsets spend surplus budget on finer
            # quantization; positive offsets coarsen to fit.
            analyses = [self._analyze_channel(
                ch_coefs[ch], fseq, grouping, offsets, max_sfb, thrs[ch],
                override=overrides[ch])
                for ch in range(nch)]
            # element id+instance, common_window+ms_type+mask, END+align
            elem_overhead = ((7 + 1 + 2 + n_groups * max_sfb
                              if nch == 2 else 7) + 3 + 7)
            if tns_side is not None:
                # tns_data_present replaces a 0 bit already counted; add
                # the filter payload per channel
                elem_overhead += nch * (2 + 1 + 6 + 5 + 1 + 1
                                        + 4 * tns_side[2].order)
            elif tns_short is not None:
                per_ch = 8  # one n_filt bit per window
                for lst in tns_short:
                    if lst:
                        per_ch += 1 + 4 + 3 + 1 + 1 + 4 * lst[0].order
                elem_overhead += nch * per_ch

            def emit(off: int):
                res = [self._emit_cost(a, off) for a in analyses]
                return res, elem_overhead + sum(r[3] for r in res)

            budget = bits_per_frame + min(self._reservoir, bits_per_frame)
            # smallest offset with bits <= budget; bits(off) is
            # nonincreasing in off.  Warm-start at the previous frame's
            # offset: steady-state content settles (2-3 emit() trials per
            # frame instead of a full [-60, 90] bisection)
            LO, HI = -60, 90
            cand = int(np.clip(getattr(self, "_warm_off", LO), LO, HI))
            r_c, u_c = emit(cand)
            if u_c <= budget:
                hi = cand
                res, used = r_c, u_c
                # finest offset still fitting: walk the bracket down
                lo = LO
                if cand > LO:
                    r_p, u_p = emit(cand - 1)
                    if u_p > budget:
                        lo = cand        # cand is already minimal
                    else:
                        hi = cand - 1
                        res, used = r_p, u_p
            else:
                lo, hi = cand + 1, HI
                r_hi, u_hi = emit(HI)
                if u_hi > budget:
                    res, used = r_hi, u_hi  # pathological: coarsest
                    lo = hi
                else:
                    res, used = r_hi, u_hi
            while lo < hi:
                mid = (lo + hi) // 2
                r, u = emit(mid)
                if u <= budget:
                    hi = mid
                    res, used = r, u
                else:
                    lo = mid + 1
            self._warm_off = hi
            tns_spec = ([[tns_side[2]]] if tns_side is not None
                        else tns_short)
            specs = [self._materialize(a, b, s, q, tns_spec=tns_spec)
                     for a, (b, s, q, _) in zip(analyses, res)]
            self._reservoir = float(np.clip(
                self._reservoir + bits_per_frame - used,
                0.0, self._reservoir_cap))

            # finalize: global_gain = first coded spectrum band's sf (or a
            # default), then clamp each DPCM track's inter-band deltas to
            # what the syntax can express (spectrum/intensity +-60; noise
            # first delta 9-bit +-256, then +-60)
            for spec in specs:
                books = spec.band_books
                spec_idx = np.nonzero((books >= 1) & (books <= 11))[0]
                gg = int(spec.band_sf[spec_idx[0]]) if spec_idx.size else 120
                spec.global_gain = int(np.clip(gg, 0, 255))
                prev = [spec.global_gain, spec.global_gain - 90, 0]
                noise_first = True
                for i in np.nonzero(books)[0]:
                    b = int(books[i])
                    if b == NOISE_BT:
                        lim = 256 if noise_first else 60
                        noise_first = False
                        t = 1
                    elif b in (INTENSITY_BT, INTENSITY2_BT):
                        t, lim = 2, 60
                    else:
                        t, lim = 0, 60
                    d = int(np.clip(int(spec.band_sf[i]) - prev[t],
                                    -lim, min(lim, 255)))
                    spec.band_sf[i] = prev[t] + d
                    prev[t] = prev[t] + d

            if self._eld:
                from aacjax_torch.testing.encoder import write_eld_frame
                if nch == 2:
                    elem = ("CPE", CPESpec(
                        left=specs[0], right=specs[1], common_window=True,
                        ms_type=1,
                        ms_used=ms_used.reshape(-1).astype(np.int64)))
                else:
                    elem = ("SCE", specs[0])
                payloads.append(write_eld_frame([elem], self.config))
                continue
            if self._er:
                from aacjax_torch.testing.encoder import write_er_frame
                if nch == 2:
                    elem = ("CPE", CPESpec(
                        left=specs[0], right=specs[1], common_window=True,
                        ms_type=1,
                        ms_used=ms_used.reshape(-1).astype(np.int64)))
                else:
                    elem = ("SCE", specs[0])
                payloads.append(write_er_frame([elem], self.config))
                continue
            w = BitWriter()
            if nch == 2:
                write_cpe(w, CPESpec(
                    left=specs[0], right=specs[1], common_window=True,
                    ms_type=1, ms_used=ms_used.reshape(-1).astype(np.int64)),
                    self.config)
            else:
                write_sce(w, specs[0], self.config)
            if fil_payloads is not None and f < len(fil_payloads):
                from aacjax_torch.testing.sbr_encoder import write_sbr_fil
                write_sbr_fil(w, fil_payloads[f])
            payloads.append(end_frame(w))
        return payloads

    def encode(self, pcm: np.ndarray, crc: bool = False,
               rdb_per_frame: int = 1) -> bytes:
        """Encode PCM to an ADTS byte stream (AAC-LC at 1024 frames;
        960/ER/LD streams have no ADTS representation — use
        encode_loas).  crc=True emits protected headers with the
        13818-7 §8.2.2 crc_check (decode_adts verify_crc=True checks
        it; interoperating decoders skip the field).

        rdb_per_frame (1-4) groups that many raw_data_blocks per ADTS
        frame (numFrames > 1); with crc=True the frame carries the full
        multi-rdb protection layout — raw_data_block_position words, a
        header crc_check over them, and a per-block trailing crc_check
        (adts.crc_block_status verifies each unit independently)."""
        if self._er or self.config.frame_length != 1024:
            raise ValueError(
                "ADTS cannot signal this profile/frame length; use "
                "encode_loas() or encode_frames()")
        if not 1 <= rdb_per_frame <= 4:
            raise ValueError("rdb_per_frame must be 1..4 (2-bit "
                             "number_of_raw_data_blocks_in_frame)")
        payloads = self.encode_frames(pcm)
        if rdb_per_frame == 1:
            return b"".join(adts_frame(p, self.config, crc=crc)
                            for p in payloads)
        from aacjax_torch.testing.encoder import adts_frame_multi
        return b"".join(
            adts_frame_multi(payloads[i:i + rdb_per_frame], self.config,
                             crc=crc)
            for i in range(0, len(payloads), rdb_per_frame))

    def encode_loas(self, pcm: np.ndarray) -> bytes:
        """Encode PCM to a LOAS/LATM byte stream (carries the full ASC,
        so every profile/frame length is expressible)."""
        from aacjax_torch.testing.encoder import loas_stream
        return loas_stream(self.encode_frames(pcm), self.config)


def encode_adts(pcm: np.ndarray, sample_rate: int = 44100,
                bitrate: int = 128_000) -> bytes:
    """One-call PCM -> ADTS.  pcm [n] or [n, channels], 32768 scale."""
    pcm = np.asarray(pcm)
    ch = 1 if pcm.ndim == 1 else pcm.shape[1]
    return AACEncoder(sample_rate, ch, bitrate).encode(pcm.reshape(-1, ch))


def encode_m4a(pcm: np.ndarray, sample_rate: int = 44100,
               bitrate: int = 128_000) -> bytes:
    """One-call PCM -> gapless .m4a: raw payloads muxed with elst
    priming metadata (1-frame encoder delay) and exact valid duration,
    so decode_m4a returns PCM aligned with the input."""
    from aacjax_torch.testing.mp4mux import mux_m4a
    pcm = np.asarray(pcm)
    ch = 1 if pcm.ndim == 1 else pcm.shape[1]
    pcm = pcm.reshape(-1, ch)
    enc = AACEncoder(sample_rate, ch, bitrate)
    payloads = enc.encode_frames(pcm)
    asc = make_asc(2, enc.config.sample_index, ch)
    return mux_m4a(payloads, asc, sample_rate, ch,
                   frame_length=enc.config.frame_length,
                   priming=enc.config.frame_length,
                   valid_samples=pcm.shape[0],
                   movie_ts=sample_rate)
