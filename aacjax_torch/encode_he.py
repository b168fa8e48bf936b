"""HE-AAC v1 (SBR) encoder: core AAC-LC at half rate + spectral band
replication side info.

The reference decodes nothing above plain AAC-LC; aacjax both decodes
HE-AAC (sample-exact vs libavcodec) and, with this module, produces it:

  - the input is split at the SBR crossover: a polyphase half-band
    decimation feeds the core AAC-LC encoder (psychoacoustics + rate
    control from aacjax.encode, bandwidth-capped at the crossover),
  - a 64-band complex QMF analysis of the full-rate input (same
    prototype and phase convention as the decoder's bank — magnitudes
    verified to track the decoder's 32-band core analysis to ~0.1%)
    measures the high-band, per-envelope target energies,
  - envelopes quantize by inverting the decoder's dequant exactly
    (e = 2^(q + 6) at amp_res=1, host/sbr.py dequant), so the decoder's
    envelope adjuster reproduces the measured energies by construction,
  - the noise floor and inverse-filtering levels come from spectral
    flatness: of the target high band (how noise-like the original is)
    against the patch source region (what the copied-up low band will
    look like),
  - the SBR payload rides a FIL extension per frame
    (aacjax.testing.sbr_encoder writers — the bit-level writers the
    conformance tests already validate against libavcodec).

Grid: FIXFIX with two envelopes per frame (amp_res=1) — 1024-sample
envelope resolution at the output rate; two noise floors per frame.

Validation (tests/test_encode_he.py): streams decode in both aacjax and
libavcodec; the reconstructed high band tracks the original's
third-octave band energies, and the core band decodes with normal
waveform SNR.
"""
from __future__ import annotations

import numpy as np

from aacjax_torch.encode import AACEncoder
from aacjax_torch.host import sbr as sbrmod
from aacjax_torch.kernels import qmf
from aacjax_torch.testing.encoder import adts_frame
from aacjax_torch.testing.sbr_encoder import PSSpec, SBRFrameSpec, sbr_payload

SLOTS_PER_FRAME = 32      # 2048 output samples / 64-sample QMF slots


def qmf_analysis64(x: np.ndarray) -> np.ndarray:
    """64-band complex QMF analysis of a full-rate signal (float64,
    spectral 32768 scale) -> [n//64, 64].

    Mirrors the structure of the decoder's 32-band bank
    (host/sbr_decode._qmf_analysis_np) at double size: the full 640-tap
    prototype (not decimated, no 2x upsampling compensation) and the
    matching modulation phase exp(j*pi/128*(k+0.5)*(2n-0.5)).  Verified
    numerically: low-band magnitudes match the decoder's core analysis
    of the half-rate signal to ~0.1%, i.e. the measured energies live in
    exactly the domain the decoder's envelope adjuster normalizes."""
    c = qmf.prototype().astype(np.float64)
    n = np.arange(128.0)
    k = np.arange(64.0)
    ang = np.pi / 128.0 * (k[:, None] + 0.5) * (2.0 * n[None, :] - 0.5)
    m = np.exp(1j * ang)                                  # [64, 128]
    buf = np.concatenate([np.zeros(640 - 64), np.asarray(x, np.float64)])
    S = len(x) // 64
    X = np.zeros((S, 64), np.complex128)
    for line in range(S):
        seg = buf[64 * line:64 * line + 640][::-1]
        u = (seg * c).reshape(5, 128).sum(axis=0)
        X[line] = m @ u
    return X


def _flatness(p: np.ndarray) -> float:
    p = np.maximum(p, 1e-9)
    return float(np.exp(np.mean(np.log(p))) / np.mean(p))


def _halfband_decimate(x: np.ndarray) -> np.ndarray:
    from scipy import signal as sig
    return sig.resample_poly(x, 1, 2, axis=0, padtype="line")


class HEAACEncoder:
    """PCM -> HE-AAC v1.  sample_rate is the OUTPUT rate (the core runs
    at half); pcm convention matches the decoder output (float, 32768
    full scale).  The ADTS header signals the core rate — decoders
    (aacjax and libavcodec alike) detect the SBR extension implicitly
    and emit 2x-rate PCM."""

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: int = 48_000,
                 header: sbrmod.SBRHeader | None = None,
                 ps: bool = False, ps_bands: int | None = None):
        if sample_rate % 2:
            raise ValueError("output sample rate must be even")
        if ps and channels != 2:
            raise ValueError("Parametric Stereo needs stereo input")
        if ps_bands not in (None, 10, 20, 34):
            raise ValueError("ps_bands must be 10, 20 or 34")
        self.sample_rate = sample_rate
        self.ps = ps
        # PS parameter resolution: 20 IID/ICC bands when the budget
        # affords the extra side info, 10 at low rates; 34 (the finest
        # grid, hybrid-34 filterbank in the decoder) on request
        self._ps_nr = ps_bands if ps_bands else (
            20 if (ps and bitrate >= 40_000) else 10)
        self.channels = 1 if ps else channels   # coded channel count
        self.in_channels = channels
        # default range: crossover ~5.5 kHz, reconstruction to ~16 kHz at
        # 44.1/48 kHz output (the classic HE-AAC operating point)
        self.header = header or sbrmod.SBRHeader(
            amp_res=1, start_freq=7, stop_freq=9, xover_band=0)
        self.tables = sbrmod.derive_tables(self.header, sample_rate)
        self.bitrate = bitrate
        # crossover: QMF band kx at the output rate
        self.kx = int(self.tables.kx)
        xover_hz = self.kx * (sample_rate / 2.0) / 64.0
        self.core = AACEncoder(sample_rate // 2, self.channels, bitrate,
                               cutoff_hz=xover_hz * 1.02)
        self._frame_out = 2 * self.core.config.frame_length   # 2048

    # -- SBR side-info extraction -------------------------------------------
    def _frame_spec(self, X: np.ndarray, lo_slot: int) -> SBRFrameSpec:
        """Measure one frame's SBR payload from the full-rate QMF plane
        X [S, 64]; the frame covers slots [lo_slot, lo_slot + 32)."""
        t = self.tables
        kx, m = self.kx, int(t.m)
        ftab = t.freq_table(1)                 # high-resolution band table
        n_bands = t.n_high
        f_noise = np.asarray(t.f_noise)
        S = X.shape[0]

        def region(e_lo, e_hi, lo_k, hi_k):
            a = min(max(lo_slot + e_lo, 0), S)
            b = min(max(lo_slot + e_hi, 0), S)
            if b <= a or hi_k <= lo_k:
                return np.zeros((1, 1))
            return np.abs(X[a:b, lo_k:hi_k]) ** 2

        # adaptive FIXFIX envelope count from the high band's temporal
        # variation: stationary frames spend one envelope (and, per the
        # spec's amp_res rule, get 1.5 dB resolution for free), strong
        # transients get four 512-sample envelopes
        se = region(0, 32, kx, kx + m).mean(axis=1)
        if len(se) < 32:
            num_env = 1
        else:
            q8 = se.reshape(4, 8).mean(axis=1) + 1e-9
            var_db = 10.0 * np.log10(q8.max() / q8.min())
            num_env = 4 if var_db > 9.0 else (2 if var_db > 3.0 else 1)
        borders = {1: (0, 32), 2: (0, 16, 32),
                   4: (0, 8, 16, 24, 32)}[num_env]
        alpha = 1.0 if num_env > 1 else 0.5   # SBRFrameSpec.amp_res rule
        qmax = 63 if num_env > 1 else 127

        env_q = np.zeros((num_env, n_bands), np.int64)
        for e in range(num_env):
            for b in range(n_bands):
                p = region(borders[e], borders[e + 1],
                           int(ftab[b]), int(ftab[b + 1]))
                en = float(p.mean())
                env_q[e, b] = int(np.clip(
                    round((np.log2(en + 1e-9) - 6.0) / alpha), 0, qmax))
            # the freq-delta Huffman books cover +-31 (3.0 dB) / +-60
            # (1.5 dB); clamp adjacent jumps (a silent band next to a
            # loud one would otherwise leave the codebook)
            dmax = 31 if num_env > 1 else 60
            for b in range(1, n_bands):
                prev = int(env_q[e, b - 1])
                env_q[e, b] = int(np.clip(env_q[e, b],
                                          prev - dmax, prev + dmax))

        # noise floors + inverse filtering from flatness: target band vs
        # the patch source region (the low half below the crossover)
        src = region(0, 32, max(kx // 2, 1), kx)
        sfm_src = _flatness(src.reshape(-1))
        noise_q = np.zeros((2 if num_env > 1 else 1, t.n_q), np.int64)
        invf = []
        for b in range(t.n_q):
            lo_k, hi_k = int(f_noise[b]), int(f_noise[b + 1])
            p = region(0, 32, lo_k, hi_k)
            sfm_t = _flatness(p.reshape(-1))
            # noise-to-signal ratio: noisier targets get a higher floor
            q_lin = float(np.clip(3.0 * sfm_t, 0.02, 2.0))
            nq = int(np.clip(round(6.0 - np.log2(q_lin)), 0, 30))
            noise_q[:, b] = nq
            ratio = sfm_t / max(sfm_src, 1e-3)
            invf.append(2 if ratio > 4.0 else (1 if ratio > 1.2 else 0))

        return SBRFrameSpec(num_env=num_env, freq_res=1, invf=invf,
                            env_q=env_q, noise_q=noise_q)

    # -- Parametric Stereo extraction -----------------------------------------
    # parameter-band layouts: QMF band -> par band, derived from the
    # decoder's hybrid-channel map (ps_tables k_to_i_20; QMF bands 0-2
    # hold the hybrid-split low channels, approximated at QMF resolution)
    _PAR_OF_QMF: dict = {}

    @classmethod
    def _par_of_qmf(cls, nr: int = 10) -> np.ndarray:
        if nr not in cls._PAR_OF_QMF:
            from aacjax_torch.host import ps as psmod
            par = np.zeros(64, np.int64)
            if nr == 34:
                # hybrid-34 layout: QMF bands 0-4 split into 12/8/4/4/4
                # hybrid channels (32 total), QMF q>=5 -> channel
                # 32+(q-5); measurement at QMF resolution uses each
                # split band's middle channel as representative
                k34 = psmod.tables()["k_to_i_34"].astype(int)
                mid = (6, 16, 22, 26, 30)       # offsets 0/12/20/24/28
                for q in range(5):
                    par[q] = int(k34[mid[q]])
                for q in range(5, 64):
                    par[q] = int(k34[min(32 + q - 5, len(k34) - 1)])
            else:
                k20 = psmod.tables()["k_to_i_20"].astype(int)
                div = 2 if nr == 10 else 1
                par[0], par[1], par[2] = 0 // div, 4 // div, 6 // div
                for q in range(3, 64):
                    par[q] = int(k20[min(7 + q, len(k20) - 1)]) // div
            cls._PAR_OF_QMF[nr] = par
        return cls._PAR_OF_QMF[nr]

    def _ps_rows(self, L, R, par_of, nr, n_ipd, iid_db_table,
                 icc_rho_table):
        """One envelope's IID/ICC/IPD/OPD rows over a QMF slot range."""
        iid = np.zeros(nr, np.int64)
        icc = np.zeros(nr, np.int64)
        ipd = np.zeros(n_ipd, np.int64)
        opd = np.zeros(n_ipd, np.int64)
        use_phase = False
        for p in range(nr):
            sel = par_of == p
            el = float(np.sum(np.abs(L[:, sel]) ** 2)) + 1e-9
            er = float(np.sum(np.abs(R[:, sel]) ** 2)) + 1e-9
            db = 10.0 * np.log10(el / er)
            iid[p] = int(np.argmin(np.abs(iid_db_table - db))) - 7
            cross = complex(np.sum(L[:, sel] * np.conj(R[:, sel])))
            rho = float(np.real(cross)) / np.sqrt(el * er)
            icc[p] = int(np.argmin(np.abs(icc_rho_table - rho)))
            if p < n_ipd:
                # phase parameters (ps_extension 0): IPD = phase of L
                # against R, OPD = phase of L against the downmix; both
                # quantized to 8 steps of pi/4 (the decoder's grid)
                coh = abs(cross) / np.sqrt(el * er)
                if coh > 0.4 and abs(np.angle(cross)) > np.pi / 8:
                    use_phase = True
                ipd[p] = int(np.round(np.angle(cross)
                                      / (np.pi / 4.0))) % 8
                M = 0.5 * (L[:, sel] + R[:, sel])
                od = complex(np.sum(L[:, sel] * np.conj(M)))
                opd[p] = int(np.round(np.angle(od) / (np.pi / 4.0))) % 8
        # pars only reachable through the decoder's hybrid-split channels
        # have no QMF band mapped to them at this measurement resolution;
        # backfill from the nearest measured par so their sub-channels
        # inherit the local image instead of collapsing to center/
        # fully-decorrelated defaults (matters most in 34-band mode,
        # where pars 0-8 all live inside the lowest 5 QMF bands)
        meas = np.isin(np.arange(nr), par_of)
        if not meas.all():
            midx = np.where(meas)[0]
            for p in np.where(~meas)[0]:
                src = int(midx[np.argmin(np.abs(midx - p))])
                iid[p] = iid[src]
                icc[p] = icc[src]
                if p < n_ipd and src < n_ipd:
                    ipd[p] = ipd[src]
                    opd[p] = opd[src]
        return iid, icc, ipd, opd, use_phase

    def _ps_spec(self, Xl: np.ndarray, Xr: np.ndarray,
                 lo_slot: int) -> PSSpec:
        """Measure one frame's PS parameters from the stereo QMF planes;
        quantization inverts the decoder's tables exactly
        (iid_par_dequant / acos_icc_invq).  A fast-moving image (IID
        shift between half-frames) escalates to two envelopes."""
        from aacjax_torch.host.ps_decode import _tables
        t = _tables()
        iid_db_table = 20.0 * np.log10(
            np.maximum(t["iid_par_dequant"][:15], 1e-9))   # coarse region
        icc_rho_table = np.cos(t["acos_icc_invq"])          # descending
        nr = self._ps_nr
        mode = {10: 0, 20: 1, 34: 2}[nr]
        n_ipd = {10: 5, 20: 11, 34: 17}[nr]
        par_of = self._par_of_qmf(nr)
        S = Xl.shape[0]
        a = min(max(lo_slot, 0), S)
        b = min(max(lo_slot + SLOTS_PER_FRAME, 0), S)
        if b <= a:
            return PSSpec(iid_mode=mode, icc_mode=mode, num_env=1,
                          iid_par=np.zeros((1, nr), np.int64),
                          icc_par=np.zeros((1, nr), np.int64))
        half = (a + b) // 2
        rows = [self._ps_rows(Xl[lo:hi], Xr[lo:hi], par_of, nr, n_ipd,
                              iid_db_table, icc_rho_table)
                for lo, hi in ((a, half), (half, b))]
        # image motion: a >=3-step IID shift in any band between the
        # half-frames spends the second envelope
        two_env = bool(np.max(np.abs(rows[0][0] - rows[1][0])) >= 3)
        if two_env:
            iid = np.stack([rows[0][0], rows[1][0]])
            icc = np.stack([rows[0][1], rows[1][1]])
            ipd = np.stack([rows[0][2], rows[1][2]])
            opd = np.stack([rows[0][3], rows[1][3]])
            use_phase = rows[0][4] or rows[1][4]
            num_env = 2
        else:
            full = self._ps_rows(Xl[a:b], Xr[a:b], par_of, nr, n_ipd,
                                 iid_db_table, icc_rho_table)
            iid, icc = full[0][None], full[1][None]
            ipd, opd = full[2][None], full[3][None]
            use_phase = full[4]
            num_env = 1
        return PSSpec(iid_mode=mode, icc_mode=mode, num_env=num_env,
                      iid_par=iid, icc_par=icc,
                      ipd_par=ipd if use_phase else None,
                      opd_par=opd if use_phase else None)

    # -- public ---------------------------------------------------------------
    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """Encode PCM [n, channels] at the output rate to raw_data_block
        payloads with per-frame SBR FIL extensions (carrying ps_data in
        Parametric Stereo mode)."""
        pcm = np.asarray(pcm, np.float64).reshape(-1, self.in_channels)
        Xps = None
        ps_slot_shift = 0
        if self.ps:
            # v2: an ENERGY-EQUALIZED QMF-domain downmix carries the
            # waveform: m = (L+R)/2 scaled per band/slot so
            # |m|^2 tracks (|L|^2+|R|^2)/2 — anti-phase content keeps its
            # energy instead of cancelling (the passive-sum limit), and
            # the decoder's IID/ICC reconstruction restores the image.
            Xl = qmf_analysis64(pcm[:, 0])
            Xr = qmf_analysis64(pcm[:, 1])
            Xps = (Xl, Xr)
            M = 0.5 * (Xl + Xr)
            e_t = np.abs(Xl) ** 2 + np.abs(Xr) ** 2
            g = np.sqrt(e_t / (2.0 * np.abs(M) ** 2 + 1e-9))
            # boost-only, bounded (18 dB), smoothed over a few slots so
            # deep-null bins lift without fast gain modulation; in-phase
            # content passes through untouched
            g = np.clip(g, 1.0, 8.0)
            k = np.ones(4) / 4.0
            g = np.apply_along_axis(
                lambda v: np.convolve(v, k, "same"), 0, g)
            from aacjax_torch.host.sbr_decode import _qmf_synthesis_np
            from aacjax_torch.kernels import qmf as qmfmod
            m_t, _ = _qmf_synthesis_np(M * g,
                                       np.zeros((qmfmod.SYN_HIST, 128)))
            # the analysis->synthesis chain inverts sign and delays by
            # ~1128 samples; the SBR envelopes are measured from this
            # signal's own QMF plane (self-consistent), and the PS
            # parameter extraction shifts to match the coded timeline
            pcm = -m_t.reshape(-1, 1)
            ps_slot_shift = -18   # ~1128 samples / 64-sample slots
        core_pcm = _halfband_decimate(pcm)
        X = [qmf_analysis64(pcm[:, ch]) for ch in range(self.channels)]

        n_core = core_pcm.shape[0] // self.core.config.frame_length
        if core_pcm.shape[0] % self.core.config.frame_length:
            n_core += 1
        fils = []
        for f in range(n_core + 1):
            # core frame f decodes to original samples
            # [(f-1)*2048, f*2048) — the encoder's 1-frame delay
            lo_slot = (f - 1) * SLOTS_PER_FRAME
            specs = [self._frame_spec(X[ch], lo_slot)
                     for ch in range(self.channels)]
            psd = (self._ps_spec(Xps[0], Xps[1], lo_slot + ps_slot_shift)
                   if self.ps else None)
            fils.append(sbr_payload(specs, self.header, self.sample_rate,
                                    ps=psd))
        # the SBR side info comes out of the total budget: the FIL bytes
        # are known exactly before the core encode
        secs = max(pcm.shape[0] / self.sample_rate, 1e-9)
        sbr_bps = sum(len(p) + 2 for p in fils) * 8 / secs  # +FIL header
        self.core.bitrate = max(12_000 * self.channels,
                                int(self.bitrate - sbr_bps))
        # bitrate-derived state must track the deduction: the reservoir
        # cap (6x bitrate frames) was sized from the pre-deduction target
        # at construction and would let the core overshoot the total rate
        # (the bandwidth cutoff is NOT bitrate-derived here — it is set
        # explicitly from the SBR crossover above)
        self.core._reservoir_cap = (6.0 * self.core.bitrate
                                    * self.core._frame
                                    / self.core.sample_rate)
        return self.core.encode_frames(core_pcm, fil_payloads=fils)

    def encode(self, pcm: np.ndarray) -> bytes:
        """Encode PCM to an HE-AAC ADTS byte stream."""
        return b"".join(adts_frame(p, self.core.config)
                        for p in self.encode_frames(pcm))

    def encode_m4a(self, pcm: np.ndarray) -> bytes:
        """Encode PCM to a gapless HE-AAC .m4a: explicit hierarchical SBR
        signaling in the esds (AOT 5 with the core AOT/rate in the
        GASpecificConfig) plus edts/elst priming metadata at the output
        rate, so decode_m4a returns PCM aligned with the input."""
        from aacjax_torch.host.asc import make_asc
        from aacjax_torch.testing.mp4mux import mux_m4a
        pcm = np.asarray(pcm, np.float64).reshape(-1, self.in_channels)
        payloads = self.encode_frames(pcm)
        core_cfg = self.core.config
        asc = make_asc(2, core_cfg.sample_index, self.channels, sbr=True)
        return mux_m4a(payloads, asc, core_cfg.sample_rate, self.channels,
                       frame_length=core_cfg.frame_length,
                       priming=core_cfg.frame_length,
                       valid_samples=pcm.shape[0] // 2,
                       movie_ts=core_cfg.sample_rate)


def encode_he_adts(pcm: np.ndarray, sample_rate: int = 44100,
                   bitrate: int = 48_000) -> bytes:
    """One-call PCM -> HE-AAC v1 ADTS.  pcm [n] or [n, ch], 32768
    scale, at the (output) sample_rate."""
    pcm = np.asarray(pcm)
    ch = 1 if pcm.ndim == 1 else pcm.shape[1]
    return HEAACEncoder(sample_rate, ch, bitrate).encode(
        pcm.reshape(-1, ch))
