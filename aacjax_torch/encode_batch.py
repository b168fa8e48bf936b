"""Batched AAC-LC encoding: the analysis and the quantization on the
device, batched over streams; counterpart of `aacjax/encode_batch.py`.

Division of labour per chunk of S streams x nF frames:

  device (two programs covering all channel-frames at once):
    1. ANALYSIS (`_analysis_fn`): int16 PCM arrives once
       ([S*ch, nF*F + F]); the program builds the 50%-overlapped segments,
       runs the windowed forward MDCT as fp32 matrix products (long
       windows selected by plan index, EIGHT_SHORT through the 8 x S
       sub-products), band energies as products with the band matrix, ATH
       + directional psy spreading (the reference's two scans over the
       bands, one CUDA kernel on the card: kernels/enc_scans.py), the
       analytic base-scalefactor model refined by two measured-distortion
       quantization trials, and an exact book-11 Huffman cost (pair LUT +
       signs + escapes) over the static grid of rate offsets OFF_GRID ->
       est_bits [N, K] (the reference's scan over the offsets, one CUDA
       kernel on the card).
    2. QUANTIZE (`_quantize_fn`): mid-tread quantization at each
       channel-frame's chosen offset -> the coded region of q as int16
       [N, W] + per-band scalefactors int16 [N, nb].
  host (numpy, as in the reference):
    window-sequence planning, rate choice per frame from the est_bits
    grid + a per-stream bit reservoir, exact per-band codebook selection
    and bitstream writing (the native writer, native/libaacwrite.so, or
    the Python writer it is byte-identical to).

The reference's one-hot matrix products (a TPU form of a gather) are
gathers here, and its per-band slice maxima one scatter max: both exact.
Its matrix products run in full fp32 (TF32 is off, set when the package is
imported).  The sums, `pow`, `exp2` and `log2` may round differently from
XLA's in the last bit, and a `floor` can turn that into a one-step
difference in a scalefactor or a quantized value;
tests/test_torch_encode_batch.py measures how often.

On the card both run as the reference runs them, compiled:
`_jitted_analysis` and `_jitted_quantize` capture each once per
configuration, shapes and device as a CUDA graph and replay it
(runtime/graphs.py).

Several devices (`mesh=`, runtime/mesh.py): both programs are row-local,
so each 'stream' shard encodes its equal block of channel rows on its
device; the rate choice stays one host pass over the gathered estimates.

Quality scope: sine windows, long/short switching with the [8] grouping,
independent L/R (no M/S), TNS/PNS/IS off; the per-stream `AACEncoder`
remains the quality-first path, this is the high-throughput serving
encoder.  Output is standard AAC-LC.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import os
import threading
import time

import numpy as np
import torch

from aacjax_torch import tables
from aacjax_torch.encode import (EIGHT_SHORT, PsyParams,
                                 _analysis_matrix_cached, _ath_energy,
                                 bands_books_and_bits,
                                 detect_transients, window_sequence_plan)
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.kernels import _build, enc_scans
from aacjax_torch.runtime import graphs
from aacjax_torch.runtime import mesh as meshlib

FRAME = 1024

# rate-offset grid the device costs in one pass (bits are nonincreasing
# along the grid: higher offset -> coarser quantization)
OFF_GRID = np.array([-48, -36, -24, -16, -10, -6, -3, 0, 3, 7, 11,
                     16, 22, 30, 40, 52], np.float32)


# ---------------------------------------------------------------------------
# static per-config arrangements
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _arrangement(sample_index: int, cutoff_bin: int, frame: int = FRAME):
    """Band matrices, per-bin band maps and gather layouts for one
    sample-rate config.  Long bands are the contiguous swb runs up to
    the cutoff; short uses ONE group of 8 windows, so band sfb spans the
    interleaved union {w*S + [a, b)} (a static gather ordering makes it
    contiguous for the host's codebook pass)."""
    cfg = parse_asc(make_asc(2, sample_index, 1, frame_length=frame))
    off_l = np.asarray(cfg.swb_offsets_long, np.int64)
    off_s = np.asarray(cfg.swb_offsets_short, np.int64)
    max_sfb_l = int(np.searchsorted(off_l, cutoff_bin, "left"))
    max_sfb_l = min(max(max_sfb_l, 1), cfg.swb_count_long)
    S = frame // 8
    max_sfb_s = int(np.searchsorted(off_s, cutoff_bin // 8, "left"))
    max_sfb_s = min(max(max_sfb_s, 1), cfg.swb_count_short)
    nb = max(max_sfb_l, max_sfb_s)

    def band_matrix(offsets, n_bands, stride, n_rep):
        m = np.zeros((frame, nb), np.float32)
        for b in range(n_bands):
            a, e = int(offsets[b]), int(offsets[b + 1])
            for w in range(n_rep):
                m[w * stride + a: w * stride + e, b] = 1.0
        return m

    bm_l = band_matrix(off_l, max_sfb_l, frame, 1)
    bm_s = band_matrix(off_s, max_sfb_s, S, 8)

    def bin_band(bm):
        idx = np.full(frame, nb, np.int64)
        for b in range(bm.shape[1]):
            idx[bm[:, b] > 0] = b
        return idx

    gidx_s: list[int] = []
    ptr_s = [0]
    for b in range(max_sfb_s):
        a, e = int(off_s[b]), int(off_s[b + 1])
        for w in range(8):
            gidx_s.extend(range(w * S + a, w * S + e))
        ptr_s.append(len(gidx_s))
    ptr_l = off_l[: max_sfb_l + 1].astype(np.int64)

    def pad(a, fill):
        out = np.full(nb, fill, np.float32)
        out[: len(a)] = a
        return out

    ath_l = _ath_energy(off_l[: max_sfb_l + 1], cfg.sample_rate,
                        frame, frame)
    ath_s = 8.0 * _ath_energy(off_s[: max_sfb_s + 1], cfg.sample_rate,
                              S, S)   # energies sum over the 8 windows
    return dict(
        cfg=cfg, nb=nb, max_sfb_l=max_sfb_l, max_sfb_s=max_sfb_s,
        bm_l=bm_l, bm_s=bm_s,
        bb_l=bin_band(bm_l), bb_s=bin_band(bm_s),
        gidx_s=np.asarray(gidx_s, np.int64),
        ptr_s=np.asarray(ptr_s, np.int64), ptr_l=ptr_l,
        ath_l=pad(ath_l, 1e30), ath_s=pad(ath_s, 1e30),
        coded_l=np.arange(nb) < max_sfb_l,
        coded_s=np.arange(nb) < max_sfb_s,
    )


@functools.lru_cache(maxsize=None)
def _long_windows(frame: int = FRAME):
    """[3, 2F] windowed-analysis vectors for ONLY_LONG / LONG_START /
    LONG_STOP (sine shape), matching AACEncoder._window_long."""
    F = frame
    S = F // 8
    MID = (F - S) // 2
    rise = tables.long_window(0, F)
    srise = tables.short_window(0, S)
    w_only = np.concatenate([rise, rise[::-1]])
    w_start = np.concatenate([rise, np.ones(MID), srise[::-1],
                              np.zeros(MID)])
    w_stop = np.concatenate([np.zeros(MID), srise, np.ones(MID),
                             rise[::-1]])
    return np.stack([w_only, w_start, w_stop]).astype(np.float32)



# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------
@_build.per_device
def _analysis_fn(sample_index: int, cutoff_bin: int, frame: int,
                 n_frames: int, psy_key: tuple,
                 device: torch.device):
    """The analysis program for one configuration and chunk length, its
    constants on `device`: a function of (pcm_i16 [B, nF*F + F] int16,
    w_idx [B, nF] int64 in {0, 1, 2}, is_short [B, nF] bool), tensors on
    `device`, returning (coefs [N, F], base [N, nb], fit_sf [N, nb],
    est [N, K] f32, bin_band [N, F] int64) with N = B * nF, row
    n = b * nF + f."""
    arr = _arrangement(sample_index, cutoff_bin, frame)
    F = frame
    S = F // 8
    MID = (F - S) // 2
    nb = arr["nb"]

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    A_l = on_dev(_analysis_matrix_cached(2 * F).astype(np.float32))
    A_s = on_dev(_analysis_matrix_cached(2 * S).astype(np.float32))
    wins_l = on_dev(_long_windows(frame))
    srise = tables.short_window(0, S)
    win_s = on_dev(np.concatenate([srise, srise[::-1]]).astype(np.float32))
    smr_db, up_db, down_db = psy_key
    up = float(np.float32(10.0 ** (-up_db / 10.0)))
    down = float(np.float32(10.0 ** (-down_db / 10.0)))
    smr = float(np.float32(10.0 ** (-smr_db / 10.0)))

    bm_l, bm_s = on_dev(arr["bm_l"]), on_dev(arr["bm_s"])
    bb_l = on_dev(arr["bb_l"], torch.int64)
    bb_s = on_dev(arr["bb_s"], torch.int64)
    in_l = on_dev(arr["bb_l"] < nb)
    in_s = on_dev(arr["bb_s"] < nb)
    ath_l, ath_s = on_dev(arr["ath_l"]), on_dev(arr["ath_s"])
    coded_l = on_dev(arr["coded_l"], torch.bool)
    coded_s = on_dev(arr["coded_s"], torch.bool)

    # coded-region extents (both multiples of 4, so Huffman pairs and
    # quads never straddle the slice boundaries)
    cut_l = int(arr["ptr_l"][-1])
    cut_s = int(arr["cfg"].swb_offsets_short[arr["max_sfb_s"]])
    Pe = max(cut_l, 8 * cut_s)
    # band of each coded-region bin (nb: padding, or a bin past the
    # cutoff), long rows' then short rows'
    regions = on_dev(np.stack([
        np.concatenate([np.asarray(arr["bb_l"])[:cut_l],
                        np.full(Pe - cut_l, nb, np.int64)]),
        np.concatenate([
            np.asarray(arr["bb_s"]).reshape(8, S)[:, :cut_s].reshape(-1),
            np.full(Pe - 8 * cut_s, nb, np.int64)])]), torch.int64)
    offsets = tuple(OFF_GRID.tolist())
    log2_8191 = float((4.0 / 3.0) * np.log2(8191.0))
    log2_zero = float((4.0 / 3.0) * np.log2(0.5946))

    def quant(x, sf_bin):
        gain = torch.exp2((sf_bin - 100.0) * 0.25)
        c = torch.floor(torch.pow(x.abs() / gain, 0.75) + 0.4054)
        return torch.sign(x) * torch.clamp(c, max=8191.0)

    def recon(q, sf_bin):
        return (torch.sign(q) * torch.pow(q.abs(), 4.0 / 3.0)
                * torch.exp2((sf_bin - 100.0) * 0.25))

    def with_fill(v, fill):
        return torch.cat([v, v.new_full((v.shape[0], 1), fill)], dim=1)

    def analysis(pcm_i16, w_idx, is_short):
        B = pcm_i16.shape[0]
        x = pcm_i16.to(torch.float32)
        first = x[:, : n_frames * F].reshape(B, n_frames, F)
        second = x[:, F:].reshape(B, n_frames, F)
        N = B * n_frames
        seg = torch.cat([first, second], dim=2).reshape(N, 2 * F)
        w_idx = w_idx.reshape(N)
        sel = is_short.reshape(N)[:, None]

        coefs_l = torch.matmul(seg * wins_l[w_idx], A_l)          # [N, F]
        # the 8 short sub-windows overlap by S: two strided views
        y = seg[:, MID: MID + 9 * S]
        subs = torch.cat([y[:, : 8 * S].reshape(N, 8, S),
                          y[:, S:].reshape(N, 8, S)], dim=2)       # [N, 8, 2S]
        coefs_s = torch.matmul(subs * win_s, A_s).reshape(N, F)
        coefs = torch.where(sel, coefs_s * in_s, coefs_l * in_l)
        bin_band = torch.where(sel, bb_s, bb_l)                    # [N, F]

        def band_reduce(v):                                        # [N,F]->[N,nb]
            return torch.where(sel, v @ bm_s, v @ bm_l)

        e = band_reduce(coefs * coefs)
        ath = torch.where(sel, ath_s, ath_l)
        thr = torch.maximum(enc_scans.spread(e, up, down, smr), ath)
        coded = torch.where(sel, coded_s, coded_l)

        absc = coefs.abs()
        # per-band max magnitude: one scatter max over each row's bin->band
        # map (bins past the cutoff land in the dropped column nb); |c| >= 0,
        # so the zero start is the reference's max over an empty band
        m = absc.new_zeros((N, nb + 1)).scatter_reduce_(
            1, bin_band, absc, "amax")[:, :nb]
        lg = torch.log2(torch.clamp(m, min=1e-30))
        fit_sf = torch.clamp(torch.ceil(100.0 + 4.0 * (lg - log2_8191)),
                             min=0.0)
        zero_sf = torch.ceil(100.0 + 4.0 * (lg - log2_zero))
        sq = band_reduce(torch.sqrt(absc))
        g_t = torch.pow(thr / torch.clamp(0.1481 * sq, min=1e-30), 2.0 / 3.0)
        base = torch.floor(100.0 + 4.0 * torch.log2(
            torch.clamp(g_t, min=1e-30)))
        base = torch.clamp(base, fit_sf, zero_sf)

        for _ in range(2):                                         # quant trials
            sfx = with_fill(base, 255.0).gather(1, bin_band)
            q = quant(coefs, sfx)
            d = band_reduce((coefs - recon(q, sfx)) ** 2)
            over = d > thr
            step = torch.ceil(torch.log2(
                torch.clamp(d / thr, min=1.0)) / 0.375)
            base = torch.clamp(
                base - torch.where(over, torch.clamp(step, min=1.0), 0.0),
                fit_sf, zero_sf)
        base = torch.where(coded, base, 255.0)

        # --- rate-offset cost grid: exact book-11 cost (pair LUT + signs +
        # escapes) over the nonzero bands of the coded region, plus ~6
        # bits a coded band of side info; see the reference's notes
        ce_l = torch.nn.functional.pad(coefs[:, :cut_l], (0, Pe - cut_l))
        ce_s = torch.nn.functional.pad(
            coefs.reshape(N, 8, S)[:, :, :cut_s].reshape(N, 8 * cut_s),
            (0, Pe - 8 * cut_s))
        t34 = torch.pow(torch.where(sel, ce_s, ce_l).abs(), 0.75)  # [N, Pe]
        est = enc_scans.rate_cost(t34, is_short.reshape(N), regions, base,
                                  fit_sf, zero_sf, offsets)
        return coefs, base, fit_sf, est, bin_band

    return analysis


def _quantize_fn(w8: int = FRAME // 8):
    """The quantize program; w8 is the coded-region width per short
    sub-block, and the packed width is W = 8 * w8 (<= FRAME).  Bins beyond
    the rate cutoff are never written to the bitstream, so only the coded
    region crosses to the host: long rows ship their flat prefix [:W],
    short rows the per-128-bin-block prefixes [:, :, :w8]
    (BatchEncoder._unpack_q re-expands them)."""
    S8 = FRAME // 8
    W = 8 * w8

    def fn(coefs, base, fit_sf, bin_band, off, is_short_row):
        """Quantize at the chosen per-channel-frame offset -> (packed q
        int16 [N, W], per-band sf int16 [N, nb])."""
        N = coefs.shape[0]
        sfb = torch.maximum(base + off[:, None], fit_sf).clamp_(max=255.0)
        sf_bin = torch.cat([sfb, sfb.new_full((N, 1), 255.0)],
                           dim=1).gather(1, bin_band)
        gain = torch.exp2((sf_bin - 100.0) * 0.25)
        c = torch.floor(torch.pow(coefs.abs() / gain, 0.75) + 0.4054)
        q = (torch.sign(coefs) * torch.clamp(c, max=8191.0)).to(torch.int16)
        if W >= FRAME:
            return q, sfb.to(torch.int16)
        q_long = q[:, :W]
        q_short = q.reshape(N, 8, S8)[:, :, :w8].reshape(N, W)
        packed = torch.where(is_short_row[:, None], q_short, q_long)
        return packed, sfb.to(torch.int16)

    return fn


@functools.lru_cache(maxsize=None)
def _jitted_analysis(sample_index: int, cutoff_bin: int, frame: int,
                     n_frames: int, psy_key: tuple) -> graphs.Program:
    """The analysis program compiled as the reference's `_jitted_analysis`:
    fn(pcm_i16, w_idx, is_short) on one device, a CUDA graph per key on the
    card (runtime/graphs.py), the eager program on CPU tensors."""
    def fn(pcm_i16, w_idx, is_short):
        return _analysis_fn(sample_index, cutoff_bin, frame, n_frames,
                            psy_key, pcm_i16.device)(pcm_i16, w_idx, is_short)
    return graphs.Program("encode_analysis", fn,
                          (sample_index, cutoff_bin, frame, n_frames, psy_key))


@functools.lru_cache(maxsize=None)
def _jitted_quantize(w8: int = FRAME // 8) -> graphs.Program:
    """The quantize program compiled as the reference's `_jitted_quantize`
    (keyed by w8; the reference's one-hot form, which its other keys
    select, is a gather here in every case)."""
    return graphs.Program("encode_quantize", _quantize_fn(w8), (w8,))


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------
class BatchEncoder:
    """Encodes S concurrent same-config AAC-LC streams with the analysis
    and the quantization on `device` ("cuda" unless the caller passes
    "cpu"; a CUDA request without CUDA raises), or, with `mesh`, on the
    first device of each of its 'stream' shards, which take equal blocks of
    the S * channels rows (an uneven split raises ValueError).  See the
    module docstring for the device/host split and the quality scope."""

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: int = 128_000, n_streams: int = 1,
                 cutoff_hz: float | None = None,
                 device: str | torch.device = "cuda", mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.device = _build.indexed(self.device)
        self.mesh = mesh
        # where the programs run: each stream shard's first device and its
        # block of channel rows (one block on `device` without a mesh)
        grid = mesh if mesh is not None else meshlib.Mesh([[self.device]])
        if {d.type for d in grid.device_set} != {self.device.type}:
            raise ValueError(f"mesh on {grid.device_set} for an encoder on "
                             f"{self.device.type}")
        if (n_streams * channels) % grid.shape["stream"]:
            raise ValueError(
                f"{n_streams} streams x {channels} ch = "
                f"{n_streams * channels} channel rows do not split "
                f"over {grid.shape['stream']} 'stream' shards")
        self._grid = grid
        self._blocks = meshlib._row_sharding(grid, n_streams * channels)
        si = int(np.argmin(np.abs(
            tables.SAMPLE_RATES[:12].astype(np.int64) - sample_rate)))
        if int(tables.SAMPLE_RATES[si]) != sample_rate:
            raise ValueError(f"unsupported sample rate {sample_rate}")
        self.config = parse_asc(make_asc(2, si, channels))
        self.sample_rate = sample_rate
        self.channels = channels
        self.bitrate = bitrate
        self.S = n_streams
        per_ch = bitrate / channels
        if cutoff_hz is None:
            cutoff_hz = min(0.45 * sample_rate,
                            4000.0 + per_ch * 0.12, 20000.0)
        self._cutoff_bin = int(min(cutoff_hz, 0.5 * sample_rate)
                               / (sample_rate / 2.0) * FRAME)
        self._cutoff_bin -= self._cutoff_bin % 2
        self._si = si
        self._arr = _arrangement(si, self._cutoff_bin)
        self._psy = PsyParams()
        # packed q D2H width: only the coded region (bins below the rate
        # cutoff) crosses to the host; see _quantize_fn
        cut_l = int(self._arr["ptr_l"][-1])
        cut_s = int(self._arr["cfg"].swb_offsets_short[
            self._arr["max_sfb_s"]])
        self._w8 = min(max(-(-cut_l // 8), cut_s), FRAME // 8)
        self._quantize = _jitted_quantize(self._w8)
        self._reservoir = np.zeros(n_streams)
        self._res_cap = 6.0 * bitrate * FRAME / sample_rate
        # online calibration of the device bit estimate against bits
        # actually written (the exact multi-book host pass undercuts the
        # book-11 estimate by ~25-40% depending on content)
        self._est_ratio = np.full(n_streams, 0.7)
        self._carry = None   # [S, F, ch] 1-frame lookahead across chunks
        self._prev_seq = np.zeros(n_streams, np.int64)
        # native multi-threaded bitstream writer (byte-identical to
        # _write_stream; AACJAX_NATIVE_WRITE=0 reverts to Python)
        from aacjax_torch.host import native_write
        self._native_write = (
            os.environ.get("AACJAX_NATIVE_WRITE", "1") == "1"
            and native_write.available())
        # per-stage accounting (seconds on the host's clock, each stage
        # ended by a synchronisation with the device):
        #   h2d_s       PCM upload
        #   analysis_s  analysis launch -> est ready, and the quantize
        #               launch -> q/sf ready
        #   d2h_s       est + packed q/sf downloads
        #   host_s      window plan / rate choice / unpack
        #   write_s     bitstream write
        self.stats = dict(h2d_s=0.0, analysis_s=0.0, d2h_s=0.0,
                          host_s=0.0, write_s=0.0, frames=0)
        self._stats_lock = threading.Lock()

    # -- plan ---------------------------------------------------------------
    def _plan(self, full: np.ndarray, nF: int) -> np.ndarray:
        """Window-sequence plan per stream over this chunk's frames,
        continuing the previous chunk's chain legally."""
        seqs = np.zeros((self.S, nF), np.int64)
        for s in range(self.S):
            tr = np.zeros((nF, 2), np.int64)
            for c in range(self.channels):
                t_c = detect_transients(full[s, :, c], FRAME)
                # window f's new (right) half is full frame f+1
                n = min(len(t_c) - 1, nF)
                tr[:n, 0] |= t_c[1:n + 1, 0]
            plan = window_sequence_plan(tr)[:nF]
            # legal continuation across the chunk boundary: a frame's
            # left half must mirror its predecessor's right half
            prev = self._prev_seq[s]
            short_tail = prev in (1, EIGHT_SHORT)   # right half is short
            if short_tail and plan[0] == 0:
                plan[0] = 3                          # ONLY_LONG -> STOP
            elif short_tail and plan[0] == 1:
                plan[0] = EIGHT_SHORT                # START -> SHORT
            elif not short_tail and plan[0] == EIGHT_SHORT:
                plan[0] = 1                          # SHORT -> START
            elif not short_tail and plan[0] == 3:
                plan[0] = 0                          # STOP -> ONLY_LONG
            self._prev_seq[s] = plan[-1]
            seqs[s] = plan
        return seqs

    # -- encode -------------------------------------------------------------
    def _prep_chunk(self, pcm: np.ndarray):
        """Host stage: window-sequence plan + channel-major int16 PCM
        rows (b = s*ch + c; n = b*nF + f) for this chunk.  Mutates the
        1-frame carry and the window-chain state, so calls must stay in
        chunk order."""
        S_, n, ch = pcm.shape
        assert S_ == self.S and ch == self.channels and n % FRAME == 0
        F, nF = FRAME, n // FRAME
        if self._carry is None:
            self._carry = np.zeros((self.S, F, ch), pcm.dtype)
        full = np.concatenate([self._carry, pcm], axis=1)
        self._carry = full[:, -F:].copy()
        seqs = self._plan(full, nF)                        # [S, nF]
        pcm_i16 = np.clip(np.round(full.transpose(0, 2, 1)), -32768,
                          32767).astype(np.int16).reshape(
            self.S * ch, n + F)
        w_map = {0: 0, 1: 1, EIGHT_SHORT: 0, 3: 2}
        w_idx = np.vectorize(w_map.get)(seqs).astype(np.int32)
        w_idx = np.repeat(w_idx[:, None, :], ch, axis=1).reshape(
            self.S * ch, nF)
        is_short = np.repeat((seqs == EIGHT_SHORT)[:, None, :], ch,
                             axis=1).reshape(self.S * ch, nF)
        return seqs, pcm_i16, w_idx, is_short, nF

    def _rate_choice(self, est_np: np.ndarray, nF: int):
        """Rate choice: finest grid offset whose estimated bits fit the
        frame budget (+ per-stream reservoir).  The estimate is the
        exact book-11 cost, a slight overestimate vs the host's final
        multi-book selection — errors land on the safe side and the
        reservoir absorbs them.  Mutates the reservoir, so calls must
        stay in chunk order."""
        ch = self.channels
        overhead = 60.0
        bits_frame = self.bitrate * FRAME / self.sample_rate
        est_sf = (est_np.reshape(self.S, ch, nF, -1).sum(axis=1)
                  * self._est_ratio[:, None, None])
        off_idx = np.empty((self.S, nF), np.int64)
        chosen_est = np.zeros(self.S)
        for f in range(nF):
            budget = (bits_frame - overhead
                      + np.minimum(self._reservoir, bits_frame))
            fits = est_sf[:, f] <= budget[:, None]
            idx = np.where(fits.any(axis=1), np.argmax(fits, axis=1),
                           len(OFF_GRID) - 1)
            off_idx[:, f] = idx
            used = est_sf[np.arange(self.S), f, idx] + overhead
            chosen_est += used
            self._reservoir = np.clip(
                self._reservoir + bits_frame - used, 0.0, self._res_cap)
        off = OFF_GRID[np.repeat(off_idx[:, None, :], ch, axis=1)
                       .reshape(-1)]
        return off, chosen_est

    def _unpack_q(self, packed: np.ndarray, is_short_flat: np.ndarray
                  ) -> np.ndarray:
        """Re-expand packed coded-region q rows to [N, FRAME] (zeros
        beyond the coded region, which the writer never reads) — the
        host inverse of _quantize_fn's device packing."""
        W = 8 * self._w8
        if W >= FRAME:
            return packed
        N = packed.shape[0]
        q = np.zeros((N, FRAME), np.int16)
        m = is_short_flat
        q[~m, :W] = packed[~m]
        if m.any():
            tmp = np.zeros((int(m.sum()), 8, FRAME // 8), np.int16)
            tmp[:, :, : self._w8] = packed[m].reshape(-1, 8, self._w8)
            q[m] = tmp.reshape(-1, FRAME)
        return q

    def _write_out(self, seqs, q, sf, chosen_est) -> list[list[bytes]]:
        """Bitstream write + online calibration of the device bit
        estimate against bits actually written."""
        if self._native_write:
            from aacjax_torch.host import native_write
            arr = self._arr
            out = native_write.write_lc_batch(
                seqs, q, sf, arr["ptr_l"],
                arr["cfg"].swb_offsets_short[: arr["max_sfb_s"] + 1],
                arr["max_sfb_l"], arr["max_sfb_s"])
        else:
            out = [self._write_stream(seqs[s], q[s], sf[s])
                   for s in range(self.S)]
        actual = np.array([8.0 * sum(len(p) for p in o) for o in out])
        ratio = actual / np.maximum(chosen_est, 1.0)
        self._est_ratio = np.clip(self._est_ratio * ratio, 0.35, 1.2)
        return out

    # -- device stages --------------------------------------------------------
    # `streams` maps each device to the CUDA stream the stage queues on
    # (None on the CPU); every stage runs each row block on its own device.
    def _psy_key(self) -> tuple:
        return (self._psy.smr_db, self._psy.spread_up_db,
                self._psy.spread_down_db)

    def _analysis_for(self, nF: int):
        """The compiled analysis program for this chunk length
        (_jitted_analysis)."""
        return _jitted_analysis(self._si, self._cutoff_bin, FRAME, nF,
                                self._psy_key())

    def _analysis_blocks(self, nF: int):
        """The analysis programs for this chunk length, one a row block on
        its device: a function of lists of the blocks' inputs."""
        return meshlib.sharded_encode_analysis(
            self._si, self._cutoff_bin, FRAME, nF, self._psy_key(),
            self._grid)

    def _new_streams(self):
        return ({d: torch.cuda.Stream(d) for d in self._grid.row_devices}
                if self.device.type == "cuda" else None)

    def _sync(self, streams) -> None:
        """Wait for the work queued on `streams` (a CUDA event recorded on
        each, then waited on); nothing to wait for on the CPU."""
        for stream in (streams or {}).values():
            ev = torch.cuda.Event()
            ev.record(stream)
            ev.synchronize()

    def _upload(self, pcm_i16, w_idx, is_short, streams) -> list:
        """Each row block's host arrays -> tensors on its device through
        pinned staging buffers; returns before the copies end on CUDA.
        Returns the three lists of the blocks' tensors."""
        out = ([], [], [])
        for (lo, hi), dev in zip(self._blocks, self._grid.row_devices):
            for lst, a in zip(out, (pcm_i16, w_idx.astype(np.int64),
                                    is_short)):
                t = torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                if streams is not None:
                    t = t.pin_memory().to(dev, non_blocking=True)
                lst.append(t)
        return list(out)

    def _to_host(self, tensors, streams) -> list[np.ndarray]:
        """Device tensors -> numpy through pinned buffers, on `streams`,
        waited for with events."""
        if streams is None:
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        self._sync(streams)
        return [h.numpy() for h in host]

    def _on(self, streams):
        stack = contextlib.ExitStack()
        for stream in (streams or {}).values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _analysis_stage(self, pcm_i16, w_idx, is_short, nF, streams):
        """H2D + analysis + est D2H of every row block on `streams`.
        Returns the blocks' device outputs, est as numpy (the blocks' in
        row order) and the three stage times.  The host has waited for the
        analysis to end, so the outputs can be read on any stream."""
        analysis = self._analysis_blocks(nF)
        with self._on(streams):
            t0 = time.perf_counter()
            dev = self._upload(pcm_i16, w_idx, is_short, streams)
            self._sync(streams)
            t1 = time.perf_counter()
            outs = analysis(*dev)
            self._sync(streams)
            t2 = time.perf_counter()
            est_np = np.concatenate(self._to_host([o[3] for o in outs],
                                                  streams))
            t3 = time.perf_counter()
        return outs, est_np, (t1 - t0, t2 - t1, t3 - t2)

    def _quantize_stage(self, outs, off, short_flat, streams):
        """Quantize launch + q/sf D2H of every row block on `streams`.
        Returns (packed q, sf, quantize time, D2H time), rows in order."""
        nF = len(off) // self._blocks[-1][1]
        with self._on(streams):
            t0 = time.perf_counter()
            offs, shorts = [], []
            for (lo, hi), o in zip(self._blocks, outs):
                dev = o[0].device
                offs.append(torch.from_numpy(off[lo * nF:hi * nF]).to(dev))
                shorts.append(torch.from_numpy(
                    short_flat[lo * nF:hi * nF]).to(dev))
            res = meshlib.sharded_encode_quantize(self._grid, self._w8)(
                outs, offs, shorts)
            self._sync(streams)
            t1 = time.perf_counter()
            host = self._to_host([t for qs in res for t in qs], streams)
            t2 = time.perf_counter()
        q_packed = np.concatenate(host[0::2])
        sf = np.concatenate(host[1::2])
        return q_packed, sf, t1 - t0, t2 - t1

    # -- encode -------------------------------------------------------------
    def encode_chunk(self, pcm: np.ndarray) -> list[list[bytes]]:
        """pcm [S, n_samples, channels] float (reference 32768 scale),
        n_samples a multiple of 1024.  Returns per-stream
        raw_data_block payload lists (wrap with
        testing.encoder.adts_frame for ADTS)."""
        t0 = time.perf_counter()
        seqs, pcm_i16, w_idx, is_short, nF = self._prep_chunk(pcm)
        self.stats["host_s"] += time.perf_counter() - t0

        streams = ({d: torch.cuda.current_stream(d)
                    for d in self._grid.row_devices}
                   if self.device.type == "cuda" else None)
        outs, est_np, (h2d, ana, d2h) = self._analysis_stage(
            pcm_i16, w_idx, is_short, nF, streams)
        self.stats["h2d_s"] += h2d
        self.stats["analysis_s"] += ana
        self.stats["d2h_s"] += d2h

        t0 = time.perf_counter()
        off, chosen_est = self._rate_choice(est_np, nF)
        self.stats["host_s"] += time.perf_counter() - t0

        short_flat = is_short.reshape(-1)
        q_packed, sf, qs, d2h = self._quantize_stage(outs, off, short_flat,
                                                     streams)
        self.stats["analysis_s"] += qs
        self.stats["d2h_s"] += d2h
        t0 = time.perf_counter()
        q = self._unpack_q(q_packed, short_flat).reshape(
            self.S, self.channels, nF, FRAME)
        sf = sf.reshape(self.S, self.channels, nF, -1)
        self.stats["host_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        out = self._write_out(seqs, q, sf, chosen_est)
        self.stats["write_s"] += time.perf_counter() - t0
        self.stats["frames"] += self.S * nF
        return out

    def encode_pipelined(self, pcm_iter, duplex: bool | None = None):
        """Generator encoding an iterator of [S, n, ch] PCM chunks as a
        3-stage pipeline, the encode mirror of
        runtime.batch.BatchDecoder.decode_pipelined:

            main thread : window plan + i16 prep, chunk k
            up worker   : H2D + analysis + est D2H, chunk k-1 (its own
                          CUDA stream)
            down worker : rate choice -> quantize -> q/sf D2H
                          -> bitstream write, chunk k-2 (its own stream)

        Both workers are single-threaded, so the reservoir and the
        estimate calibration update in chunk order: outputs are
        byte-identical to sequential encode_chunk calls.  `duplex` is
        accepted for the reference's signature and ignored: a GPU copies
        host->device and device->host on separate engines, so nothing
        needs to keep the two transfers apart.  Yields per-stream payload
        lists in chunk order."""
        up_pool = concurrent.futures.ThreadPoolExecutor(1)
        down_pool = concurrent.futures.ThreadPoolExecutor(1)
        up_stream, down_stream = self._new_streams(), self._new_streams()

        def upload_analysis(pcm_i16, w_idx, is_short, nF):
            outs, est_np, (h2d, ana, d2h) = self._analysis_stage(
                pcm_i16, w_idx, is_short, nF, up_stream)
            with self._stats_lock:
                self.stats["h2d_s"] += h2d
                self.stats["analysis_s"] += ana
                self.stats["d2h_s"] += d2h
            return outs, est_np

        def rate_quant_write(seqs, outs, est_np, nF, short_flat):
            t0 = time.perf_counter()
            off, chosen_est = self._rate_choice(est_np, nF)
            t1 = time.perf_counter()
            q_packed, sf, qs, d2h = self._quantize_stage(
                outs, off, short_flat, down_stream)
            t2 = time.perf_counter()
            q = self._unpack_q(q_packed, short_flat).reshape(
                self.S, self.channels, nF, FRAME)
            sf = sf.reshape(self.S, self.channels, nF, -1)
            t3 = time.perf_counter()
            out = self._write_out(seqs, q, sf, chosen_est)
            t4 = time.perf_counter()
            with self._stats_lock:
                self.stats["host_s"] += (t1 - t0) + (t3 - t2)
                self.stats["analysis_s"] += qs
                self.stats["d2h_s"] += d2h
                self.stats["write_s"] += t4 - t3
                self.stats["frames"] += self.S * nF
            return out

        def advance(up_fut, down_fut, pend):
            """Move the finished upload into the down worker, yielding
            the previous down result first to keep one chunk in each
            stage."""
            outs, est_np = up_fut.result()
            prev = down_fut.result() if down_fut is not None else None
            nxt = down_pool.submit(rate_quant_write, pend[0], outs,
                                   est_np, pend[1], pend[2])
            return prev, nxt

        up_fut = down_fut = None
        pend = None   # (seqs, nF, short_flat) for the upload-stage chunk
        try:
            for pcm in pcm_iter:
                t0 = time.perf_counter()
                seqs, pcm_i16, w_idx, is_short, nF = self._prep_chunk(
                    pcm)
                with self._stats_lock:
                    self.stats["host_s"] += time.perf_counter() - t0
                if up_fut is not None:
                    prev, down_fut = advance(up_fut, down_fut, pend)
                    if prev is not None:
                        yield prev
                up_fut = up_pool.submit(upload_analysis, pcm_i16,
                                        w_idx, is_short, nF)
                pend = (seqs, nF, is_short.reshape(-1))
            if up_fut is not None:
                prev, down_fut = advance(up_fut, down_fut, pend)
                if prev is not None:
                    yield prev
            if down_fut is not None:
                yield down_fut.result()
        finally:
            up_pool.shutdown(wait=True)
            down_pool.shutdown(wait=True)

    # -- bitstream ----------------------------------------------------------
    def _write_stream(self, seqs, q, sf) -> list[bytes]:
        from aacjax_torch.host.bitio import BitWriter
        from aacjax_torch.testing.encoder import (ChannelSpec, CPESpec,
                                                  end_frame, write_cpe,
                                                  write_sce)
        arr = self._arr
        payloads = []
        for f in range(len(seqs)):
            seq = int(seqs[f])
            short = seq == EIGHT_SHORT
            max_sfb = arr["max_sfb_s"] if short else arr["max_sfb_l"]
            ptr = arr["ptr_s"] if short else arr["ptr_l"]
            specs = []
            for c in range(self.channels):
                row = q[c, f].astype(np.int64)
                flat = row[arr["gidx_s"]] if short else row[: ptr[-1]]
                books, _ = bands_books_and_bits(flat, ptr)
                sfs = np.where(books > 0, sf[c, f, :max_sfb], 0) \
                    .astype(np.int64)
                nz = np.nonzero(books)[0]
                gg = int(sfs[nz[0]]) if nz.size else 121
                prev = gg
                for i in nz:                   # DPCM clamp, +-60/step
                    d = int(np.clip(int(sfs[i]) - prev, -60, 60))
                    sfs[i] = prev + d
                    prev = sfs[i]
                specs.append(ChannelSpec(
                    window_sequence=seq, window_shape=0,
                    max_sfb=max_sfb,
                    grouping=[8] if short else None,
                    global_gain=int(np.clip(gg, 0, 255)),
                    band_books=books, band_sf=sfs, quant=row))
            w = BitWriter()
            if self.channels == 2:
                write_cpe(w, CPESpec(left=specs[0], right=specs[1],
                                     common_window=True, ms_type=0),
                          self.config)
            else:
                write_sce(w, specs[0], self.config)
            payloads.append(end_frame(w))
        return payloads
