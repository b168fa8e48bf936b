"""Stream-batched AAC-LTP (AOT 4) decoding.

LTP's long-term prediction reads each frame's prediction from the
previous frames' TIME output (forward MDCT of the windowed history,
TNS-analysis filtered, added into the used sfbs), so the frame chain is
inherently serial PER STREAM — but across a serving batch it is
embarrassingly data-parallel.  The reference throws on LTP outright
(decoder.js:258-259); aacjax's single-stream path (`refdec.decode_ltp_native`)
is exact but decodes a fleet stream-at-a-time.

This module vectorizes the per-frame math across all streams x channels
with one native C parse per chunk for the WHOLE batch: the serial loop
runs over T frames only, and every step inside it — the per-row lag
slice, branch-free window select, batched DCT-IV forward/inverse MDCTs,
masked sfb adds, the four window-sequence overlap-add forms, and the
LTP history update — operates on [R, ...] row blocks (R = streams x
channels) in fp64, matching `ModelDecoder` bit-for-bit (the same
`tables.mdct_via_dct4`/`imdct_via_dct4` transforms in the same order).
Only the TNS filters run per-row (scipy lfilter over each row's own
regions — region geometry varies per row and the IIR direction is
spec-mandated); rows without TNS skip it entirely.

Exactness: outputs equal the per-stream `decode_ltp_native` loop exactly
on the exact-i16 q/sf representation and are held sample-exact against
libavcodec in tests/test_ltp.py (batched == single-stream == oracle).
"""
from __future__ import annotations

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host.asc import StreamConfig

MAX_LTP_SFB = 40


class LTPBatchState:
    """Per-batch carried state: LTP time histories and overlap buffers."""

    def __init__(self, R: int, F: int):
        self.ltp = np.zeros((R, 3 * F), np.float64)
        self.overlap = np.zeros((R, F), np.float64)
        self.prev_shapes = np.zeros(R, np.int32)


def _windows(F: int, S: int):
    wl = np.stack([tables.long_window(0, F), tables.long_window(1, F)])
    ws = np.stack([tables.short_window(0, S), tables.short_window(1, S)])
    return wl, ws


def _tns_rows(out, t: int, R: int, F: int):
    """Per-row TnsFilter-like tuples (start, end, inc, lpc) for frame t;
    only rows that actually carry filters appear."""
    filt: dict[int, list] = {}
    rng = out.tns_range
    lpc = out.tns_lpc
    for c in range(R):
        fl = []
        for bank, inc in ((0, 1), (1, -1)):
            for k in range(rng.shape[3]):
                s_, e_ = int(rng[c, t, bank, k, 0]), int(rng[c, t, bank, k, 1])
                if e_ <= s_:
                    continue
                if inc == -1:
                    s_, e_ = F - e_, F - s_
                fl.append((s_, e_, inc, lpc[c, t, bank, k].astype(np.float64)))
        if fl:
            filt[c] = fl
    return filt


def _tns_filter_rows(spec: np.ndarray, filt: dict, analysis: bool) -> None:
    """Apply each row's TNS filters in place: analysis (FIR, the LTP
    prediction pre-filter) or synthesis (IIR decode direction)."""
    from scipy.signal import lfilter
    for c, fl in filt.items():
        for s_, e_, inc, lp in fl:
            coef = np.empty(lp.shape[0] + 1, np.float64)
            coef[0] = 1.0
            coef[1:] = lp
            region = spec[c, s_:e_]
            if inc == -1:
                region = region[::-1]
            y = (lfilter(coef, [1.0], region) if analysis
                 else lfilter([1.0], coef, region))
            spec[c, s_:e_] = y[::-1] if inc == -1 else y


def ltp_step_frames(spec64: np.ndarray, meta: np.ndarray,
                    ltp_meta: np.ndarray, ltp_used: np.ndarray,
                    tns_filters_per_t: list, state: LTPBatchState,
                    offs: np.ndarray, n_sfb: int) -> np.ndarray:
    """Decode T frames of R rows: returns pcm [R, T, F] fp64 (32768
    scale).  spec64 [R,T,F] dequantized spectra; meta as the native
    parser fills it (cols 1..3 = seq*2, shape, prev_shape); state
    mutates in place (chunk carry)."""
    R, T, F = spec64.shape
    S, MID = F // 8, (F - F // 8) // 2
    wl, ws = _windows(F, S)
    half = F // 2
    pcm = np.empty((R, T, F), np.float64)

    for t in range(T):
        seq = meta[:, t, 1] // 2                      # [R]
        shp = meta[:, t, 2]
        psh = meta[:, t, 3]
        wl_cur, ws_cur = wl[shp], ws[shp]             # [R,F], [R,S]
        wl_prev, ws_prev = wl[psh], ws[psh]
        spec = spec64[:, t].copy()                    # [R,F]
        filt = tns_filters_per_t[t]

        # ---- apply_ltp (long windows with lag only) --------------------
        lag = ltp_meta[:, t, 0].astype(np.int64)      # [R]
        act = (lag > 0) & (seq != 2)
        if act.any():
            rows = np.nonzero(act)[0]
            lg = lag[rows]
            coef = tables.LTP_COEF[ltp_meta[rows, t, 1]]
            idx = (2 * F - lg)[:, None] + np.arange(2 * F)[None, :]
            num = np.minimum(2 * F, lg + F)
            pred = (np.take_along_axis(
                state.ltp[rows], np.clip(idx, 0, 3 * F - 1), axis=1)
                * coef[:, None])
            pred[np.arange(2 * F)[None, :] >= num[:, None]] = 0.0
            sq = seq[rows]
            # rise half: long window (seq != 3), or LONG_STOP's zero
            # head + short rise + UNWINDOWED [MID+S:F] span
            stop = sq == 3
            head = pred[:, :F]
            head_stop = head.copy()
            head_stop[:, :MID] = 0.0
            head_stop[:, MID:MID + S] *= ws_prev[rows]
            pred[:, :F] = np.where(stop[:, None],
                                   head_stop, head * wl_prev[rows])
            # fall half: long (seq != 1) or LONG_START's short fall
            start = sq == 1
            pred[:, F:] = np.where(start[:, None],
                                   pred[:, F:],
                                   pred[:, F:] * wl_cur[rows, ::-1])
            if start.any():
                st_ = np.nonzero(start)[0]
                tailv = pred[st_, F:]
                tailv[:, MID:MID + S] *= ws_cur[rows[st_], ::-1]
                tailv[:, MID + S:] = 0.0
                pred[st_, F:] = tailv
            pred_freq = tables.mdct_via_dct4(pred, workers=-1)
            sub = {c: filt[c] for c in range(R)
                   if c in filt and act[c]}
            # remap to subset coordinates
            if sub:
                pf_full = np.zeros((R, F), np.float64)
                pf_full[rows] = pred_freq
                _tns_filter_rows(pf_full, sub, analysis=True)
                pred_freq = pf_full[rows]
            used = ltp_used[rows, t, :min(n_sfb, MAX_LTP_SFB)]  # [r, nsfb]
            binmask = np.zeros((len(rows), F), bool)
            for sfb in range(min(n_sfb, MAX_LTP_SFB)):
                lo, hi = int(offs[sfb]), int(offs[sfb + 1])
                binmask[:, lo:hi] = used[:, sfb:sfb + 1] != 0
            spec[rows] += pred_freq * binmask

        # ---- TNS synthesis ---------------------------------------------
        if filt:
            _tns_filter_rows(spec, filt, analysis=False)

        # ---- filterbank (four sequences, masked) -------------------------
        out = np.empty((R, F), np.float64)
        is_short = seq == 2
        long_rows = np.nonzero(~is_short)[0]
        raw = np.zeros((R, 2 * F), np.float64)        # long IMDCT rows
        if len(long_rows):
            buf = tables.imdct_via_dct4(spec[long_rows],
                                        workers=-1)  # [r, 2F]
            raw[long_rows] = buf
            sq = seq[long_rows]
            ov = state.overlap[long_rows]
            o = ov + buf[:, :F] * wl_prev[long_rows]
            # LONG_STOP overrides the head
            stop = sq == 3
            if stop.any():
                sr = np.nonzero(stop)[0]
                o[sr, :MID] = ov[sr, :MID]
                o[sr, MID:MID + S] = (ov[sr, MID:MID + S]
                                      + buf[sr, MID:MID + S]
                                      * ws_prev[long_rows[sr]])
                o[sr, MID + S:] = (ov[sr, MID + S:]
                                   + buf[sr, MID + S:F])
            out[long_rows] = o
            # new overlap
            novl = buf[:, F:] * wl_cur[long_rows, ::-1]
            start = sq == 1
            if start.any():
                st_ = np.nonzero(start)[0]
                novl[st_, :MID] = buf[st_, F:F + MID]
                novl[st_, MID:MID + S] = (buf[st_, F + MID:F + MID + S]
                                          * ws_cur[long_rows[st_], ::-1])
                novl[st_, MID + S:] = 0.0
            state.overlap[long_rows] = novl
        short_rows = np.nonzero(is_short)[0]
        blocks = None
        if len(short_rows):
            blocks = tables.imdct_via_dct4(
                spec[short_rows].reshape(-1, 8, S),
                workers=-1)                           # [r, 8, 2S]
            rise0 = ws_prev[short_rows]
            risek = ws_cur[short_rows]
            fall = ws_cur[short_rows, ::-1]
            tl = np.zeros((len(short_rows), 2 * F), np.float64)
            for w in range(8):
                rise = rise0 if w == 0 else risek
                off = MID + w * S
                tl[:, off:off + S] += blocks[:, w, :S] * rise
                tl[:, off + S:off + 2 * S] += blocks[:, w, S:] * fall
            out[short_rows] = state.overlap[short_rows] + tl[:, :F]
            state.overlap[short_rows] = tl[:, F:]
        pcm[:, t] = out

        # ---- update_ltp ---------------------------------------------------
        saved = np.zeros((R, F), np.float64)
        # ONLY_LONG / LONG_STOP (seq 0 or 3): saved[half+i] =
        # raw[F+half-1-i] * wl[half-1-i] -> reversed slices
        ol = np.nonzero((seq == 0) | (seq == 3))[0]
        if len(ol):
            w = wl[shp[ol]]
            saved[ol, :half] = raw[ol, F:F + half] * w[:, ::-1][:, :half]
            saved[ol, half:] = (raw[ol, F:F + half][:, ::-1]
                                * w[:, :half][:, ::-1])
        # LONG_START (seq 1): saved[MID+S/2+i] = raw[F+F/2-1-i]*ws[S/2-1-i]
        ls = np.nonzero(seq == 1)[0]
        if len(ls):
            w = ws[shp[ls]]
            saved[ls, :MID] = raw[ls, F:F + MID]
            saved[ls, MID:MID + S // 2] = (raw[ls, F + MID:F + MID + S // 2]
                                           * w[:, ::-1][:, :S // 2])
            saved[ls, MID + S // 2:MID + S] = (
                raw[ls, F + F // 2 - S // 2:F + F // 2][:, ::-1]
                * w[:, :S // 2][:, ::-1])
        # EIGHT_SHORT (seq 2): head reads the NEW overlap (the
        # filterbank already advanced it); tail from window 7's raw
        if len(short_rows):
            w = ws[shp[short_rows]]
            last = blocks[:, 7]                        # [r, 2S]
            saved[short_rows, :MID + S] = \
                state.overlap[short_rows, :MID + S]
            saved[short_rows, MID:MID + S // 2] = (
                last[:, S:S + S // 2] * w[:, ::-1][:, :S // 2])
            saved[short_rows, MID + S // 2:MID + S] = (
                last[:, S:S + S // 2][:, ::-1] * w[:, :S // 2][:, ::-1])
            saved[short_rows, MID + S:] = 0.0
        state.ltp[:, :F] = state.ltp[:, F:2 * F]
        state.ltp[:, F:2 * F] = out
        state.ltp[:, 2 * F:] = saved
    return pcm


class LTPBatchDecoder:
    """Batched AAC-LTP chunk decoder: one native parse per chunk for all
    streams, vectorized frame math, state carried across chunks."""

    def __init__(self, configs: list[StreamConfig]):
        from aacjax_torch.host import native
        if not native.available():
            raise RuntimeError("batched LTP needs the native parser")
        if any(cfg.profile != 4 or cfg.frame_length != 1024
               for cfg in configs):
            raise ValueError("LTPBatchDecoder: profile-4 1024-frame "
                             "streams only")
        self.configs = configs
        self.C = sum(cfg.channels for cfg in configs)
        self.F = configs[0].frame_length
        self.base = np.zeros(len(configs), np.int32)
        acc = 0
        for i, cfg in enumerate(configs):
            self.base[i] = acc
            acc += cfg.channels
        self._tp = native.stream_tables(configs)
        self.offs = np.asarray(configs[0].swb_offsets_long, np.int64)
        self.n_sfb = min(MAX_LTP_SFB, int(configs[0].swb_count_long))
        self.state = LTPBatchState(self.C, self.F)
        self._sf_lut = np.power(
            2.0, (np.arange(256, dtype=np.float64) - 100.0) / 4.0
        ).astype(np.float32)

    def step_raw(self, payloads_per_stream: list) -> np.ndarray:
        """Decode one chunk: returns pcm [C, T, F] float32 (1/32768
        scale).  Missing/failed frames decode as silence and advance
        state (rollback-to-silence, like the native LC path)."""
        from aacjax_torch.host import native
        T = max((len(p or []) for p in payloads_per_stream), default=0)
        out = native.SpecBatchArrays(self.C, T, self.F)
        status, _, _ = native.parse_batch_spec(
            payloads_per_stream,
            np.array([c.sample_index for c in self.configs], np.int32),
            np.array([c.chan_config for c in self.configs], np.int32),
            self.base,
            np.array([c.channels for c in self.configs], np.int32),
            self.state.prev_shapes, out, tables_pack=self._tp,
            want_qsf=True, want_ltp=True)
        if out.qsf_ok is not None and bool(out.qsf_ok.all()):
            q = out.spec_q.astype(np.float64)
            mag = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
            gain = self._sf_lut[out.spec_sf].astype(np.float64)
            spec64 = (mag.reshape(self.C, T, self.F // 4, 4)
                      * gain[..., None]).reshape(self.C, T, self.F)
        else:
            spec64 = out.spec.astype(np.float64)
        filt = [_tns_rows(out, t, self.C, self.F) for t in range(T)]
        pcm = ltp_step_frames(spec64, out.meta, out.ltp_meta, out.ltp_used,
                              filt, self.state, self.offs, self.n_sfb)
        return (pcm * (1.0 / 32768.0)).astype(np.float32)
