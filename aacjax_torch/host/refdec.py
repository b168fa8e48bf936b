"""Independent fp64 reference decoder.

Consumes the same parsed Frame structures as the production runtime but
performs all spectral processing frame-at-a-time in float64 with
per-window-sequence branches — deliberately mirroring the *reference's*
control structure (decoder.js processSingle/processPair,
filter_bank.js process) rather than the production pipeline's linearized
batched form, so the two implementations cross-validate each other
(tests use it as the model oracle).  The per-frame math itself is
vectorized (scipy lfilter for the TNS recurrences, one DCT-IV per
transform — tables.imdct_via_dct4/mdct_via_dct4) so the oracle is also
fast enough to serve as a production path.

It is also the production decode path for AAC-LTP (AOT 4): long-term
prediction feeds each frame's spectrum from the previous frames' TIME
output (ltp_state), an inherently sequential per-frame loop that would
serialize the batched device pipeline; the rare profile runs here
instead.  decode_adts routes profile 4 through `decode_ltp_native`
(native C parse + the same vectorized math, ~25x the per-frame python
loop) and falls back to the ModelDecoder loop for error/concealment
handling, DRC, coupling, or when the native parser isn't built.

Spec-correct choices match aacjax (TNS applied as the AR filter over
spec-correct regions, pulse applied, CCE with reference gain bookkeeping).
"""
from __future__ import annotations

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host.asc import StreamConfig
from aacjax_torch.host.syntax import (
    AFTER_IMDCT, AFTER_TNS, BEFORE_TNS, CCEData, CPEData, Frame,
    INTENSITY_BT, INTENSITY_BT2, NOISE_BT, SCEData, TnsFilter,
)

class ModelDecoder:
    def __init__(self, config: StreamConfig, n_channels: int | None = None):
        self.config = config
        # frame geometry: 1024/448/128, or 960/420/120 in 960 mode
        self.F = config.frame_length
        self.S = self.F // 8
        self.MID = (self.F - self.S) // 2
        n = n_channels if n_channels is not None else config.channels
        # AAC-ELD carries three pending output segments per channel
        # (the low-delay filterbank spans 4 frames)
        ov = 3 * self.F if config.profile == 39 else self.F
        self.overlaps = [np.zeros(ov, np.float64) for _ in range(n)]
        self.cce_overlaps: dict[int, np.ndarray] = {}
        # AAC-LTP: [3F] time history per channel = (output[t-2], output[t-1],
        # windowed estimate of output[t]) in spectral (32768) scale
        self.ltp_states = [np.zeros(3 * self.F, np.float64) for _ in range(n)]

    # ------------------------------------------------------------------
    def dequant(self, ch) -> np.ndarray:
        q = ch.quant[:self.F].astype(np.float64)
        spec = (np.sign(q) * np.abs(q) ** (4.0 / 3.0)
                * ch.scale_bin[:self.F].astype(np.float64))
        return spec + ch.noise_bin[:self.F].astype(np.float64)

    def _band_iter(self, info):
        """Yields (idx, bin_start, width, group_len) over the grouped layout."""
        idx = 0
        group_off = 0
        for g in range(info.group_count):
            glen = int(info.group_length[g])
            for sfb in range(info.max_sfb):
                off = int(info.swb_offsets[sfb])
                width = int(info.swb_offsets[sfb + 1]) - off
                yield idx, group_off + off, width, glen
                idx += 1
            group_off += glen * self.S

    def apply_ms(self, cpe: CPEData, l: np.ndarray, r: np.ndarray) -> None:
        if not (cpe.common_window and cpe.mask_present):
            return
        for idx, start, width, glen in self._band_iter(cpe.left.info):
            if not cpe.ms_used[idx]:
                continue
            if (cpe.left.band_types[idx] >= NOISE_BT
                    or cpe.right.band_types[idx] >= NOISE_BT):
                continue
            for w in range(glen):
                s = start + w * self.S
                tmp = l[s:s + width] - r[s:s + width]
                l[s:s + width] += r[s:s + width]
                r[s:s + width] = tmp

    def apply_is(self, cpe: CPEData, l: np.ndarray, r: np.ndarray) -> None:
        for idx, start, width, glen in self._band_iter(cpe.right.info):
            bt = int(cpe.right.band_types[idx])
            if bt not in (INTENSITY_BT, INTENSITY_BT2):
                continue
            c = 1.0 if bt == INTENSITY_BT else -1.0
            if cpe.mask_present and cpe.ms_used[idx]:
                c = -c
            scale = c * float(cpe.right.sf_gain[idx])
            for w in range(glen):
                s = start + w * self.S
                r[s:s + width] = l[s:s + width] * scale

    def apply_tns(self, ch, spec: np.ndarray) -> None:
        """Sequential AR filter (spec-correct decode direction): the
        recurrence y[n] = x[n] - sum_i lpc[i-1]*y[n-i] over each region,
        zero history at the region start — exactly scipy's direct-form
        IIR, run at C speed instead of a per-bin python loop."""
        from scipy.signal import lfilter
        for f in ch.tns_filters:
            a = np.empty(f.order + 1, np.float64)
            a[0] = 1.0
            a[1:] = f.lpc[: f.order]
            region = spec[f.start: f.end]
            if f.inc == -1:
                region = region[::-1]
            y = lfilter([1.0], a, region)
            spec[f.start: f.end] = y[::-1] if f.inc == -1 else y

    def filterbank(self, info, spec: np.ndarray,
                   overlap: np.ndarray) -> np.ndarray:
        """IMDCT + window + OLA for one channel; mutates overlap in place.
        Stashes the raw IMDCT output on self._last_raw for update_ltp."""
        FRAME, SHORT, MID = self.F, self.S, self.MID
        if self.config.profile == 39:
            # AAC-ELD low-delay filterbank: the frame's F coefficients map
            # to 4F output samples (tables.eld_synthesis_matrix, fp64),
            # accumulated at F-sample stride; overlap holds the three
            # pending segments (mirrors pipeline.eld_synthesis)
            y = spec @ tables.eld_synthesis_matrix(FRAME)   # [4F]
            out = overlap[:FRAME] + y[:FRAME]
            overlap[:2 * FRAME] = overlap[FRAME:]
            overlap[2 * FRAME:] = 0.0
            overlap[:3 * FRAME] += y[FRAME:]
            self._last_raw = None
            return out
        seq = info.window_sequence
        wl_cur = tables.long_window(info.window_shape, FRAME)
        ws_cur = tables.short_window(info.window_shape, SHORT)
        wl_prev = tables.long_window(info.prev_window_shape, FRAME)
        ws_prev = tables.short_window(info.prev_window_shape, SHORT)
        out = np.zeros(FRAME, np.float64)
        self._last_raw = None

        if seq != 2:
            buf = tables.imdct_via_dct4(spec)            # [2*FRAME]
            self._last_raw = buf
            if seq == 0:  # ONLY_LONG
                out[:] = overlap + buf[:FRAME] * wl_prev
                overlap[:] = buf[FRAME:] * wl_cur[::-1]
            elif seq == 1:  # LONG_START
                out[:] = overlap + buf[:FRAME] * wl_prev
                overlap[:MID] = buf[FRAME:FRAME + MID]
                overlap[MID:MID + SHORT] = (buf[FRAME + MID:FRAME + MID + SHORT]
                                            * ws_cur[::-1])
                overlap[MID + SHORT:] = 0.0
            elif seq == 3:  # LONG_STOP
                out[:MID] = overlap[:MID]
                out[MID:MID + SHORT] = (overlap[MID:MID + SHORT]
                                        + buf[MID:MID + SHORT] * ws_prev)
                out[MID + SHORT:] = (overlap[MID + SHORT:]
                                     + buf[MID + SHORT:FRAME])
                overlap[:] = buf[FRAME:] * wl_cur[::-1]
        else:  # EIGHT_SHORT
            blocks = tables.imdct_via_dct4(
                spec.reshape(8, SHORT))                  # [8, 2*SHORT]
            t = np.zeros(2 * FRAME, np.float64)
            for w in range(8):
                block = blocks[w]
                rise = ws_prev if w == 0 else ws_cur
                windowed = np.concatenate([block[:SHORT] * rise,
                                           block[SHORT:] * ws_cur[::-1]])
                off = MID + w * SHORT
                t[off:off + 2 * SHORT] += windowed
            out[:] = overlap + t[:FRAME]
            overlap[:] = t[FRAME:]
            self._last_raw = list(blocks)
        return out

    # -- AAC-LTP (AOT 4) -----------------------------------------------------
    MAX_LTP_SFB = 40

    def apply_ltp(self, ch, spec: np.ndarray, channel: int) -> None:
        """Long-term prediction: predict the frame's spectrum from the
        time history, window + forward-MDCT the prediction, TNS-analysis
        filter it, and add into the used sfbs (libavcodec apply_ltp /
        windowing_and_mdct_ltp semantics).  Long windows only."""
        info = ch.info
        ltp = getattr(info, "ltp", None)
        if ltp is None or info.window_sequence == 2 or not ltp.lag:
            return
        F = self.F
        coef = float(tables.LTP_COEF[ltp.coef_idx])
        state = self.ltp_states[channel]
        num = min(2 * F, ltp.lag + F)
        pred = np.zeros(2 * F, np.float64)
        pred[:num] = state[2 * F - ltp.lag: 2 * F - ltp.lag + num] * coef

        wl_cur = tables.long_window(info.window_shape, F)
        ws_cur = tables.short_window(info.window_shape, self.S)
        wl_prev = tables.long_window(info.prev_window_shape, F)
        ws_prev = tables.short_window(info.prev_window_shape, self.S)
        MID, S = self.MID, self.S
        seq = info.window_sequence
        if seq != 3:                       # not LONG_STOP: long rise
            pred[:F] *= wl_prev
        else:
            pred[:MID] = 0.0
            pred[MID:MID + S] *= ws_prev
        if seq != 1:                       # not LONG_START: long fall
            pred[F:] *= wl_cur[::-1]
        else:
            pred[F + MID:F + MID + S] *= ws_cur[::-1]
            pred[F + MID + S:] = 0.0

        # forward MDCT (exact PR pair of tables.imdct_matrix)
        pred_freq = tables.mdct_via_dct4(pred)

        # TNS analysis (all-zero/FIR) filtering of the prediction, over
        # the same regions and direction as the synthesis filter:
        # y[n] = x[n] + sum_i lpc[i-1]*x[n-i] with zero history at the
        # region start — a pure FIR, run as scipy lfilter(b, 1)
        from scipy.signal import lfilter
        for f in ch.tns_filters:
            b = np.empty(f.order + 1, np.float64)
            b[0] = 1.0
            b[1:] = f.lpc[: f.order]
            region = pred_freq[f.start: f.end]
            if f.inc == -1:
                region = region[::-1]
            y = lfilter(b, [1.0], region)
            pred_freq[f.start: f.end] = y[::-1] if f.inc == -1 else y

        offs = info.swb_offsets
        for sfb in range(min(info.max_sfb, self.MAX_LTP_SFB)):
            if ltp.used[sfb]:
                lo, hi = int(offs[sfb]), int(offs[sfb + 1])
                spec[lo:hi] += pred_freq[lo:hi]

    def update_ltp(self, info, out: np.ndarray, overlap: np.ndarray,
                   channel: int) -> None:
        """Shift the time history and append the windowed estimate of the
        next frame's tail (libavcodec update_ltp)."""
        F, S, MID = self.F, self.S, self.MID
        state = self.ltp_states[channel]
        raw = self._last_raw
        saved_ltp = np.zeros(F, np.float64)
        wl = tables.long_window(info.window_shape, F)
        ws = tables.short_window(info.window_shape, S)
        seq = info.window_sequence
        # FFmpeg's buf_mdct is the middle half of the full IMDCT
        # (m[k] = x[512+k], pinned numerically against our filterbank),
        # so buf_mdct[1023-i] = x[1535-i]
        if seq == 2:                       # EIGHT_SHORT
            saved_ltp[:MID + S] = overlap[:MID + S]
            last = raw[7]                  # [2S] raw imdct of window 7
            saved_ltp[MID: MID + S // 2] = (last[S: S + S // 2]
                                            * ws[::-1][: S // 2])
            i = np.arange(S // 2)
            saved_ltp[MID + S // 2 + i] = (last[S + S // 2 - 1 - i]
                                           * ws[S // 2 - 1 - i])
            saved_ltp[MID + S:] = 0.0
        elif seq == 1:                     # LONG_START
            saved_ltp[:MID] = raw[F: F + MID]
            saved_ltp[MID: MID + S // 2] = (raw[F + MID: F + MID + S // 2]
                                            * ws[::-1][: S // 2])
            i = np.arange(S // 2)
            saved_ltp[MID + S // 2 + i] = (raw[F + F // 2 - 1 - i]
                                           * ws[S // 2 - 1 - i])
        else:                              # ONLY_LONG / LONG_STOP
            half = F // 2
            saved_ltp[:half] = raw[F: F + half] * wl[::-1][:half]
            i = np.arange(half)
            saved_ltp[half + i] = raw[F + half - 1 - i] * wl[half - 1 - i]
        state[:F] = state[F: 2 * F]
        state[F: 2 * F] = out
        state[2 * F:] = saved_ltp

    # ------------------------------------------------------------------
    def _coupling(self, frame: Frame, element, point: int,
                  datas: list[np.ndarray]) -> None:
        """Apply matching CCEs at the given coupling point
        (decoder.js:406-433 bookkeeping)."""
        is_pair = isinstance(element, CPEData)
        for ci, cce in enumerate(frame.cces):
            if cce.coupling_point != point:
                continue
            index = 0
            src = self._cce_data(frame, ci, point)
            for c in range(cce.coupled_count + 1):
                ch_select = int(cce.ch_select[c])
                if (bool(cce.channel_pair[c]) == is_pair
                        and int(cce.id_select[c]) == element.id):
                    if ch_select != 1:
                        self._apply_cce(cce, index, src, datas[0], point)
                        if ch_select:
                            index += 1
                    if ch_select != 2:
                        self._apply_cce(cce, index, src,
                                        datas[1] if len(datas) > 1 else datas[0],
                                        point)
                        index += 1
                else:
                    index += 1 + (1 if ch_select == 3 else 0)

    def _cce_data(self, frame: Frame, ci: int, point: int) -> np.ndarray:
        cce = frame.cces[ci]
        if point != AFTER_IMDCT:
            return self.dequant(cce.ics)
        # time-domain signal computed once per frame (its filterbank carries
        # overlap state), reused for every coupled target
        return self._frame_cce_time[ci]

    def _prepare_cce_time(self, frame: Frame) -> None:
        self._frame_cce_time = {}
        for ci, cce in enumerate(frame.cces):
            if cce.coupling_point != AFTER_IMDCT:
                continue
            if ci not in self.cce_overlaps:
                self.cce_overlaps[ci] = np.zeros(self.F, np.float64)
            self._frame_cce_time[ci] = self.filterbank(
                cce.ics.info, self.dequant(cce.ics), self.cce_overlaps[ci])

    def _apply_cce(self, cce: CCEData, index: int, src: np.ndarray,
                   dst: np.ndarray, point: int) -> None:
        if point == AFTER_IMDCT:
            dst += float(cce.gain[index][0]) * src
            return
        gains = cce.gain[index]
        # expand the per-band gains to one per-bin vector, then a single
        # fused multiply-add (the device stage's form, pipeline.py CCE)
        g_bin = np.zeros(self.F, np.float64)
        for idx, start, width, glen in self._band_iter(cce.ics.info):
            if cce.ics.band_types[idx] == 0:
                continue
            g = float(gains[idx])
            for w in range(glen):
                s = start + w * self.S
                g_bin[s:s + width] = g
        dst += g_bin * src

    # ------------------------------------------------------------------
    def decode_frame(self, frame: Frame) -> np.ndarray:
        """Returns [n_samples=frame_length, channels] PCM in 1/32768 scale."""
        self._prepare_cce_time(frame)
        outs = []
        channel = 0
        ltp = self.config.profile == 4  # AOT_AAC_LTP
        for elem in frame.elements:
            if isinstance(elem, SCEData):
                spec = self.dequant(elem.ics)
                if ltp:
                    self.apply_ltp(elem.ics, spec, channel)
                self._coupling(frame, elem, BEFORE_TNS, [spec])
                self.apply_tns(elem.ics, spec)
                self._coupling(frame, elem, AFTER_TNS, [spec])
                pcm = self.filterbank(elem.ics.info, spec,
                                      self.overlaps[channel])
                if ltp:
                    self.update_ltp(elem.ics.info, pcm,
                                    self.overlaps[channel], channel)
                self._coupling(frame, elem, AFTER_IMDCT, [pcm])
                outs.append(pcm)
                channel += 1
            elif isinstance(elem, CPEData):
                l = self.dequant(elem.left)
                r = self.dequant(elem.right)
                self.apply_ms(elem, l, r)
                self.apply_is(elem, l, r)
                if ltp:
                    self.apply_ltp(elem.left, l, channel)
                    self.apply_ltp(elem.right, r, channel + 1)
                self._coupling(frame, elem, BEFORE_TNS, [l, r])
                self.apply_tns(elem.left, l)
                self.apply_tns(elem.right, r)
                self._coupling(frame, elem, AFTER_TNS, [l, r])
                pl = self.filterbank(elem.left.info, l, self.overlaps[channel])
                if ltp:
                    self.update_ltp(elem.left.info, pl,
                                    self.overlaps[channel], channel)
                pr = self.filterbank(elem.right.info, r,
                                     self.overlaps[channel + 1])
                if ltp:
                    self.update_ltp(elem.right.info, pr,
                                    self.overlaps[channel + 1], channel + 1)
                self._coupling(frame, elem, AFTER_IMDCT, [pl, pr])
                outs.extend([pl, pr])
                channel += 2
        return np.stack(outs, axis=1) / 32768.0


# ---------------------------------------------------------------------------
# AAC-LTP fast path: native parse + vectorized frame-serial math
# ---------------------------------------------------------------------------
class _InfoShim:
    """Minimal ICSInfo stand-in built from the native parser's dense
    planes — just the fields the ModelDecoder math reads."""
    __slots__ = ("window_sequence", "window_shape", "prev_window_shape",
                 "max_sfb", "swb_offsets", "ltp")


class _ChShim:
    __slots__ = ("info", "tns_filters")


class _LTPShim:
    __slots__ = ("lag", "coef_idx", "used")


def decode_ltp_native(payloads: list[bytes], config: StreamConfig,
                      chunk_frames: int = 256) -> np.ndarray | None:
    """AAC-LTP (AOT 4) production path: ONE native C call per chunk
    parses the bitstream into spectra + TNS filters + LTP side info
    (aacparse.cc emit_ltp); the frame-serial prediction/filterbank math
    — the only part LTP's time feedback truly serializes — runs here
    with the same ModelDecoder routines (lfilter TNS, DCT-IV
    transforms), skipping the per-frame python bitstream walk.

    Exactness: when the chunk rides the exact-i16 q/sf representation
    the fp64 dequant is bit-identical to the python parse, so the
    output equals the ModelDecoder loop exactly; content that needs the
    host-fused f32 spectra (M/S, PNS, escapes) differs only by the f32
    rounding of values libavcodec also holds in f32 (tests/test_ltp.py
    oracle bounds).

    Returns None when the stream must take the python loop instead:
    native parser unavailable, any frame error (the python loop owns
    concealment semantics), or delegated content (CCE coupling)."""
    from aacjax_torch.host import native

    if not native.available() or config.frame_length != 1024:
        return None
    C = config.channels
    F = config.frame_length
    offs = np.asarray(config.swb_offsets_long, np.int64)
    n_sfb = min(40, int(config.swb_count_long))
    tp = native.stream_tables([config])
    sf_lut = np.power(2.0, (np.arange(256, dtype=np.float64) - 100.0)
                      / 4.0).astype(np.float32)
    dec = ModelDecoder(config, n_channels=C)
    prev_shapes = np.zeros(C, np.int32)
    pcm_out = np.empty((len(payloads) * F, C), np.float32)
    wrote = 0

    for lo in range(0, len(payloads), chunk_frames):
        group = payloads[lo: lo + chunk_frames]
        T = len(group)
        out = native.SpecBatchArrays(C, T, F)
        try:
            status, _, _ = native.parse_batch_spec(
                [group], np.array([config.sample_index], np.int32),
                np.array([config.chan_config], np.int32),
                np.zeros(1, np.int32), np.array([C], np.int32),
                prev_shapes, out, tables_pack=tp,
                want_qsf=True, want_ltp=True)
        except native.NativeParseError:
            return None
        if int(status[0]) != 0:
            return None  # python loop owns error/concealment semantics

        if out.qsf_ok is not None and bool(out.qsf_ok.all()):
            # exact-i16: fp64 dequant identical to the python parse
            q = out.spec_q.astype(np.float64)
            mag = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
            gain = sf_lut[out.spec_sf].astype(np.float64)   # [C,T,F/4]
            spec64 = (mag.reshape(C, T, F // 4, 4)
                      * gain[..., None]).reshape(C, T, F)
        else:
            spec64 = out.spec.astype(np.float64)

        meta = out.meta
        for t in range(T):
            for c in range(C):
                info = _InfoShim()
                info.window_sequence = int(meta[c, t, 1]) // 2
                info.window_shape = int(meta[c, t, 2])
                info.prev_window_shape = int(meta[c, t, 3])
                info.max_sfb = n_sfb
                info.swb_offsets = offs
                lag = int(out.ltp_meta[c, t, 0])
                if lag > 0:
                    ltp = _LTPShim()
                    ltp.lag = lag
                    ltp.coef_idx = int(out.ltp_meta[c, t, 1])
                    ltp.used = out.ltp_used[c, t].astype(bool)
                    info.ltp = ltp
                else:
                    info.ltp = None
                ch = _ChShim()
                ch.info = info
                fl = []
                for bank, inc in ((0, 1), (1, -1)):
                    for k in range(8):
                        s_ = int(out.tns_range[c, t, bank, k, 0])
                        e_ = int(out.tns_range[c, t, bank, k, 1])
                        if e_ <= s_:
                            continue
                        if inc == -1:
                            # rev bank stores flipped-spectrum coords
                            s_, e_ = F - e_, F - s_
                        fl.append(TnsFilter(
                            start=s_, end=e_, inc=inc,
                            order=out.tns_lpc.shape[-1],
                            lpc=out.tns_lpc[c, t, bank, k]
                                .astype(np.float64)))
                ch.tns_filters = fl

                spec = spec64[c, t]
                dec.apply_ltp(ch, spec, c)
                dec.apply_tns(ch, spec)
                pcm = dec.filterbank(info, spec, dec.overlaps[c])
                dec.update_ltp(info, pcm, dec.overlaps[c], c)
                pcm_out[wrote + t * F: wrote + (t + 1) * F, c] = (
                    pcm / 32768.0)
        wrote += T * F
    return pcm_out
