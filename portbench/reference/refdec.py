"""Independent fp64 reference decoder of AAC-LC frames.

Consumes parsed Frame structures and performs all spectral processing
frame-at-a-time in float64 with per-window-sequence branches.  The
per-frame math itself is vectorized (scipy lfilter for the TNS
recurrences, one DCT-IV per transform, tables.imdct_via_dct4).  TNS is
applied as the AR filter over the spec-correct regions, pulse data is
applied.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import tables
from portbench.reference.asc import StreamConfig
from portbench.reference.syntax import (
    CPEData, Frame, INTENSITY_BT, INTENSITY_BT2, NOISE_BT, SCEData,
)

class ModelDecoder:
    def __init__(self, config: StreamConfig, n_channels: int | None = None,
                 rnd=None):
        self.config = config
        # the arithmetic's precision (precision.py): every spectrum, IMDCT
        # output and output sample passes through it
        self.rnd = rnd or (lambda x: x)
        # frame geometry: 1024/448/128
        self.F = config.frame_length
        self.S = self.F // 8
        self.MID = (self.F - self.S) // 2
        n = n_channels if n_channels is not None else config.channels
        self.overlaps = [np.zeros(self.F, np.float64) for _ in range(n)]

    # ------------------------------------------------------------------
    def dequant(self, ch) -> np.ndarray:
        q = ch.quant[:self.F].astype(np.float64)
        spec = (np.sign(q) * np.abs(q) ** (4.0 / 3.0)
                * ch.scale_bin[:self.F].astype(np.float64))
        return self.rnd(spec + ch.noise_bin[:self.F].astype(np.float64))

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
        """IMDCT + window + OLA for one channel; mutates overlap in place."""
        FRAME, SHORT, MID = self.F, self.S, self.MID
        seq = info.window_sequence
        wl_cur = tables.long_window(info.window_shape, FRAME)
        ws_cur = tables.short_window(info.window_shape, SHORT)
        wl_prev = tables.long_window(info.prev_window_shape, FRAME)
        ws_prev = tables.short_window(info.prev_window_shape, SHORT)
        out = np.zeros(FRAME, np.float64)

        if seq != 2:
            buf = self.rnd(tables.imdct_via_dct4(spec))  # [2*FRAME]
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
            blocks = self.rnd(tables.imdct_via_dct4(
                spec.reshape(8, SHORT)))                 # [8, 2*SHORT]
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
        overlap[:] = self.rnd(overlap)
        return self.rnd(out)

    # ------------------------------------------------------------------
    def decode_frame(self, frame: Frame) -> np.ndarray:
        """Returns [n_samples=frame_length, channels] PCM in 1/32768 scale."""
        outs = []
        channel = 0
        for elem in frame.elements:
            if isinstance(elem, SCEData):
                spec = self.dequant(elem.ics)
                self.apply_tns(elem.ics, spec)
                spec = self.rnd(spec)
                pcm = self.filterbank(elem.ics.info, spec,
                                      self.overlaps[channel])
                outs.append(pcm)
                channel += 1
            elif isinstance(elem, CPEData):
                l = self.dequant(elem.left)
                r = self.dequant(elem.right)
                self.apply_ms(elem, l, r)
                self.apply_is(elem, l, r)
                l, r = self.rnd(l), self.rnd(r)
                self.apply_tns(elem.left, l)
                self.apply_tns(elem.right, r)
                l, r = self.rnd(l), self.rnd(r)
                pl = self.filterbank(elem.left.info, l, self.overlaps[channel])
                pr = self.filterbank(elem.right.info, r,
                                     self.overlaps[channel + 1])
                outs.extend([pl, pr])
                channel += 2
        return np.stack(outs, axis=1) / 32768.0
