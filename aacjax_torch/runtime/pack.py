"""Host-side packing: parsed frames -> dense, static-shaped device batches.

This is the boundary where control crosses host->device exactly once per
chunk (SURVEY.md §3.3): ragged, sample-rate-dependent scalefactor bands and
per-band side info are expanded to per-bin [1024] vectors so the device
pipeline is branch-free.  The grouped EIGHT_SHORT layout (bin index =
group_offset + window*128 + swb_offset, ics.js:213-260) is replicated here
exactly; the device never sees band structure.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import functools

import numpy as np

from aacjax_torch.host.syntax import (
    AFTER_IMDCT, AFTER_TNS, BEFORE_TNS, CCEData, ChannelStream, CPEData,
    Frame, ICSInfo, INTENSITY_BT, INTENSITY_BT2, NOISE_BT, SCEData, ZERO_BT,
)
from aacjax_torch.kernels.pipeline import PipelineFlags, TNS_ORDER, TNS_SLOTS

FRAME = 1024


def expand_per_bin(info: ICSInfo, values: np.ndarray,
                   dtype=np.float32) -> np.ndarray:
    """Expand per-(group, sfb) values (idx layout, length group_count *
    max_sfb) to a per-bin [frame_len] vector over the grouped window
    layout (window stride = frame_len // 8)."""
    out = np.zeros(info.frame_len, dtype)
    idx = 0
    group_off = 0
    offsets = info.swb_offsets
    stride = info.short_len
    for g in range(info.group_count):
        glen = int(info.group_length[g])
        for sfb in range(info.max_sfb):
            v = values[idx]
            if v:
                off = int(offsets[sfb])
                width = int(offsets[sfb + 1]) - off
                for w in range(glen):
                    base = group_off + w * stride + off
                    out[base:base + width] = v
            idx += 1
        group_off += glen * stride
    return out


@functools.lru_cache(maxsize=None)
def _iq_lut() -> np.ndarray:
    # float32(pow(i, 4/3) in float64) — identical rounding to the native
    # parser's LUT and libavcodec's cbrt table, so every path (and the
    # Main-profile predictor, which is bit-precision-sensitive) sees the
    # same spectra
    return (np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)
            ).astype(np.float32)


def _inverse_quant(q: np.ndarray) -> np.ndarray:
    """sign(q) * |q|^(4/3) as float32-of-float64 (host-side: the device
    multiplies by the scale; SURVEY.md §7 quirk 5 escape values beyond
    the table range stay exact via the float64 pow)."""
    a = np.abs(q.astype(np.int64))
    lut = _iq_lut()
    small = a < 8192
    mag = np.where(small, lut[np.minimum(a, 8191)],
                   (a.astype(np.float64) ** (4.0 / 3.0)).astype(np.float32))
    return (np.sign(q) * mag).astype(np.float32)


@dataclass
class ChunkBuilder:
    """Accumulates one [C, T] chunk of channel-frames for the device step.
    F is the frame length (1024, or 960 in frameLengthFlag mode)."""
    C: int
    T: int
    F: int = FRAME
    eld: bool = False   # AAC-ELD: low-delay filterbank replaces the IMDCT

    def __post_init__(self):
        C, T, FRAME = self.C, self.T, self.F
        self.quant = np.zeros((C, T, FRAME), np.float32)
        self.scale = np.zeros((C, T, FRAME), np.float32)
        self.noise = np.zeros((C, T, FRAME), np.float32)
        self.f_idx = np.zeros((C, T), np.int32)
        self.s_idx = np.zeros((C, T), np.int32)
        self.shape_idx = np.zeros((C, T), np.int32)
        self.prev_shape_idx = np.zeros((C, T), np.int32)
        self.is_short = np.zeros((C, T), bool)
        # -1 = slot received no frames this chunk (overlap state preserved)
        self.last_valid = np.full(C, -1, np.int32)
        # stereo pairs: (l_slot, r_slot, t) -> per-bin masks
        self._pairs: dict[tuple[int, int], dict] = {}
        # TNS per (c, t)
        self.tns_fwd_lpc = np.zeros((C, T, TNS_SLOTS, TNS_ORDER), np.float32)
        self.tns_fwd_start = np.zeros((C, T, TNS_SLOTS), np.int32)
        self.tns_fwd_end = np.zeros((C, T, TNS_SLOTS), np.int32)
        self.tns_rev_lpc = np.zeros((C, T, TNS_SLOTS, TNS_ORDER), np.float32)
        self.tns_rev_start = np.zeros((C, T, TNS_SLOTS), np.int32)
        self.tns_rev_end = np.zeros((C, T, TNS_SLOTS), np.int32)
        self.has_tns = False
        # CCE FMA lists
        self._cce: dict[str, list] = {'pre': [], 'post': [], 'time': []}
        # Main-profile backward prediction (device stage between M/S and
        # intensity): mode 0 = none, 1 = predict+update (long frame),
        # 2 = reset-all (short frame)
        self.pred_mode = np.zeros((C, T), np.int32)
        self.pred_reset = np.zeros((C, T), np.int32)
        self.pred_nbins = np.zeros((C, T), np.int32)
        self.pred_used = np.zeros((C, T, 672), np.float32)
        self.has_pred = False

    # -- channels ----------------------------------------------------------
    def add_channel_frame(self, slot: int, t: int, ch: ChannelStream,
                          include_tns: bool = True) -> None:
        info = ch.info
        F = self.F
        if info.ltp is not None:
            from aacjax_torch.host.syntax import UnsupportedError
            raise UnsupportedError(
                "AAC-LTP frames decode on the reference path "
                "(aacjax.host.refdec) — decode_adts/AACDecoder route "
                "profile-4 streams there automatically")
        self.quant[slot, t] = _inverse_quant(ch.quant[:F])
        self.scale[slot, t] = ch.scale_bin[:F]
        self.noise[slot, t] = ch.noise_bin[:F]
        seq = info.window_sequence
        self.f_idx[slot, t] = seq * 2 + info.prev_window_shape
        self.s_idx[slot, t] = seq * 2 + info.window_shape
        self.shape_idx[slot, t] = info.window_shape
        self.prev_shape_idx[slot, t] = info.prev_window_shape
        self.is_short[slot, t] = seq == 2
        self.last_valid[slot] = max(self.last_valid[slot], t)
        if info.main_profile:
            self.has_pred = True
            if seq == 2:
                self.pred_mode[slot, t] = 2       # short: reset all
            else:
                self.pred_mode[slot, t] = 1
                self.pred_reset[slot, t] = info.predictor_reset_group
                self.pred_nbins[slot, t] = info.pred_bins
                if info.predictor_present and info.prediction_used is not None:
                    offs = info.swb_offsets
                    for sfb, u in enumerate(info.prediction_used):
                        if u:
                            lo = int(offs[sfb])
                            hi = min(int(offs[sfb + 1]), 672)
                            self.pred_used[slot, t, lo:hi] = 1.0
        if include_tns and ch.tns_filters:
            self.has_tns = True
            nf = nr = 0
            for f in ch.tns_filters:
                if f.inc == 1:
                    self.tns_fwd_lpc[slot, t, nf, :f.order] = f.lpc
                    self.tns_fwd_start[slot, t, nf] = f.start
                    self.tns_fwd_end[slot, t, nf] = f.end
                    nf += 1
                else:
                    # reversed filter: transformed coordinates on the
                    # flipped spectrum (see kernels.pipeline.tns)
                    self.tns_rev_lpc[slot, t, nr, :f.order] = f.lpc
                    self.tns_rev_start[slot, t, nr] = self.F - f.end
                    self.tns_rev_end[slot, t, nr] = self.F - f.start
                    nr += 1

    # -- stereo ------------------------------------------------------------
    def add_cpe_frame(self, slot_l: int, slot_r: int, t: int,
                      cpe: CPEData) -> None:
        self.add_channel_frame(slot_l, t, cpe.left)
        self.add_channel_frame(slot_r, t, cpe.right)
        key = (slot_l, slot_r)
        if key not in self._pairs:
            self._pairs[key] = {
                'ms': np.zeros((self.T, self.F), np.float32),
                'is': np.zeros((self.T, self.F), np.float32),
            }
        p = self._pairs[key]

        left, right = cpe.left, cpe.right
        info_l = left.info
        n_idx = info_l.group_count * info_l.max_sfb

        if cpe.common_window and cpe.mask_present:
            # M/S applies where ms_used and neither band is noise/intensity
            # (decoder.js:391).
            ms_vals = np.zeros(n_idx, np.float32)
            for idx in range(n_idx):
                if (cpe.ms_used[idx]
                        and left.band_types[idx] < NOISE_BT
                        and right.band_types[idx] < NOISE_BT):
                    ms_vals[idx] = 1.0
            p['ms'][t] = expand_per_bin(info_l, ms_vals)

        # Intensity uses the right channel's band types / positions
        # (decoder.js:337-376).
        info_r = right.info
        n_idx_r = info_r.group_count * info_r.max_sfb
        is_vals = np.zeros(n_idx_r, np.float32)
        any_is = False
        for idx in range(n_idx_r):
            bt = int(right.band_types[idx])
            if bt in (INTENSITY_BT, INTENSITY_BT2):
                c = 1.0 if bt == INTENSITY_BT else -1.0
                if cpe.mask_present and cpe.ms_used[idx]:
                    c = -c
                is_vals[idx] = c * float(right.sf_gain[idx])
                any_is = True
        if any_is:
            p['is'][t] = expand_per_bin(info_r, is_vals)

    # -- coupling ----------------------------------------------------------
    def add_cce_frame(self, cce_slot: int, t: int, cce: CCEData,
                      targets: list[tuple[int, int, int]]) -> None:
        """targets: list of (dst_slot, gain_index) resolved by the caller
        via resolve_cce_targets().  The coupling channel's own TNS side
        info is not applied, matching the reference (which never runs
        TNS.process on a CCE's ICStream)."""
        self.add_channel_frame(cce_slot, t, cce.ics, include_tns=False)
        for dst_slot, gain_idx in targets:
            if cce.coupling_point == AFTER_IMDCT:
                g = float(cce.gain[gain_idx][0])
                self._cce['time'].append((cce_slot, dst_slot, t, g))
            else:
                gain_bin = expand_per_bin(cce.ics.info, cce.gain[gain_idx])
                which = 'pre' if cce.coupling_point == BEFORE_TNS else 'post'
                self._cce[which].append((cce_slot, dst_slot, t, gain_bin))

    # -- finalize ----------------------------------------------------------
    def finish(self) -> tuple[dict, PipelineFlags]:
        pairs = list(self._pairs.items()) or [((0, 0), {
            'ms': np.zeros((self.T, self.F), np.float32),
            'is': np.zeros((self.T, self.F), np.float32)})]
        P = len(pairs)
        pair_l = np.array([k[0] for k, _ in pairs], np.int32)
        pair_r = np.array([k[1] for k, _ in pairs], np.int32)
        ms_mask = np.stack([v['ms'] for _, v in pairs])
        is_scale = np.stack([v['is'] for _, v in pairs])

        batch = dict(
            quant=self.quant, scale=self.scale, noise=self.noise,
            f_idx=self.f_idx, s_idx=self.s_idx, shape_idx=self.shape_idx,
            prev_shape_idx=self.prev_shape_idx, is_short=self.is_short,
            last_valid=self.last_valid,
            pair_l=pair_l, pair_r=pair_r,
            ms_mask=ms_mask, is_scale=is_scale,
        )
        flags = PipelineFlags(has_stereo=True, has_tns=self.has_tns,
                              has_cce=any(self._cce.values()),
                              has_pred=self.has_pred,
                              has_short=bool(self.is_short.any()),
                              eld=self.eld)
        if flags.has_pred:
            batch.update(pred_mode=self.pred_mode, pred_reset=self.pred_reset,
                         pred_nbins=self.pred_nbins, pred_used=self.pred_used)
        if flags.has_tns:
            batch.update(
                tns_fwd_lpc=self.tns_fwd_lpc, tns_fwd_start=self.tns_fwd_start,
                tns_fwd_end=self.tns_fwd_end, tns_rev_lpc=self.tns_rev_lpc,
                tns_rev_start=self.tns_rev_start, tns_rev_end=self.tns_rev_end)
        if flags.has_cce:
            for which, key in (('pre', 'pre'), ('post', 'post')):
                entries = self._cce[which]
                Q = max(len(entries), 1)
                src = np.zeros(Q, np.int32)
                dst = np.zeros(Q, np.int32)
                gain = np.zeros((Q, self.T, self.F), np.float32)
                for q, (s, d, t, g) in enumerate(entries):
                    src[q], dst[q] = s, d
                    gain[q, t] = g
                batch[f'cce_src_{key}'] = src
                batch[f'cce_dst_{key}'] = dst
                batch[f'cce_gain_{key}'] = gain
            entries = self._cce['time']
            Q = max(len(entries), 1)
            src = np.zeros(Q, np.int32)
            dst = np.zeros(Q, np.int32)
            gain = np.zeros((Q, self.T, 1), np.float32)
            for q, (s, d, t, g) in enumerate(entries):
                src[q], dst[q] = s, d
                gain[q, t, 0] = g
            batch['cce_src_time'] = src
            batch['cce_dst_time'] = dst
            batch['cce_gain_time'] = gain
        return batch, flags


def resolve_cce_targets(cce: CCEData, elements: list,
                        slot_of_element: list[tuple[int, ...]]
                        ) -> list[tuple[int, int]]:
    """Replicates the reference's gain-index bookkeeping
    (decoder.js:406-433 applyChannelCoupling): walks the coupled-target
    list maintaining the running gain index; returns (dst_slot, gain_idx)
    pairs for every matching element channel.

    Reference chSelect semantics kept as-is: 1 -> second channel of the
    pair, 2 -> first channel (and SCE), 0 -> both with one gain, 3 -> both
    with separate gains.
    """
    out: list[tuple[int, int]] = []
    for elem, slots in zip(elements, slot_of_element):
        is_pair = isinstance(elem, CPEData)
        index = 0
        for c in range(cce.coupled_count + 1):
            ch_select = int(cce.ch_select[c])
            if (bool(cce.channel_pair[c]) == is_pair
                    and int(cce.id_select[c]) == elem.id):
                if ch_select != 1:
                    out.append((slots[0], index))
                    if ch_select:
                        index += 1
                if ch_select != 2:
                    out.append((slots[1] if len(slots) > 1 else slots[0],
                                index))
                    index += 1
            else:
                index += 1 + (1 if ch_select == 3 else 0)
    return out


class SlotOverflowError(Exception):
    """A frame carries more element channels (incl. CCEs) than the slots
    allocated for its stream — raise with the fix instead of corrupting a
    neighbouring stream's slots (or indexing past C)."""


def pack_frames(frames_per_slot_base: list[tuple[int, list[Frame]]],
                C: int, T: int,
                slot_limits: list[int] | None = None,
                frame_len: int = FRAME,
                eld: bool = False) -> tuple[dict, PipelineFlags]:
    """Pack multiple streams' frames into one chunk.

    frames_per_slot_base: list of (base_slot, frames) per stream; each
    frame's elements are assigned slots sequentially from base_slot in
    element order (decoder.js:218-248 channel assignment).  CCE elements
    get slots after the stream's regular channels.

    slot_limits: optional per-stream slot budgets (parallel list); when
    omitted each stream may use every slot from its base to C.
    """
    b = ChunkBuilder(C, T, frame_len, eld)
    for s, (base, frames) in enumerate(frames_per_slot_base):
        budget = (slot_limits[s] if slot_limits is not None else C - base)
        for t, frame in enumerate(frames):
            if frame is None:
                continue
            slot = base
            slot_of_element = []
            n_ch = sum(2 if isinstance(e, CPEData) else 1
                       for e in frame.elements) + len(frame.cces)
            if n_ch > budget:
                raise SlotOverflowError(
                    f"frame has {n_ch} element channels (incl. "
                    f"{len(frame.cces)} CCEs) but the stream has {budget} "
                    "slots; raise cce_slots (BatchDecoder/decode_adts) to "
                    "cover coupling channels")
            for elem in frame.elements:
                if isinstance(elem, SCEData):
                    slot_of_element.append((slot,))
                    b.add_channel_frame(slot, t, elem.ics)
                    slot += 1
                elif isinstance(elem, CPEData):
                    slot_of_element.append((slot, slot + 1))
                    b.add_cpe_frame(slot, slot + 1, t, elem)
                    slot += 2
            for cce in frame.cces:
                targets = resolve_cce_targets(cce, frame.elements,
                                              slot_of_element)
                b.add_cce_frame(slot, t, cce, targets)
                slot += 1
    return b.finish()
