"""Syntactic element parsing: raw_data_block -> structured per-channel data.

Host-side serial layer (SURVEY.md §1 L3/L4).  Walks the element loop
(SCE/CPE/CCE/LFE/DSE/FIL/END — reference decoder.js:125-198), parses ICS
side info + spectral Huffman data (ics.js), CPE stereo masks (cpe.js), CCE
coupling gains (cce.js) and TNS side info (tns.js:68-103).  Output is
integer quantized spectra plus dense side-info arrays; all dense math
(dequantization, stereo tools, TNS filtering, IMDCT synthesis) happens
downstream on device (aacjax.kernels) or in the numpy reference path
(tests/model_decoder.py).

Deliberate divergences from the reference (all spec-correct, documented in
SURVEY.md §7 "bit-exactness vs spec-correctness"):
  - pulse data is *applied* (reference throws at ics.js:263-265),
  - TNS filter regions follow ISO/IEC 14496-3 (the reference's region
    arithmetic NaNs out, making its TNS a silent no-op: tns.js:122 uses
    `tmp` where `top` is meant, and reads `ics.maxSFB` which is undefined),
  - dependent-coupling band bounds use swbOffsets[sfb+1] (cce.js:149
    references an undefined variable and would crash).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host import huffman
from aacjax_torch.host.adts import read_header
from aacjax_torch.host.asc import StreamConfig, UnsupportedError
from aacjax_torch.host.bitio import BitReader, BitstreamError

# Band types (ics.js:37-42)
ZERO_BT = 0
FIRST_PAIR_BT = 5
ESC_BT = 11
NOISE_BT = 13
INTENSITY_BT2 = 14
INTENSITY_BT = 15

# Window sequences (ics.js:44-47)
ONLY_LONG_SEQUENCE = 0
LONG_START_SEQUENCE = 1
EIGHT_SHORT_SEQUENCE = 2
LONG_STOP_SEQUENCE = 3

# Elements (decoder.js:115-122)
SCE_ELEMENT = 0
CPE_ELEMENT = 1
CCE_ELEMENT = 2
LFE_ELEMENT = 3
DSE_ELEMENT = 4
PCE_ELEMENT = 5
FIL_ELEMENT = 6
END_ELEMENT = 7

MAX_SECTIONS = 120
SF_DELTA = 60
SF_OFFSET = 200

FRAME_LEN = 1024
TNS_MAX_ORDER = 20

# Coupling points (cce.js:33-35)
BEFORE_TNS = 0
AFTER_TNS = 1
AFTER_IMDCT = 2

CCE_SCALE = (1.09050773266525765921, 1.18920711500272106672,
             1.4142135623730950488016887, 2.0)


def _lcg_step(state: int) -> int:
    """One step of the PNS LCG: state*1664525 + 1013904223 with signed
    32-bit wraparound (the standard Numerical-Recipes LCG the reference
    clearly intended).

    Spec-correct divergence: the reference's parenthesization multiplies
    by the *sum* (1664525 + 1013904223) — an even number — so its state
    collapses to exactly 0 within <= 16 steps, after which band energy is
    0 and the 1/sqrt(energy) normalization turns every later PNS band
    into NaNs (ics.js:234, 239).  Reference PNS output is therefore NaN
    on any real stream and cannot be a parity target (SURVEY.md §7)."""
    v = (state * 1664525 + 1013904223) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


@dataclass
class ICSInfo:
    """Per-channel window/grouping side info (ics.js:270-314)."""
    window_sequence: int = ONLY_LONG_SEQUENCE
    window_shape: int = 0            # this frame's shape bit
    prev_window_shape: int = 0       # previous frame's shape (persisted by runtime)
    max_sfb: int = 0
    group_count: int = 1
    group_length: np.ndarray = field(default_factory=lambda: np.ones(8, np.int32))
    window_count: int = 1
    swb_offsets: np.ndarray | None = None
    swb_count: int = 0
    frame_len: int = FRAME_LEN       # 1024, or 960 in frameLengthFlag mode
    short_len: int = 128             # frame_len // 8 (120 in 960 mode)
    # Main-profile backward prediction (absent upstream: ics.js has no
    # predictor parse; decoder throws on the bit)
    predictor_present: bool = False
    predictor_reset_group: int = 0   # 0 = no group reset this frame
    prediction_used: np.ndarray | None = None   # [sfb] bools
    pred_bins: int = 0               # state bins = swb_offset[pred_sfb_max]
    main_profile: bool = False       # stream is AOT 1 (predictor active)
    ltp: "LTPData | None" = None     # AOT 4 long-term prediction data

    def decode(self, stream: BitReader, config: StreamConfig,
               common_window: bool, prev_shape: int) -> None:
        stream.advance(1)  # ics_reserved_bit
        self.window_sequence = stream.read(2)
        self.prev_window_shape = prev_shape
        self.window_shape = stream.read(1)
        if config.profile == 23 and self.window_sequence != ONLY_LONG_SEQUENCE:
            # AAC-LD frames are always long (ISO/IEC 14496-3 §4.6.20.2;
            # shape selects sine vs low-overlap instead of sine vs KBD)
            raise BitstreamError(
                f"window_sequence {self.window_sequence} in AAC-LD")
        self.group_count = 1
        self.group_length = np.zeros(8, np.int32)
        self.group_length[0] = 1
        self.frame_len = config.frame_length
        self.short_len = config.short_length
        if self.window_sequence == EIGHT_SHORT_SEQUENCE:
            self.max_sfb = stream.read(4)
            for _ in range(7):
                if stream.read(1):
                    self.group_length[self.group_count - 1] += 1
                else:
                    self.group_count += 1
                    self.group_length[self.group_count - 1] = 1
            self.window_count = 8
            self.swb_offsets = config.swb_offsets_short
            self.swb_count = config.swb_count_short
        else:
            self.max_sfb = stream.read(6)
            self.window_count = 1
            self.swb_offsets = config.swb_offsets_long
            self.swb_count = config.swb_count_long
            if stream.read(1):  # predictor_data_present
                from aacjax_torch.host.asc import AOT_AAC_LTP, AOT_AAC_MAIN
                self.predictor_present = True
                if config.profile == AOT_AAC_MAIN:
                    # Main-profile backward prediction (ISO/IEC 14496-3
                    # §4.6.2.1; libavcodec decode_prediction semantics)
                    if stream.read(1):  # predictor_reset
                        self.predictor_reset_group = stream.read(5)
                        if not 1 <= self.predictor_reset_group <= 30:
                            raise BitstreamError(
                                "invalid predictor reset group")
                    n = min(self.max_sfb, config.pred_sfb_max)
                    self.prediction_used = np.array(
                        [bool(stream.read(1)) for _ in range(n)])
                elif config.profile == AOT_AAC_LTP:
                    if stream.read(1):  # ltp_data_present
                        self.ltp = read_ltp_data(stream, self.max_sfb)
                elif config.profile == 23:
                    # LD LTP uses a different lag coding (§4.6.20.3);
                    # libavcodec also rejects it (decode_ics_info)
                    raise UnsupportedError("LTP in ER AAC-LD not supported")
                else:
                    raise UnsupportedError(
                        "prediction data in a non-predictive profile")
        if self.max_sfb > self.swb_count:
            raise BitstreamError(
                f"max_sfb {self.max_sfb} > swb_count {self.swb_count}")
        self.main_profile = config.profile == 1  # AOT_AAC_MAIN
        if self.main_profile and self.window_sequence != EIGHT_SHORT_SEQUENCE:
            self.pred_bins = min(672, int(self.swb_offsets[
                min(config.pred_sfb_max, self.swb_count)]))

    def decode_eld(self, stream: BitReader, config: StreamConfig) -> None:
        """AAC-ELD ics_info (ISO/IEC 14496-3 §4.6.20.3): the window is
        always the low-delay filterbank's single shape, so the side info
        reduces to max_sfb."""
        self.window_sequence = ONLY_LONG_SEQUENCE
        self.window_shape = 0
        self.prev_window_shape = 0
        self.group_count = 1
        self.group_length = np.zeros(8, np.int32)
        self.group_length[0] = 1
        self.window_count = 1
        self.frame_len = config.frame_length
        self.short_len = config.short_length
        self.max_sfb = stream.read(6)
        self.swb_offsets = config.swb_offsets_long
        self.swb_count = config.swb_count_long
        if self.max_sfb > self.swb_count:
            raise BitstreamError(
                f"max_sfb {self.max_sfb} > swb_count {self.swb_count}")


@dataclass
class LTPData:
    """AAC-LTP side info (ISO/IEC 14496-3 §4.6.6; ltp_data())."""
    lag: int
    coef_idx: int
    used: np.ndarray        # [min(max_sfb, 40)] bools


def read_ltp_data(stream: BitReader, max_sfb: int) -> LTPData:
    lag = stream.read(11)
    coef_idx = stream.read(3)
    used = np.array([bool(stream.read(1))
                     for _ in range(min(max_sfb, 40))])
    return LTPData(lag=lag, coef_idx=coef_idx, used=used)


@dataclass
class TnsFilter:
    """One TNS filter resolved to absolute spectral-bin coordinates."""
    start: int                # first bin (within the 1024-coef frame layout)
    end: int                  # one past last bin
    inc: int                  # +1 forward, -1 reverse (tns.js:149-152)
    order: int
    lpc: np.ndarray           # [order] float32 direct-form coefficients


class TNSData:
    """TNS side info for one channel (tns.js:68-103) + LPC conversion."""

    def __init__(self):
        self.n_filt = np.zeros(8, np.int32)
        self.length = np.zeros((8, 4), np.int32)
        self.direction = np.zeros((8, 4), np.int32)
        self.order = np.zeros((8, 4), np.int32)
        self.coef = np.zeros((8, 4, TNS_MAX_ORDER), np.float32)

    def decode(self, stream: BitReader, info: ICSInfo) -> None:
        short = info.window_sequence == EIGHT_SHORT_SEQUENCE
        nfilt_bits, len_bits, ord_bits = (1, 4, 3) if short else (2, 6, 5)
        for w in range(info.window_count):
            self.n_filt[w] = stream.read(nfilt_bits)
            if not self.n_filt[w]:
                continue
            coef_res = stream.read(1)
            for filt in range(self.n_filt[w]):
                self.length[w, filt] = stream.read(len_bits)
                self.order[w, filt] = stream.read(ord_bits)
                if self.order[w, filt] > TNS_MAX_ORDER:
                    raise BitstreamError(
                        f"TNS filter out of range: {self.order[w, filt]}")
                if self.order[w, filt]:
                    self.direction[w, filt] = stream.read(1)
                    coef_compress = stream.read(1)
                    coef_len = coef_res + 3 - coef_compress
                    table = tables.TNS_TABLES[2 * coef_compress + coef_res]
                    for i in range(self.order[w, filt]):
                        self.coef[w, filt, i] = table[stream.read(coef_len)]

    def resolve_filters(self, info: ICSInfo, max_bands: int) -> list[TnsFilter]:
        """Convert side info to absolute-bin filters with direct-form LPC.

        Spec-correct region arithmetic (ISO/IEC 14496-3 §4.6.9; cf. FAAD2's
        tns_decode_frame): bands partition top-down from swb_count.
        """
        filters: list[TnsFilter] = []
        mmm = min(max_bands, info.max_sfb)
        for w in range(info.window_count):
            bottom = info.swb_count
            for filt in range(self.n_filt[w]):
                top = bottom
                bottom = max(0, top - int(self.length[w, filt]))
                order = int(self.order[w, filt])
                if order == 0:
                    continue
                lpc = _reflection_to_lpc(self.coef[w, filt, :order])
                start = int(info.swb_offsets[min(bottom, mmm)])
                end = int(info.swb_offsets[min(top, mmm)])
                if end - start <= 0:
                    continue
                inc = -1 if self.direction[w, filt] else 1
                filters.append(TnsFilter(
                    start=start + w * info.short_len,
                    end=end + w * info.short_len,
                    inc=inc, order=order, lpc=lpc))
        return filters


def _reflection_to_lpc(refl: np.ndarray) -> np.ndarray:
    """Levinson-style conversion of quantized reflection coefficients to
    direct-form LPC coefficients (tns.js:127-140 semantics)."""
    order = len(refl)
    lpc = np.zeros(order, np.float64)
    for i in range(order):
        r = -float(refl[i])
        lpc_prev = lpc.copy()
        lpc[i] = r
        for j in range((i + 1) // 2):
            f = lpc_prev[j]
            b = lpc_prev[i - 1 - j]
            lpc[j] = f + r * b
            lpc[i - 1 - j] = b + r * f
    return lpc.astype(np.float32)


@dataclass
class ChannelStream:
    """Parsed ICS: quantized spectrum + expanded side info for one channel."""
    info: ICSInfo
    global_gain: int = 0
    band_types: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SECTIONS, np.int32))
    sect_end: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SECTIONS, np.int32))
    sf_gain: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SECTIONS, np.float32))
    # Intensity positions are carried as the *gain* like the reference
    # (scaleFactors doubles as intensity scale, ics.js:144).
    quant: np.ndarray = field(
        default_factory=lambda: np.zeros(FRAME_LEN, np.int32))
    scale_bin: np.ndarray = field(
        default_factory=lambda: np.zeros(FRAME_LEN, np.float32))
    noise_bin: np.ndarray = field(
        default_factory=lambda: np.zeros(FRAME_LEN, np.float32))
    tns_filters: list[TnsFilter] = field(default_factory=list)
    tns_present: bool = False
    pulse_present: bool = False

    def band_bins(self, g: int, sfb: int) -> tuple[int, int, int]:
        """(group_offset, band_offset_in_window, width) for group g, band sfb."""
        info = self.info
        group_off = int(np.sum(info.group_length[:g])) * info.short_len
        off = int(info.swb_offsets[sfb])
        width = int(info.swb_offsets[sfb + 1] - info.swb_offsets[sfb])
        return group_off, off, width


class ICSDecoder:
    """Decodes one individual_channel_stream (ics.js:56-266)."""

    def __init__(self, config: StreamConfig):
        self.config = config

    def decode(self, stream: BitReader, common_info: ICSInfo | None,
               prev_shape: int) -> ChannelStream:
        info = common_info if common_info is not None else ICSInfo()
        ch = ChannelStream(info=info)
        ch.global_gain = stream.read(8)
        eld = self.config.profile == 39
        if common_info is None:
            if eld:
                info.decode_eld(stream, self.config)
            else:
                info.decode(stream, self.config, False, prev_shape)
        self._decode_band_types(stream, ch)
        self._decode_scale_factors(stream, ch)
        if eld:
            # ELD individual_channel_stream (§4.6.20.2): no pulse bit and
            # no gain-control bit; tns_data follows its flag directly
            ch.tns_present = bool(stream.read(1))
            tns = TNSData()
            if ch.tns_present:
                tns.decode(stream, info)
            self._decode_spectral(stream, ch)
            if ch.tns_present:
                ch.tns_filters = tns.resolve_filters(
                    info, int(self.config.tns_max_bands_ld))
            return ch
        er = self.config.profile in (17, 23)  # ER syntax ordering
        ch.pulse_present = bool(stream.read(1))
        pulse = None
        if ch.pulse_present:
            if er:
                raise BitstreamError("Pulse tool not allowed in ER AAC")
            if info.window_sequence == EIGHT_SHORT_SEQUENCE:
                raise BitstreamError(
                    "Pulse tool not allowed in eight short sequence.")
            pulse = self._decode_pulse(stream, ch)
        ch.tns_present = bool(stream.read(1))
        tns = TNSData()
        if ch.tns_present and not er:
            tns.decode(stream, info)
        if stream.read(1):  # gain control (SSR)
            raise UnsupportedError("gain control/SSR not supported")
        if ch.tns_present and er:
            # ER syntax: tns_data follows the gain-control bit
            tns.decode(stream, info)
        self._decode_spectral(stream, ch)
        if pulse is not None:
            self._apply_pulse(ch, pulse)
        if ch.tns_present:
            if self.config.profile == 23:
                max_bands = self.config.tns_max_bands_ld
            else:
                max_bands = int((tables.TNS_MAX_BANDS_128
                                 if info.window_sequence
                                 == EIGHT_SHORT_SEQUENCE
                                 else tables.TNS_MAX_BANDS_1024)
                                [self.config.sample_index])
            ch.tns_filters = tns.resolve_filters(info, int(max_bands))
        return ch

    # -- section data (ics.js:83-116) --------------------------------------
    def _decode_band_types(self, stream: BitReader, ch: ChannelStream) -> None:
        info = ch.info
        bits = 3 if info.window_sequence == EIGHT_SHORT_SEQUENCE else 5
        escape = (1 << bits) - 1
        idx = 0
        for _g in range(info.group_count):
            k = 0
            while k < info.max_sfb:
                end = k
                band_type = stream.read(4)
                if band_type == 12:
                    raise BitstreamError("Invalid band type: 12")
                while True:
                    incr = stream.read(bits)
                    end += incr
                    if incr != escape:
                        break
                if end > info.max_sfb:
                    raise BitstreamError(
                        f"Too many bands ({end} > {info.max_sfb})")
                while k < end:
                    ch.band_types[idx] = band_type
                    ch.sect_end[idx] = end
                    idx += 1
                    k += 1

    # -- scalefactors (ics.js:118-173) --------------------------------------
    def _decode_scale_factors(self, stream: BitReader, ch: ChannelStream) -> None:
        info = ch.info
        offset = [ch.global_gain, ch.global_gain - 90, 0]  # spectrum/noise/IS
        noise_flag = True
        idx = 0
        for _g in range(info.group_count):
            i = 0
            while i < info.max_sfb:
                run_end = int(ch.sect_end[idx])
                bt = int(ch.band_types[idx])
                if bt == ZERO_BT:
                    while i < run_end:
                        ch.sf_gain[idx] = 0.0
                        i += 1
                        idx += 1
                elif bt in (INTENSITY_BT, INTENSITY_BT2):
                    while i < run_end:
                        offset[2] += huffman.decode_scalefactor(stream) - SF_DELTA
                        tmp = min(max(offset[2], -155), 100)
                        ch.sf_gain[idx] = np.float32(
                            tables.scalefactor_gain(-tmp + SF_OFFSET))
                        i += 1
                        idx += 1
                elif bt == NOISE_BT:
                    while i < run_end:
                        if noise_flag:
                            offset[1] += stream.read(9) - 256
                            noise_flag = False
                        else:
                            offset[1] += huffman.decode_scalefactor(stream) - SF_DELTA
                        tmp = min(max(offset[1], -100), 155)
                        ch.sf_gain[idx] = np.float32(
                            -tables.scalefactor_gain(tmp + SF_OFFSET))
                        i += 1
                        idx += 1
                else:
                    while i < run_end:
                        offset[0] += huffman.decode_scalefactor(stream) - SF_DELTA
                        if offset[0] > 255:
                            raise BitstreamError(
                                f"Scalefactor out of range: {offset[0]}")
                        ch.sf_gain[idx] = np.float32(
                            tables.scalefactor_gain(offset[0] - 100 + SF_OFFSET))
                        i += 1
                        idx += 1

    # -- pulse data (ics.js:175-201; application is spec-correct) -----------
    def _decode_pulse(self, stream: BitReader, ch: ChannelStream):
        info = ch.info
        pulse_count = stream.read(2) + 1
        pulse_swb = stream.read(6)
        if pulse_swb >= info.swb_count:
            raise BitstreamError(f"Pulse SWB out of range: {pulse_swb}")
        offsets = np.zeros(pulse_count, np.int32)
        amps = np.zeros(pulse_count, np.int32)
        offsets[0] = int(info.swb_offsets[pulse_swb]) + stream.read(5)
        amps[0] = stream.read(4)
        if offsets[0] > 1023:
            raise BitstreamError(f"Pulse offset out of range: {offsets[0]}")
        for i in range(1, pulse_count):
            offsets[i] = stream.read(5) + offsets[i - 1]
            if offsets[i] > 1023:
                raise BitstreamError(f"Pulse offset out of range: {offsets[i]}")
            amps[i] = stream.read(4)
        return offsets, amps

    def _apply_pulse(self, ch: ChannelStream, pulse) -> None:
        """ISO/IEC 14496-3 §4.6.3.3: add pulse amplitude to |quant|,
        preserving the coefficient's sign.  (The reference throws instead:
        ics.js:263-265.)"""
        offsets, amps = pulse
        for off, amp in zip(offsets, amps):
            q = int(ch.quant[off])
            if q < 0:
                ch.quant[off] = q - int(amp)
            else:
                ch.quant[off] = q + int(amp)

    # -- spectral data (ics.js:203-266) --------------------------------------
    def _decode_spectral(self, stream: BitReader, ch: ChannelStream) -> None:
        info = ch.info
        buf = [0, 0, 0, 0]
        # Fresh PNS LCG state per channel-frame, like the reference, which
        # allocates a new ICStream every frame (decoder.js:145, ics.js:32).
        random_state = 0x1F2E3D4C
        group_off = 0
        idx = 0
        for g in range(info.group_count):
            group_len = int(info.group_length[g])
            for sfb in range(info.max_sfb):
                hcb = int(ch.band_types[idx])
                off0 = group_off + int(info.swb_offsets[sfb])
                width = int(info.swb_offsets[sfb + 1] - info.swb_offsets[sfb])
                if hcb in (ZERO_BT, INTENSITY_BT, INTENSITY_BT2):
                    pass  # quant already zero
                elif hcb == NOISE_BT:
                    off = off0
                    for _group in range(group_len):
                        vals = np.zeros(width, np.float32)
                        for k in range(width):
                            # Standard LCG, a spec-correct divergence: the
                            # reference's parenthesization at ics.js:234
                            # multiplies by the SUM (1664525 + 1013904223)
                            # and NaNs out — see _lcg_step's docstring.
                            random_state = _lcg_step(random_state)
                            vals[k] = np.float32(random_state)
                        energy = float(np.sum(vals.astype(np.float64) ** 2))
                        scale = float(ch.sf_gain[idx]) / np.sqrt(energy)
                        ch.noise_bin[off:off + width] = (
                            vals * np.float32(scale))
                        off += info.short_len
                else:
                    num = 2 if hcb >= FIRST_PAIR_BT else 4
                    off = off0
                    for _group in range(group_len):
                        for k in range(0, width, num):
                            huffman.decode_spectral(stream, hcb, buf)
                            for j in range(num):
                                ch.quant[off + k + j] = buf[j]
                        ch.scale_bin[off:off + width] = ch.sf_gain[idx]
                        off += info.short_len
                idx += 1
            group_off += group_len * info.short_len


@dataclass
class CPEData:
    """Parsed channel_pair_element (cpe.js)."""
    left: ChannelStream
    right: ChannelStream
    common_window: bool
    mask_present: bool
    ms_used: np.ndarray  # [128] bool, idx layout group*max_sfb
    id: int = 0
    sbr: object = None   # SBRFrame when a FIL SBR extension followed


@dataclass
class CCEData:
    """Parsed coupling_channel_element (cce.js)."""
    ics: ChannelStream
    coupling_point: int
    coupled_count: int
    channel_pair: np.ndarray
    id_select: np.ndarray
    ch_select: np.ndarray
    gain: list[np.ndarray]  # per gain index: [120] float32 per-band gains
    id: int = 0


@dataclass
class SCEData:
    ics: ChannelStream
    id: int = 0
    is_lfe: bool = False
    sbr: object = None   # SBRFrame when a FIL SBR extension followed


@dataclass
class DRCInfo:
    """dynamic_range_info (ISO/IEC 14496-3 §4.5.2.7) from a FIL
    extension_payload with extension_type EXT_DYNAMIC_RANGE.  The
    reference skips every FIL payload (decoder.js:187-193)."""
    pce_tag: int = -1                    # -1 = not present
    excluded: np.ndarray | None = None   # bool per channel, None = none
    band_top: np.ndarray = None          # exclusive tops, spectral bins
    gain_db: np.ndarray = None           # per band, dyn_rng 0.25 dB steps
    interpolation_scheme: int = 0
    prog_ref_level: int = -1             # -1 = not present


EXT_DYNAMIC_RANGE = 11


def read_drc_info(stream: BitReader, frame_len: int = 1024) -> DRCInfo:
    """Parse dynamic_range_info following its 4-bit extension_type."""
    drc = DRCInfo()
    n_bands = 1
    if stream.read(1):                       # pce_tag_present
        drc.pce_tag = stream.read(4)
        stream.advance(4)                    # drc_tag_reserved_bits
    if stream.read(1):                       # excluded_chns_present
        excluded = [bool(stream.read(1)) for _ in range(7)]
        while stream.read(1):                # additional_excluded_chns
            excluded.extend(bool(stream.read(1)) for _ in range(7))
        drc.excluded = np.array(excluded, bool)
    tops = [frame_len]
    if stream.read(1):                       # drc_bands_present
        band_incr = stream.read(4)
        drc.interpolation_scheme = stream.read(4)
        n_bands = 1 + band_incr
        # band_top[i] is the top of band i in units of 4 spectral lines
        tops = [4 * (stream.read(8) + 1) for _ in range(n_bands)]
        tops[-1] = max(tops[-1], frame_len)  # last band runs to the end
    if stream.read(1):                       # prog_ref_level_present
        drc.prog_ref_level = stream.read(7)
        stream.advance(1)                    # prog_ref_level_reserved_bits
    gains = np.zeros(n_bands)
    for i in range(n_bands):
        sgn = stream.read(1)
        ctl = stream.read(7)
        gains[i] = (-0.25 if sgn else 0.25) * ctl
    drc.band_top = np.asarray(tops, np.int32)
    drc.gain_db = gains
    return drc


@dataclass
class Frame:
    """One parsed raw_data_block."""
    elements: list  # SCEData | CPEData in order
    cces: list[CCEData]
    drc: DRCInfo | None = None


def decode_cpe(stream: BitReader, config: StreamConfig,
               prev_shapes: tuple[int, int], eld: bool = False) -> CPEData:
    """cpe.js:37-75.  ELD CPEs have no common_window bit (it is implied
    true — libavcodec decode_cpe: common_window = eld_syntax || ...)."""
    dec = ICSDecoder(config)
    common_window = True if eld else bool(stream.read(1))
    ms_used = np.zeros(128, bool)
    mask_present = False
    if common_window:
        info = ICSInfo()
        if eld:
            info.decode_eld(stream, config)
        else:
            info.decode(stream, config, True, prev_shapes[0])
        # AAC-LTP: the shared ics_info carries channel 0's ltp_data; the
        # second channel's ltp_data_present bit follows immediately
        # (ISO/IEC 14496-3 cpe syntax; libavcodec decode_cpe)
        right_ltp = None
        if info.predictor_present and config.profile == 4:
            if stream.read(1):
                right_ltp = read_ltp_data(stream, info.max_sfb)
        mask = stream.read(2)
        mask_present = mask != 0
        if mask == 1:
            n = info.group_count * info.max_sfb
            for i in range(n):
                ms_used[i] = bool(stream.read(1))
        elif mask == 2:
            ms_used[:] = True
        elif mask == 3:
            raise BitstreamError("Reserved ms mask type: 3")
        left = dec.decode(stream, info, prev_shapes[0])
        # The right channel shares the ICSInfo fields (cpe.js:43-44) but
        # carries its own previous-window-shape history, so it gets a
        # shallow copy of the info.
        rinfo = copy.copy(info)
        rinfo.prev_window_shape = prev_shapes[1]
        rinfo.ltp = right_ltp
        right = dec.decode(stream, rinfo, prev_shapes[1])
    else:
        left = dec.decode(stream, None, prev_shapes[0])
        right = dec.decode(stream, None, prev_shapes[1])
    return CPEData(left=left, right=right, common_window=common_window,
                   mask_present=mask_present, ms_used=ms_used)


def decode_cce(stream: BitReader, config: StreamConfig) -> CCEData:
    """cce.js:45-119."""
    dec = ICSDecoder(config)
    coupling_point = 2 * stream.read(1)
    coupled_count = stream.read(3)
    channel_pair = np.zeros(8, np.int32)
    id_select = np.zeros(8, np.int32)
    ch_select = np.zeros(8, np.int32)
    gain_count = 0
    for i in range(coupled_count + 1):
        gain_count += 1
        channel_pair[i] = stream.read(1)
        id_select[i] = stream.read(4)
        if channel_pair[i]:
            ch_select[i] = stream.read(2)
            if ch_select[i] == 3:
                gain_count += 1
        else:
            ch_select[i] = 2
    coupling_point += stream.read(1)
    coupling_point |= coupling_point >> 1
    # Normalize the ind_sw encoding {0,1,3} -> {BEFORE_TNS, AFTER_TNS,
    # AFTER_IMDCT}.  (The reference leaves the value at 3, which matches
    # none of its coupling points, so its independently-switched coupling
    # silently never applies — cce.js:69-70 vs cce.js:35.)
    if coupling_point == 3:
        coupling_point = AFTER_IMDCT

    sign = stream.read(1)
    scale = CCE_SCALE[stream.read(2)]
    ics = dec.decode(stream, None, 0)

    group_count = ics.info.group_count
    max_sfb = ics.info.max_sfb
    gains: list[np.ndarray] = []
    for i in range(gain_count):
        cge = 1
        gain = 0
        gain_cache = 1.0
        if i > 0:
            cge = 1 if coupling_point == AFTER_IMDCT else stream.read(1)
            gain = (huffman.decode_scalefactor(stream) - 60) if cge else 0
            gain_cache = float(scale) ** (-gain)
        g_arr = np.zeros(120, np.float32)
        if coupling_point == AFTER_IMDCT:
            g_arr[0] = gain_cache
        else:
            idx = 0
            for _g in range(group_count):
                for _sfb in range(max_sfb):
                    if ics.band_types[idx] != ZERO_BT:
                        if cge == 0:
                            t = huffman.decode_scalefactor(stream) - 60
                            if t != 0:
                                s = 1
                                gain += t
                                t = gain
                                if not sign:
                                    s -= 2 * (t & 0x1)
                                    t >>= 1
                                gain_cache = (float(scale) ** (-t)) * s
                        g_arr[idx] = gain_cache
                    idx += 1
        gains.append(g_arr)
    return CCEData(ics=ics, coupling_point=coupling_point,
                   coupled_count=coupled_count, channel_pair=channel_pair,
                   id_select=id_select, ch_select=ch_select, gain=gains)


# ISO/IEC 14496-3 Table 1.19 element layout per channelConfiguration
# (ER raw_data_blocks carry these in fixed order with no id tags)
_ER_LAYOUTS = {
    1: ("SCE",),
    2: ("CPE",),
    3: ("SCE", "CPE"),
    4: ("SCE", "CPE", "SCE"),
    5: ("SCE", "CPE", "CPE"),
    6: ("SCE", "CPE", "CPE", "LFE"),
    7: ("SCE", "CPE", "CPE", "CPE", "LFE"),
}


def decode_er_frame(stream: BitReader, config: StreamConfig,
                    prev_shapes: list[int]) -> Frame:
    """Parse one ER raw_data_block (ER AAC-LC/LD/ELD, AOT 17/23/39):
    channel elements come in the fixed Table-1.19 order for the
    channelConfiguration, with no END element (the reference rejects
    every ER profile).  AOT 17/23 prefix each element with a 4-bit
    instance tag; ELD carries no tags at all (libavcodec
    aac_decode_er_frame: skip_bits(gb, 4) only when !eld_syntax)."""
    layout = _ER_LAYOUTS.get(config.chan_config)
    if layout is None:
        raise UnsupportedError(
            f"ER channelConfiguration {config.chan_config} not supported")
    eld = config.profile == 39
    elements = []
    channel = 0
    for kind in layout:
        tag = 0 if eld else stream.read(4)
        if kind in ("SCE", "LFE"):
            dec = ICSDecoder(config)
            prev = (prev_shapes[channel]
                    if channel < len(prev_shapes) else 0)
            ics = dec.decode(stream, None, prev)
            elements.append(SCEData(ics=ics, id=tag, is_lfe=kind == "LFE"))
            channel += 1
        else:
            shapes = tuple(
                prev_shapes[channel + k]
                if channel + k < len(prev_shapes) else 0 for k in range(2))
            cpe = decode_cpe(stream, config, shapes, eld=eld)
            cpe.id = tag
            elements.append(cpe)
            channel += 2
    stream.align()  # raw_data_blocks are byte-aligned in every transport
    return Frame(elements=elements, cces=[])


def decode_frame(stream: BitReader, config: StreamConfig,
                 prev_shapes: list[int], sbr_ctx=None,
                 drc_scale: float = 0.0, adts_state: dict | None = None
                 ) -> Frame:
    """Parse one raw_data_block (decoder.js:125-201 element loop).

    prev_shapes: per-decoder-channel previous window shapes (persisted by
    the caller across frames; spec-correct divergence — the reference
    effectively always uses shape 0 for the previous half because it
    recreates ICStream objects per frame, decoder.js:145).

    sbr_ctx: optional aacjax.host.sbr.SBRContext; when given, FIL
    extension payloads carrying SBR data (HE-AAC implicit signaling) are
    parsed and attached to the preceding SCE/CPE element instead of being
    skipped (the reference throws on any SBR content, decoder.js:279-280).

    adts_state: optional mutable dict a streaming caller persists across
    calls so protected multi-rdb ADTS frames parse correctly: the header
    records how many raw_data_blocks follow and whether each carries a
    trailing 16-bit adts_raw_data_block_error_check (13818-7 §6.2),
    which this parser then consumes after the block's byte-align.
    """
    if config.profile in (17, 23, 39):  # ER profiles: fixed layout, no SBR
        return decode_er_frame(stream, config, prev_shapes)
    # interleaved ADTS header (decoder.js:128-130)
    if stream.bits_left >= 12 and stream.peek(12) == 0xFFF:
        hdr = read_header(stream)
        if adts_state is not None:
            adts_state["blocks_left"] = hdr.num_frames
            adts_state["block_crc"] = (not hdr.protection_absent
                                       and hdr.num_frames > 1)

    elements = []
    cces: list[CCEData] = []
    frame_drc: DRCInfo | None = None
    channel = 0

    def shapes_for(n: int) -> tuple[int, ...]:
        out = []
        for k in range(n):
            i = channel + k
            out.append(prev_shapes[i] if i < len(prev_shapes) else 0)
        return tuple(out)

    while True:
        element_type = stream.read(3)
        if element_type == END_ELEMENT:
            break
        eid = stream.read(4)
        if element_type in (SCE_ELEMENT, LFE_ELEMENT):
            dec = ICSDecoder(config)
            ics = dec.decode(stream, None, shapes_for(1)[0])
            sce = SCEData(ics=ics, id=eid, is_lfe=element_type == LFE_ELEMENT)
            elements.append(sce)
            channel += 1
        elif element_type == CPE_ELEMENT:
            cpe = decode_cpe(stream, config, shapes_for(2))
            cpe.id = eid
            elements.append(cpe)
            channel += 2
        elif element_type == CCE_ELEMENT:
            cce = decode_cce(stream, config)
            cce.id = eid
            cces.append(cce)
        elif element_type == DSE_ELEMENT:
            align = stream.read(1)
            count = stream.read(8)
            if count == 255:
                count += stream.read(8)
            if align:
                stream.align()
            stream.advance(count * 8)
        elif element_type == PCE_ELEMENT:
            # in-stream program config: parse (consuming its bits exactly)
            # and continue — channel layout is already fixed by the
            # stream's configuration.  (The reference throws here,
            # decoder.js:182-183.)
            from aacjax_torch.host.asc import decode_pce
            decode_pce(stream, eid)
        elif element_type == FIL_ELEMENT:
            cnt = eid
            if cnt == 15:
                cnt += stream.read(8) - 1
            if (sbr_ctx is not None and cnt > 0 and elements
                    and isinstance(elements[-1], (SCEData, CPEData))
                    and not getattr(elements[-1], "is_lfe", False)
                    and stream.bits_left >= 4
                    and stream.peek(4) in (13, 14)):  # EXT_SBR_DATA[_CRC]
                from aacjax_torch.host import sbr as sbrmod
                start = stream.bit_position
                ext_type = stream.read(4)
                elements[-1].sbr = sbrmod.read_sbr_extension(
                    stream, sbr_ctx, isinstance(elements[-1], CPEData),
                    ext_type == sbrmod.EXT_SBR_DATA_CRC)
                consumed = stream.bit_position - start
                if consumed > cnt * 8:
                    raise BitstreamError("SBR extension payload overrun")
                stream.advance(cnt * 8 - consumed)
            elif (cnt > 0 and stream.bits_left >= 4
                    and stream.peek(4) == EXT_DYNAMIC_RANGE):
                start = stream.bit_position
                stream.read(4)
                frame_drc = read_drc_info(stream, config.frame_length)
                consumed = stream.bit_position - start
                if consumed > cnt * 8:
                    raise BitstreamError("DRC extension payload overrun")
                stream.advance(cnt * 8 - consumed)
            else:
                stream.advance(cnt * 8)
        else:
            raise BitstreamError("Unknown element")
    stream.align()
    if adts_state is not None and adts_state.get("blocks_left", 0) > 0:
        # inside a protected multi-rdb ADTS frame each raw_data_block is
        # followed by its 16-bit adts_raw_data_block_error_check — skip
        # it BEFORE the decrement so an underflow retry (streaming feed)
        # replays this block with consistent state
        if adts_state.get("block_crc"):
            stream.advance(16)
        adts_state["blocks_left"] -= 1
    frame = Frame(elements=elements, cces=cces, drc=frame_drc)
    if drc_scale > 0:
        apply_drc(frame, drc_scale)
    return frame


def apply_drc(frame: Frame, drc_scale: float = 1.0) -> None:
    """Apply the frame's dynamic_range_info in the spectral domain, by
    folding the per-band linear gain into each channel's per-bin
    scalefactor (and PNS energy) vectors before dequantization — exact
    for banded DRC, and it commutes with the M/S butterfly since both
    channels of a pair carry the same gain.  drc_scale in [0, 1] is the
    user compression fraction (0 = off, 1 = full, like players expose);
    the reference skips FIL payloads entirely so has no DRC at all.

    Limitation (HE-AAC): for SBR-active streams the envelope adjuster
    renormalizes the patched high band to the TRANSMITTED envelope
    energies, so a spectral-domain gain only attenuates below the
    crossover (spectral tilt rather than uniform gain).  Uniform DRC on
    SBR output would have to scale the post-SBR PCM instead; since
    14496-3 single-band DRC is a full-frame gain, players that need it
    with SBR should apply `10^(gain_db*scale/20)` to the decoded PCM."""
    drc = frame.drc
    if drc is None or drc_scale <= 0:
        return
    lin = np.power(10.0, drc.gain_db * drc_scale / 20.0).astype(np.float32)
    ch_idx = 0
    for el in frame.elements:
        chans = ([el.ics] if isinstance(el, SCEData)
                 else [el.left, el.right])
        for cs in chans:
            if drc.excluded is not None and ch_idx < len(drc.excluded) \
                    and drc.excluded[ch_idx]:
                ch_idx += 1
                continue
            n = len(cs.scale_bin)
            gain_bin = np.ones(n, np.float32)
            lo = 0
            for top, g in zip(drc.band_top, lin):
                gain_bin[lo:min(int(top), n)] = g
                lo = int(top)
            cs.scale_bin *= gain_bin
            cs.noise_bin *= gain_bin
            ch_idx += 1
