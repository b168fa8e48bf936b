"""Syntactic element parsing of an AAC-LC raw_data_block: the element
loop (SCE/CPE/LFE/DSE/FIL/END), ICS side info, the spectral Huffman data,
CPE stereo masks and TNS side info, with a FIL element's SBR extension
handed to portbench.reference.sbr.  Output is integer quantized spectra
plus dense side-info arrays for refdec.

Spec-correct choices: pulse data is applied, TNS filter regions follow
ISO/IEC 14496-3.  Main-profile prediction, LTP, coupling channel
elements, program config elements and the ER syntaxes are refused.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from portbench.reference import tables
from portbench.reference import huffman
from portbench.reference.asc import StreamConfig, UnsupportedError
from portbench.reference.bitio import BitReader, BitstreamError

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
    frame_len: int = FRAME_LEN
    short_len: int = 128             # frame_len // 8

    def decode(self, stream: BitReader, config: StreamConfig,
               common_window: bool, prev_shape: int) -> None:
        stream.advance(1)  # ics_reserved_bit
        self.window_sequence = stream.read(2)
        self.prev_window_shape = prev_shape
        self.window_shape = stream.read(1)
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
                raise UnsupportedError(
                    "prediction data in an AAC-LC stream")
        if self.max_sfb > self.swb_count:
            raise BitstreamError(
                f"max_sfb {self.max_sfb} > swb_count {self.swb_count}")


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
        if common_info is None:
            info.decode(stream, self.config, False, prev_shape)
        self._decode_band_types(stream, ch)
        self._decode_scale_factors(stream, ch)
        ch.pulse_present = bool(stream.read(1))
        pulse = None
        if ch.pulse_present:
            if info.window_sequence == EIGHT_SHORT_SEQUENCE:
                raise BitstreamError(
                    "Pulse tool not allowed in eight short sequence.")
            pulse = self._decode_pulse(stream, ch)
        ch.tns_present = bool(stream.read(1))
        tns = TNSData()
        if ch.tns_present:
            tns.decode(stream, info)
        if stream.read(1):  # gain control (SSR)
            raise UnsupportedError("gain control/SSR not supported")
        self._decode_spectral(stream, ch)
        if pulse is not None:
            self._apply_pulse(ch, pulse)
        if ch.tns_present:
            max_bands = int((tables.TNS_MAX_BANDS_128
                             if info.window_sequence == EIGHT_SHORT_SEQUENCE
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
class SCEData:
    ics: ChannelStream
    id: int = 0
    is_lfe: bool = False
    sbr: object = None   # SBRFrame when a FIL SBR extension followed


@dataclass
class Frame:
    """One parsed raw_data_block."""
    elements: list  # SCEData | CPEData in order


def decode_cpe(stream: BitReader, config: StreamConfig,
               prev_shapes: tuple[int, int]) -> CPEData:
    """cpe.js:37-75."""
    dec = ICSDecoder(config)
    common_window = bool(stream.read(1))
    ms_used = np.zeros(128, bool)
    mask_present = False
    if common_window:
        info = ICSInfo()
        info.decode(stream, config, True, prev_shapes[0])
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
        right = dec.decode(stream, rinfo, prev_shapes[1])
    else:
        left = dec.decode(stream, None, prev_shapes[0])
        right = dec.decode(stream, None, prev_shapes[1])
    return CPEData(left=left, right=right, common_window=common_window,
                   mask_present=mask_present, ms_used=ms_used)


def decode_frame(stream: BitReader, config: StreamConfig,
                 prev_shapes: list[int], sbr_ctx=None,
                 sbr_readers: dict | None = None) -> Frame:
    """Parse one raw_data_block (decoder.js:125-201 element loop).

    prev_shapes: per-decoder-channel previous window shapes (persisted by
    the caller across frames).

    sbr_ctx: optional SBRContext; when given, FIL extension payloads
    carrying SBR data (HE-AAC implicit signalling) are parsed and attached
    to the preceding SCE/CPE element instead of being skipped.

    sbr_readers: optional readers of the SBR extended data's payloads by
    extension id (sbr.read_sbr_extension), passed through.
    """
    if config.profile != 2:
        raise UnsupportedError(f"audio object type {config.profile}")
    elements = []
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
        elif element_type == DSE_ELEMENT:
            align = stream.read(1)
            count = stream.read(8)
            if count == 255:
                count += stream.read(8)
            if align:
                stream.align()
            stream.advance(count * 8)
        elif element_type in (CCE_ELEMENT, PCE_ELEMENT):
            raise UnsupportedError(f"element type {element_type}")
        elif element_type == FIL_ELEMENT:
            cnt = eid
            if cnt == 15:
                cnt += stream.read(8) - 1
            if (sbr_ctx is not None and cnt > 0 and elements
                    and isinstance(elements[-1], (SCEData, CPEData))
                    and not getattr(elements[-1], "is_lfe", False)
                    and stream.bits_left >= 4
                    and stream.peek(4) in (13, 14)):  # EXT_SBR_DATA[_CRC]
                from portbench.reference import sbr as sbrmod
                start = stream.bit_position
                ext_type = stream.read(4)
                elements[-1].sbr = sbrmod.read_sbr_extension(
                    stream, sbr_ctx, isinstance(elements[-1], CPEData),
                    ext_type == sbrmod.EXT_SBR_DATA_CRC, sbr_readers)
                consumed = stream.bit_position - start
                if consumed > cnt * 8:
                    raise BitstreamError("SBR extension payload overrun")
                stream.advance(cnt * 8 - consumed)
            else:
                stream.advance(cnt * 8)
        else:
            raise BitstreamError("Unknown element")
    stream.align()
    return Frame(elements=elements)
