"""Test-corpus generation: a syntax-level AAC-LC bitstream writer.

The reference ships no tests or fixtures (SURVEY.md §4), and this
environment has no ffmpeg/fdk encoder, so we generate conformant
raw_data_blocks ourselves from explicit per-band specifications
(window sequence/shape/grouping, band types, scalefactors, quantized
coefficients, TNS filters, M/S masks, PNS and intensity bands...).  The
decoder's expected output is computed independently by the fp64 model
decoder in tests/model_decoder.py.

This is an *encoder of syntax*, not a rate-controlled perceptual encoder:
encode_pcm() does a real forward MDCT + mid-tread quantization so bench
streams carry realistic coefficient statistics, but makes no psychoacoustic
decisions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.host import huffman
from aacjax_torch.host.asc import StreamConfig

FRAME = 1024

# band "books": 0 = zero, 1..11 = spectral codebooks, 13 = PNS noise,
# 14/15 = intensity
ZERO, NOISE, INTENSITY2, INTENSITY = 0, 13, 14, 15

# max absolute value encodable per book (escape book handles any magnitude)
BOOK_LAV = {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 6: 4, 7: 7, 8: 7, 9: 12, 10: 12,
            11: 8191}


@dataclass
class TnsFilterSpec:
    length_bands: int
    order: int
    direction: int = 0
    coef_res: int = 0          # 0 = 3-bit, 1 = 4-bit
    coef_compress: int = 0
    coef_indices: list[int] = field(default_factory=list)  # table indices


@dataclass
class ChannelSpec:
    """Everything needed to emit one individual_channel_stream."""
    window_sequence: int = 0
    window_shape: int = 0
    max_sfb: int = 0
    grouping: list[int] | None = None      # EIGHT_SHORT group lengths, sum 8
    global_gain: int = 121
    band_books: np.ndarray | None = None   # [group_count*max_sfb]
    band_sf: np.ndarray | None = None      # absolute sf / noise offset / is pos
    quant: np.ndarray | None = None        # [1024] in grouped layout
    tns: list[list[TnsFilterSpec]] | None = None  # per window
    pulse: tuple[int, list[int], list[int]] | None = None  # (swb, offsets, amps)
    # Main-profile backward prediction side info (long windows only)
    pred_used: np.ndarray | None = None    # [n<=min(max_sfb,pred_sfb_max)]
    pred_reset_group: int = 0              # 1..30; 0 = no reset
    # AAC-LTP (AOT 4) side info (long windows only)
    ltp_lag: int | None = None             # 0..2047
    ltp_coef_idx: int = 0
    ltp_used: np.ndarray | None = None     # [min(max_sfb, 40)]

    @property
    def group_count(self) -> int:
        return len(self.grouping) if self.grouping else 1

    def group_lengths(self) -> list[int]:
        return list(self.grouping) if self.grouping else [1]


@dataclass
class CPESpec:
    left: ChannelSpec
    right: ChannelSpec
    common_window: bool = True
    ms_type: int = 0                       # 0 none, 1 per-band, 2 all
    ms_used: np.ndarray | None = None      # [group_count*max_sfb] for type 1


def _swb_offsets(config: StreamConfig, spec: ChannelSpec) -> np.ndarray:
    if spec.window_sequence == 2:
        return config.swb_offsets_short
    return config.swb_offsets_long


def write_ics_info(w: BitWriter, spec: ChannelSpec) -> None:
    w.write(0, 1)  # ics_reserved
    w.write(spec.window_sequence, 2)
    w.write(spec.window_shape, 1)
    if spec.window_sequence == 2:
        w.write(spec.max_sfb, 4)
        # grouping bits: 7 bits; 1 = same group continues
        bits = []
        for glen in spec.group_lengths():
            bits.extend([1] * (glen - 1))
            bits.append(0)
        bits = bits[:-1] if bits else []  # last group has no terminator
        # exactly 7 bits describe windows 1..7
        assert len(bits) == 7, f"grouping {spec.grouping} must cover 8 windows"
        for b in bits:
            w.write(b, 1)
    else:
        w.write(spec.max_sfb, 6)
        if spec.ltp_lag is not None:
            w.write(1, 1)  # predictor_data_present (LTP profile)
            w.write(1, 1)  # ltp_data_present
            write_ltp_data(w, spec)
        elif spec.pred_used is not None:
            w.write(1, 1)  # predictor_data_present (Main profile)
            if spec.pred_reset_group:
                w.write(1, 1)
                w.write(spec.pred_reset_group, 5)
            else:
                w.write(0, 1)
            for u in spec.pred_used:
                w.write(1 if u else 0, 1)
        else:
            w.write(0, 1)  # predictor_data_present


def write_ltp_data(w: BitWriter, spec: ChannelSpec) -> None:
    w.write(spec.ltp_lag, 11)
    w.write(spec.ltp_coef_idx, 3)
    used = spec.ltp_used
    n = min(spec.max_sfb, 40)
    for i in range(n):
        w.write(1 if (used is not None and used[i]) else 0, 1)


def write_section_data(w: BitWriter, spec: ChannelSpec) -> None:
    bits = 3 if spec.window_sequence == 2 else 5
    escape = (1 << bits) - 1
    books = spec.band_books
    idx = 0
    for _g in range(spec.group_count):
        sfb = 0
        while sfb < spec.max_sfb:
            book = int(books[idx])
            run = 1
            while (sfb + run < spec.max_sfb
                   and int(books[idx + run]) == book):
                run += 1
            w.write(book, 4)
            r = run
            while r >= escape:
                w.write(escape, bits)
                r -= escape
            w.write(r, bits)
            sfb += run
            idx += run


def write_scale_factors(w: BitWriter, spec: ChannelSpec) -> None:
    books = spec.band_books
    sfs = spec.band_sf
    offset = [spec.global_gain, spec.global_gain - 90, 0]
    noise_flag = True
    idx = 0
    for _g in range(spec.group_count):
        for _sfb in range(spec.max_sfb):
            book = int(books[idx])
            if book == ZERO:
                pass
            elif book in (INTENSITY, INTENSITY2):
                delta = int(sfs[idx]) - offset[2]
                assert -60 <= delta <= 60
                huffman.encode_scalefactor(w, delta + 60)
                offset[2] += delta
            elif book == NOISE:
                delta = int(sfs[idx]) - offset[1]
                if noise_flag:
                    assert -256 <= delta <= 255
                    w.write(delta + 256, 9)
                    noise_flag = False
                else:
                    assert -60 <= delta <= 60
                    huffman.encode_scalefactor(w, delta + 60)
                offset[1] += delta
            else:
                delta = int(sfs[idx]) - offset[0]
                assert -60 <= delta <= 60, f"sf delta {delta} out of range"
                huffman.encode_scalefactor(w, delta + 60)
                offset[0] += delta
                assert 0 <= offset[0] <= 255
            idx += 1


def write_tns(w: BitWriter, spec: ChannelSpec) -> None:
    short = spec.window_sequence == 2
    nfilt_bits, len_bits, ord_bits = (1, 4, 3) if short else (2, 6, 5)
    n_windows = 8 if short else 1
    tns = spec.tns or [[] for _ in range(n_windows)]
    for wdw in range(n_windows):
        filts = tns[wdw] if wdw < len(tns) else []
        w.write(len(filts), nfilt_bits)
        if not filts:
            continue
        coef_res = filts[0].coef_res
        w.write(coef_res, 1)
        for f in filts:
            assert f.coef_res == coef_res
            w.write(f.length_bands, len_bits)
            w.write(f.order, ord_bits)
            if f.order:
                w.write(f.direction, 1)
                w.write(f.coef_compress, 1)
                coef_len = coef_res + 3 - f.coef_compress
                assert len(f.coef_indices) == f.order
                for ci in f.coef_indices:
                    assert 0 <= ci < (1 << coef_len)
                    w.write(ci, coef_len)


def write_spectral_data(w: BitWriter, spec: ChannelSpec,
                        config: StreamConfig) -> None:
    offsets = _swb_offsets(config, spec)
    books = spec.band_books
    quant = spec.quant if spec.quant is not None else np.zeros(FRAME, np.int64)
    idx = 0
    group_off = 0
    for glen in spec.group_lengths():
        for sfb in range(spec.max_sfb):
            book = int(books[idx])
            if book in (ZERO, NOISE, INTENSITY, INTENSITY2):
                idx += 1
                continue
            off0 = group_off + int(offsets[sfb])
            width = int(offsets[sfb + 1]) - int(offsets[sfb])
            num = 2 if book >= 5 else 4
            off = off0
            for _wdw in range(glen):
                for k in range(0, width, num):
                    vals = [int(quant[off + k + j]) for j in range(num)]
                    huffman.encode_spectral(w, book, vals)
                off += config.short_length
            idx += 1
        group_off += glen * config.short_length


def write_ics(w: BitWriter, spec: ChannelSpec, config: StreamConfig,
              common_window: bool, er: bool = False,
              eld: bool = False) -> None:
    """er=True emits the ER ordering (AAC-LD): pulse forbidden, and
    tns_data follows the gain-control bit instead of preceding it.
    eld=True emits the AAC-ELD stream: ics_info is just max_sfb(6), no
    pulse or gain-control bits, tns_data directly after its flag."""
    if eld:
        w.write(spec.global_gain, 8)
        if not common_window:
            w.write(spec.max_sfb, 6)
        write_section_data(w, spec)
        write_scale_factors(w, spec)
        tns_on = spec.tns is not None and any(spec.tns)
        w.write(1 if tns_on else 0, 1)
        if tns_on:
            write_tns(w, spec)
        write_spectral_data(w, spec, config)
        return
    w.write(spec.global_gain, 8)
    if not common_window:
        write_ics_info(w, spec)
    write_section_data(w, spec)
    write_scale_factors(w, spec)
    if spec.pulse is not None:
        assert not er, "pulse data is forbidden in ER syntax"
        w.write(1, 1)
        swb, poffs, pamps = spec.pulse
        w.write(len(poffs) - 1, 2)
        w.write(swb, 6)
        prev = None
        for i, (po, pa) in enumerate(zip(poffs, pamps)):
            w.write(po, 5)
            w.write(pa, 4)
    else:
        w.write(0, 1)
    tns_on = spec.tns is not None and any(spec.tns)
    w.write(1 if tns_on else 0, 1)
    if tns_on and not er:
        write_tns(w, spec)
    w.write(0, 1)  # gain control
    if tns_on and er:
        write_tns(w, spec)
    write_spectral_data(w, spec, config)


def write_sce(w: BitWriter, spec: ChannelSpec, config: StreamConfig,
              instance: int = 0, lfe: bool = False) -> None:
    w.write(3 if lfe else 0, 3)
    w.write(instance, 4)
    write_ics(w, spec, config, common_window=False)


def write_cpe(w: BitWriter, spec: CPESpec, config: StreamConfig,
              instance: int = 0) -> None:
    w.write(1, 3)
    w.write(instance, 4)
    w.write(1 if spec.common_window else 0, 1)
    if spec.common_window:
        write_ics_info(w, spec.left)
        if spec.left.ltp_lag is not None or spec.right.ltp_lag is not None:
            # second channel's ltp_data_present follows the shared
            # ics_info (AAC-LTP cpe syntax); requires the shared info to
            # carry the predictor bit, i.e. left.ltp_lag set
            assert spec.left.ltp_lag is not None
            if spec.right.ltp_lag is not None:
                w.write(1, 1)
                write_ltp_data(w, spec.right)
            else:
                w.write(0, 1)
        w.write(spec.ms_type, 2)
        if spec.ms_type == 1:
            n = spec.left.group_count * spec.left.max_sfb
            for i in range(n):
                w.write(int(spec.ms_used[i]), 1)
    write_ics(w, spec.left, config, common_window=spec.common_window)
    write_ics(w, spec.right, config, common_window=spec.common_window)


@dataclass
class CCESpec:
    """Coupling channel element (cce.js syntax)."""
    ics: ChannelSpec
    coupling_point: int = 0                # 0 BEFORE_TNS, 1 AFTER_TNS, 2 AFTER_IMDCT
    targets: list[tuple[int, int, int]] = field(default_factory=list)
    # (channel_pair, id_select, ch_select); ch_select meaningful for pairs
    sign: int = 0
    scale_idx: int = 1
    # per extra gain list: (cge, common_gain_delta, per_band_deltas)
    gain_lists: list[tuple[int, int, list[int]]] = field(default_factory=list)


def write_cce(w: BitWriter, spec: CCESpec, config: StreamConfig,
              instance: int = 0) -> None:
    w.write(2, 3)  # CCE element
    w.write(instance, 4)
    ind_sw = 1 if spec.coupling_point == 2 else 0
    w.write(ind_sw, 1)
    w.write(len(spec.targets) - 1, 3)
    gain_count = 0
    for pair, idsel, chsel in spec.targets:
        gain_count += 1
        w.write(pair, 1)
        w.write(idsel, 4)
        if pair:
            w.write(chsel, 2)
            if chsel == 3:
                gain_count += 1
    w.write(spec.coupling_point & 1, 1)
    w.write(spec.sign, 1)
    w.write(spec.scale_idx, 2)
    write_ics(w, spec.ics, config, common_window=False)
    # gain element lists: first is implicit (gain 1); others per gain_lists
    n_coded_bands = int(np.count_nonzero(spec.ics.band_books))
    for i in range(1, gain_count):
        cge, common_delta, band_deltas = spec.gain_lists[i - 1]
        if spec.coupling_point == 2:
            cge = 1
        else:
            w.write(cge, 1)
        if cge:
            huffman.encode_scalefactor(w, common_delta + 60)
        else:
            assert len(band_deltas) >= n_coded_bands
            for d in band_deltas[:n_coded_bands]:
                huffman.encode_scalefactor(w, d + 60)


def write_fil(w: BitWriter, count_bytes: int) -> None:
    """Filler element (decoder.js:187-193 skip path)."""
    w.write(6, 3)
    if count_bytes >= 15:
        w.write(15, 4)
        w.write(count_bytes - 14, 8)
    else:
        w.write(count_bytes, 4)
    for _ in range(count_bytes):
        w.write(0xA5, 8)


def write_dse(w: BitWriter, payload: bytes, align: bool = True,
              instance: int = 0) -> None:
    """Data stream element (decoder.js:167-179 skip path)."""
    w.write(4, 3)
    w.write(instance, 4)
    w.write(1 if align else 0, 1)
    count = len(payload)
    if count >= 255:
        w.write(255, 8)
        w.write(count - 255, 8)
    else:
        w.write(count, 8)
    if align:
        w.align()
    for b in payload:
        w.write(b, 8)


def drc_payload(gains_db: list[float], band_tops: list[int] | None = None,
                excluded: list[bool] | None = None,
                pce_tag: int | None = None, prog_ref: int | None = None,
                interpolation: int = 0) -> bytes:
    """Build a dynamic_range_info extension payload (ISO/IEC 14496-3
    §4.5.2.7), starting with the 4-bit EXT_DYNAMIC_RANGE type.  Wrap it
    with aacjax.testing.sbr_encoder.write_sbr_fil (generic FIL framing).
    band_tops are exclusive spectral-bin tops, multiples of 4."""
    p = BitWriter()
    p.write(11, 4)                      # EXT_DYNAMIC_RANGE
    if pce_tag is not None:
        p.write(1, 1)
        p.write(pce_tag, 4)
        p.write(0, 4)                   # drc_tag_reserved_bits
    else:
        p.write(0, 1)
    if excluded is not None:
        p.write(1, 1)
        bits = list(excluded) + [False] * ((-len(excluded)) % 7)
        for i in range(0, len(bits), 7):
            if i:
                p.write(1, 1)           # additional_excluded_chns
            for b in bits[i:i + 7]:
                p.write(1 if b else 0, 1)
        p.write(0, 1)
    else:
        p.write(0, 1)
    if band_tops is not None and (len(gains_db) > 1 or band_tops):
        p.write(1, 1)
        p.write(len(gains_db) - 1, 4)   # drc_band_incr
        p.write(interpolation, 4)
        for top in band_tops:
            assert top % 4 == 0 and top >= 4
            p.write(top // 4 - 1, 8)
    else:
        p.write(0, 1)
    if prog_ref is not None:
        p.write(1, 1)
        p.write(prog_ref, 7)
        p.write(0, 1)
    else:
        p.write(0, 1)
    for g in gains_db:
        ctl = int(round(abs(g) * 4))
        assert 0 <= ctl <= 127
        p.write(1 if g < 0 else 0, 1)
        p.write(ctl, 7)
    p.align()
    return p.getvalue()


def end_frame(w: BitWriter) -> bytes:
    w.write(7, 3)  # END
    w.align()
    return w.getvalue()


def write_er_frame(elements, config: StreamConfig) -> bytes:
    """ER raw_data_block (AAC-LD, AOT 23): channel elements in the fixed
    Table-1.19 order with no id tags and no END element.  elements:
    list of ('SCE'|'LFE', ChannelSpec) or ('CPE', CPESpec)."""
    w = BitWriter()
    for kind, spec in elements:
        w.write(0, 4)  # element_instance_tag (type is implicit)
        if kind in ("SCE", "LFE"):
            write_ics(w, spec, config, common_window=False, er=True)
        elif kind == "CPE":
            w.write(1 if spec.common_window else 0, 1)
            if spec.common_window:
                write_ics_info(w, spec.left)
                w.write(spec.ms_type, 2)
                if spec.ms_type == 1:
                    n = spec.left.group_count * spec.left.max_sfb
                    for i in range(n):
                        w.write(int(spec.ms_used[i]), 1)
            write_ics(w, spec.left, config, spec.common_window, er=True)
            write_ics(w, spec.right, config, spec.common_window, er=True)
        else:
            raise ValueError(kind)
    w.align()
    return w.getvalue()


def write_eld_frame(elements, config: StreamConfig) -> bytes:
    """AAC-ELD raw_data_block (AOT 39): channel elements in the fixed
    Table-1.19 order with NO instance tags and no END element; CPEs have
    no common_window bit (implied true) — shared max_sfb(6) + ms mask
    precede the two channel streams."""
    w = BitWriter()
    for kind, spec in elements:
        if kind in ("SCE", "LFE"):
            write_ics(w, spec, config, common_window=False, eld=True)
        elif kind == "CPE":
            w.write(spec.left.max_sfb, 6)      # shared eld ics_info
            w.write(spec.ms_type, 2)
            if spec.ms_type == 1:
                for i in range(spec.left.max_sfb):
                    w.write(int(spec.ms_used[i]), 1)
            write_ics(w, spec.left, config, common_window=True, eld=True)
            write_ics(w, spec.right, config, common_window=True, eld=True)
        else:
            raise ValueError(kind)
    w.align()
    return w.getvalue()


def adts_frame(payload: bytes, config: StreamConfig,
               crc: bool = False) -> bytes:
    """Wrap a raw_data_block in a 7-byte ADTS header (9 with CRC).

    crc=True writes the real ISO/IEC 13818-7 §8.2.2 crc_check
    (aacjax.host.adts.compute_crc) — verified by decode_adts
    verify_crc=True; every interoperating decoder (incl. the reference,
    adts_demuxer.js:48-49, and libavcodec) skips the field."""
    w = BitWriter()
    header_len = 9 if crc else 7
    length = len(payload) + header_len
    w.write(0xFFF, 12)
    w.write(0b000, 3)            # MPEG-4, layer 00
    w.write(0 if crc else 1, 1)  # protection_absent
    w.write(config.profile - 1, 2)
    w.write(config.sample_index, 4)
    w.write(0, 1)            # private
    w.write(config.chan_config, 3)
    w.write(0, 4)            # original/home/(c)/(c)start
    w.write(length, 13)
    w.write(0x7FF, 11)       # fullness
    w.write(0, 2)            # numFrames - 1
    if crc:
        from aacjax_torch.host.adts import compute_crc
        w.write(compute_crc(w.getvalue(), payload), 16)
    return w.getvalue() + payload


def adts_frame_multi(payloads: list[bytes], config: StreamConfig,
                     crc: bool = False) -> bytes:
    """Wrap 1-4 raw_data_blocks in ONE ADTS frame (numFrames > 1 when
    len(payloads) > 1).  With crc=True the frame carries the full
    13818-7 §6.2 multi-rdb protection layout: adts_header_error_check
    (raw_data_block_position[1..N] + header crc_check) and a trailing
    16-bit adts_raw_data_block_error_check after every block — the
    self-validating counterpart of aacjax.host.adts.crc_block_status."""
    from aacjax_torch.host.adts import _CRC_SPAN_BYTES, _crc16
    n = len(payloads)
    assert 1 <= n <= 4
    if n == 1:
        return adts_frame(payloads[0], config, crc=crc)
    header_len = 7 + (2 * (n - 1) + 2 if crc else 0)
    body_len = sum(len(p) for p in payloads) + (2 * n if crc else 0)
    length = header_len + body_len
    w = BitWriter()
    w.write(0xFFF, 12)
    w.write(0b000, 3)            # MPEG-4, layer 00
    w.write(0 if crc else 1, 1)  # protection_absent
    w.write(config.profile - 1, 2)
    w.write(config.sample_index, 4)
    w.write(0, 1)                # private
    w.write(config.chan_config, 3)
    w.write(0, 4)                # original/home/(c)/(c)start
    w.write(length, 13)
    w.write(0x7FF, 11)           # fullness
    w.write(n - 1, 2)            # numFrames - 1
    if not crc:
        return w.getvalue() + b"".join(payloads)
    # block i starts at position p_i relative to the first block; each
    # block is followed by its 2-byte crc_check
    pos = 0
    positions = []
    for p in payloads[:-1]:
        pos += len(p) + 2
        positions.append(pos)
    for p in positions:
        w.write(p, 16)
    w.write(_crc16(w.getvalue()), 16)   # header crc: 56 bits + positions
    body = b"".join(
        p + _crc16(p[:_CRC_SPAN_BYTES]).to_bytes(2, "big")
        for p in payloads)
    return w.getvalue() + body


# ---------------------------------------------------------------------------
# A minimal real encoder (forward MDCT + quantization) for bench corpora
# ---------------------------------------------------------------------------
def analysis_matrix(n: int) -> np.ndarray:
    """Forward MDCT matrix [n, n//2]: X = x_windowed @ analysis_matrix.
    The *n scale makes windowed 50%-OLA with tables.imdct_matrix an exact
    perfect-reconstruction pair (verified in test_tables.py)."""
    return tables.imdct_matrix(n).T * float(n)


def quantize_band(x: np.ndarray, sf: int) -> np.ndarray:
    gain = tables.scalefactor_gain(sf - 100 + tables.SF_OFFSET)
    q = np.sign(x) * np.floor(np.power(np.abs(x) / gain, 0.75) + 0.4054)
    # the escape sequence tops out at |q| = 8191 (<= 8 prefix ones);
    # larger values are illegal AAC (FFmpeg rejects them as ESC overflow)
    return np.clip(q, -8191, 8191).astype(np.int64)


def encode_pcm_frames(pcm: np.ndarray, config: StreamConfig,
                      target_sf: int = 140,
                      fil_payloads: list[bytes] | None = None) -> list[bytes]:
    """Encode PCM [n_samples, channels] (float, reference's 32768 scale)
    into raw_data_block payloads: ONLY_LONG windows, sine shape, book-11
    bands.  Honors config.frame_length (1024 or 960).

    Not rate-controlled — intended to produce realistic coefficient
    statistics for benchmarks and round-trip SNR tests.
    """
    nch = config.channels
    FRAME = config.frame_length
    assert pcm.ndim == 2 and pcm.shape[1] == nch
    n_frames = pcm.shape[0] // FRAME
    window = tables.long_window(0, FRAME)
    wfull = np.concatenate([window, window[::-1]])
    amat = analysis_matrix(2 * FRAME)
    offsets = config.swb_offsets_long
    max_sfb = config.swb_count_long

    # pad one frame of lookahead for the final MDCT
    padded = np.concatenate([np.zeros((FRAME, nch)), pcm,
                             np.zeros((2 * FRAME, nch))], axis=0)
    payloads: list[bytes] = []
    for f in range(n_frames + 1):
        w = BitWriter()
        specs = []
        for ch in range(nch):
            seg = padded[f * FRAME:(f + 2) * FRAME, ch]
            coefs = (seg * wfull) @ amat
            books = np.zeros(max_sfb, np.int64)
            sfs = np.zeros(max_sfb, np.int64)
            quant = np.zeros(FRAME, np.int64)
            for sfb in range(max_sfb):
                a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                band = coefs[a:b]
                if np.max(np.abs(band)) < 1e-3:
                    continue
                sf = target_sf
                q = quantize_band(band, sf)
                # raise the band's scalefactor until the quantized values
                # fit the escape limit (|q| <= 8191), like a real encoder
                while np.max(np.abs(q)) >= 8191 and sf < 255:
                    sf += 4
                    q = quantize_band(band, sf)
                if not np.any(q):
                    continue
                # cheapest codebook covering the band's max magnitude,
                # like a real encoder's book selection
                m = int(np.max(np.abs(q)))
                if m <= 1:
                    books[sfb] = 2
                elif m <= 2:
                    books[sfb] = 4
                elif m <= 4:
                    books[sfb] = 6
                elif m <= 7:
                    books[sfb] = 8
                elif m <= 12:
                    books[sfb] = 10
                else:
                    books[sfb] = 11
                sfs[sfb] = sf
                quant[a:b] = q
            spec = ChannelSpec(window_sequence=0, window_shape=0,
                               max_sfb=max_sfb, global_gain=target_sf,
                               band_books=books, band_sf=sfs, quant=quant)
            specs.append(spec)
        if nch == 2:
            write_cpe(w, CPESpec(left=specs[0], right=specs[1],
                                 common_window=True, ms_type=0), config)
        else:
            for i, spec in enumerate(specs):
                write_sce(w, spec, config, instance=i)
        if fil_payloads is not None:
            # e.g. an SBR extension following its element (HE-AAC implicit
            # signaling; aacjax.testing.sbr_encoder)
            from aacjax_torch.testing.sbr_encoder import write_sbr_fil
            write_sbr_fil(w, fil_payloads[min(f, len(fil_payloads) - 1)])
        payloads.append(end_frame(w))
    return payloads


def encode_pcm(pcm: np.ndarray, config: StreamConfig,
               target_sf: int = 140) -> bytes:
    """encode_pcm_frames wrapped in ADTS framing (1024-frame mode only:
    ADTS headers cannot signal frameLengthFlag — 960 streams must travel
    as raw blocks plus an ASC cookie)."""
    assert config.frame_length == 1024, "ADTS cannot carry 960-frame AAC"
    return b"".join(adts_frame(p, config)
                    for p in encode_pcm_frames(pcm, config, target_sf))


def loas_stream(payloads: list[bytes], config: StreamConfig,
                subframes: int = 1, mux_period: int = 0,
                flt: int = 0) -> bytes:
    """Wrap raw_data_block payloads into a LOAS AudioSyncStream carrying
    LATM AudioMuxElements (single program/layer).  subframes packs that
    many payloads per mux element (len(payloads) must divide evenly);
    mux_period=N re-sends the StreamMuxConfig every N elements (0 = only
    in the first); flt is the frameLengthType (0 byte-escape lengths,
    1 fixed — all payloads must then be equal length)."""
    from aacjax_torch.host.asc import write_asc_bits
    assert len(payloads) % subframes == 0
    groups = [payloads[i:i + subframes]
              for i in range(0, len(payloads), subframes)]
    out = bytearray()
    for gi, group in enumerate(groups):
        w = BitWriter()
        send_cfg = gi == 0 or (mux_period and gi % mux_period == 0)
        w.write(0 if send_cfg else 1, 1)     # useSameStreamMux
        if send_cfg:
            w.write(0, 1)                    # audioMuxVersion
            w.write(1, 1)                    # allStreamsSameTimeFraming
            w.write(subframes - 1, 6)        # numSubFrames
            w.write(0, 4)                    # numProgram - 1
            w.write(0, 3)                    # numLayer - 1
            write_asc_bits(w, config.profile, config.sample_index,
                           config.chan_config, config.frame_length,
                           bool(config.sbr))
            w.write(flt, 3)                  # frameLengthType
            if flt == 0:
                w.write(0xCC, 8)             # latmBufferFullness
            else:
                assert all(len(p) == len(group[0]) for g in groups
                           for p in g)
                w.write(len(group[0]) - 20, 9)
            w.write(0, 1)                    # otherDataPresent
            w.write(0, 1)                    # crcCheckPresent
        for p in group:  # per subframe: PayloadLengthInfo(); PayloadMux()
            if flt == 0:
                n = len(p)
                while n >= 255:
                    w.write(255, 8)
                    n -= 255
                w.write(n, 8)
            for b in p:
                w.write(b, 8)
        w.align()
        ame = w.getvalue()
        hdr = BitWriter()
        hdr.write(0x2B7, 11)
        hdr.write(len(ame), 13)
        out += hdr.getvalue() + ame
    return bytes(out)
