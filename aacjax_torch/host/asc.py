"""AudioSpecificConfig ("magic cookie") parsing -> StreamConfig.

Reproduces the reference setCookie semantics (decoder.js:53-113): profile
escape codes, explicit 24-bit sample rate, GASpecificConfig with
frameLengthFlag / dependsOnCoreCoder / extensionFlag handling — and goes
past the reference's rejections: frameLengthFlag=1 (960 mode), PCE
(chanConfig 0), AOT 5 (explicit HE-AAC), and AOT 1 (Main profile, whose
backward prediction the reference throws on) all parse and decode.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from aacjax_torch import tables
from aacjax_torch.host.bitio import BitReader

AOT_AAC_MAIN = 1
AOT_AAC_LC = 2
AOT_AAC_LTP = 4
AOT_SBR = 5
AOT_ER_AAC_LC = 17
AOT_ER_AAC_LD = 23
AOT_ESCAPE = 31
AOT_ER_AAC_ELD = 39

CHANNEL_CONFIG_NONE = 0


@dataclass
class PCEData:
    """Parsed program_config_element (ISO/IEC 14496-3 §4.4.1.1 — the
    reference throws on PCE, decoder.js:101-103/182-183)."""
    instance_tag: int
    object_type: int
    sample_index: int
    # (is_cpe, instance_tag) per front/side/back element, in order
    front: list
    side: list
    back: list
    lfe: list           # instance tags
    assoc_data: list
    valid_cc: list      # (ind_sw, tag)
    comment: bytes = b""

    @property
    def channels(self) -> int:
        n = sum(2 if cpe else 1
                for cpe, _ in self.front + self.side + self.back)
        return n + len(self.lfe)


def decode_pce(stream: BitReader, instance_tag: int | None = None) -> PCEData:
    """Parse a program_config_element (used both inside a
    GASpecificConfig when channelConfiguration == 0 and as an in-stream
    element)."""
    if instance_tag is None:
        instance_tag = stream.read(4)
    object_type = stream.read(2)
    sample_index = stream.read(4)
    n_front = stream.read(4)
    n_side = stream.read(4)
    n_back = stream.read(4)
    n_lfe = stream.read(2)
    n_assoc = stream.read(3)
    n_cc = stream.read(4)
    if stream.read(1):  # mono_mixdown_present
        stream.advance(4)
    if stream.read(1):  # stereo_mixdown_present
        stream.advance(4)
    if stream.read(1):  # matrix_mixdown_idx_present
        stream.advance(3)
    rd2 = lambda: (bool(stream.read(1)), stream.read(4))
    front = [rd2() for _ in range(n_front)]
    side = [rd2() for _ in range(n_side)]
    back = [rd2() for _ in range(n_back)]
    lfe = [stream.read(4) for _ in range(n_lfe)]
    assoc = [stream.read(4) for _ in range(n_assoc)]
    cc = [(stream.read(1), stream.read(4)) for _ in range(n_cc)]
    stream.align()
    n_comment = stream.read(8)
    comment = bytes(stream.read(8) for _ in range(n_comment))
    return PCEData(instance_tag=instance_tag, object_type=object_type,
                   sample_index=sample_index, front=front, side=side,
                   back=back, lfe=lfe, assoc_data=assoc, valid_cc=cc,
                   comment=comment)



class UnsupportedError(Exception):
    """Feature present in the bitstream that this profile build rejects."""


@dataclass(frozen=True)
class StreamConfig:
    """Frozen per-stream configuration (reference `this.config`)."""
    profile: int
    sample_index: int
    sample_rate: int          # core decoder rate (tables are indexed by it)
    chan_config: int
    frame_length: int = 1024
    # HE-AAC: explicit SBR signaling (AOT 5).  sbr=1 doubles the output
    # rate; sbr=0 streams may still carry implicitly signaled SBR in FIL
    # elements, detected at decode time.
    sbr: int = 0
    ext_sample_rate: int = 0
    # channel count from an embedded PCE when chan_config == 0
    pce_channels: int = 0

    @property
    def output_sample_rate(self) -> int:
        return self.ext_sample_rate if self.sbr else self.sample_rate

    @property
    def channels(self) -> int:
        # chanConfig equals the channel count for 1..6.  Per ISO/IEC
        # 14496-3 Table 1.19, chanConfig 7 is 7.1 (8 channels: C + front
        # pair + outside pair + back pair + LFE) — a spec-correct
        # divergence from the reference, which instead labels value 8 as
        # SEVEN_PLUS_ONE (decoder.js:47) and would reject a legal
        # chanConfig-7 stream.  Value 8 is also accepted as 8 channels for
        # reference compatibility.  chanConfig 0 takes the layout from the
        # ASC's embedded program_config_element.
        if self.chan_config == 0:
            return self.pce_channels
        # 11 = 6.1, 12 = 7.1 (back), 13 = 22.2 (ISO/IEC 14496-3 Amd.4)
        return {7: 8, 11: 7, 12: 8, 13: 24}.get(
            self.chan_config, self.chan_config)

    @property
    def short_length(self) -> int:
        return self.frame_length // 8  # 128, or 120 in 960 mode

    @property
    def swb_offsets_long(self) -> np.ndarray:
        if self.frame_length == 960:
            return tables.SWB_OFFSET_960[self.sample_index]
        if self.frame_length == 512:
            return tables.SWB_OFFSET_512[self.sample_index]
        if self.frame_length == 480:
            return tables.SWB_OFFSET_480[self.sample_index]
        return tables.SWB_OFFSET_1024[self.sample_index]

    @property
    def pred_sfb_max(self) -> int:
        """Highest predicted sfb for Main-profile backward prediction
        (ISO/IEC 14496-3 Table 4.128, extracted from libavcodec)."""
        return int(tables.PRED_SFB_MAX[self.sample_index])

    @property
    def swb_offsets_short(self) -> np.ndarray:
        if self.frame_length == 960:
            return tables.SWB_OFFSET_120[self.sample_index]
        return tables.SWB_OFFSET_128[self.sample_index]

    @property
    def swb_count_long(self) -> int:
        if self.frame_length == 960:
            return int(tables.SWB_LONG_WINDOW_COUNT_960[self.sample_index])
        if self.frame_length == 512:
            return int(tables.NUM_SWB_512[self.sample_index])
        if self.frame_length == 480:
            return int(tables.NUM_SWB_480[self.sample_index])
        return int(tables.SWB_LONG_WINDOW_COUNT[self.sample_index])

    @property
    def tns_max_bands_ld(self) -> int:
        t = (tables.TNS_MAX_BANDS_512 if self.frame_length == 512
             else tables.TNS_MAX_BANDS_480)
        return int(t[self.sample_index])

    @property
    def swb_count_short(self) -> int:
        if self.frame_length == 960:
            return int(tables.SWB_SHORT_WINDOW_COUNT_120[self.sample_index])
        return int(tables.SWB_SHORT_WINDOW_COUNT[self.sample_index])


def _read_rate(stream: BitReader) -> tuple[int, int]:
    sample_index = stream.read(4)
    if sample_index == 0x0F:
        sample_rate = stream.read(24)
        for i, r in enumerate(tables.SAMPLE_RATES):
            if int(r) == sample_rate:
                sample_index = i
                break
        else:
            raise UnsupportedError(f"unknown sample rate {sample_rate}")
    else:
        if sample_index >= len(tables.SAMPLE_RATES):
            raise UnsupportedError(f"invalid sample index {sample_index}")
        sample_rate = int(tables.SAMPLE_RATES[sample_index])
    return sample_index, sample_rate


def parse_asc(cookie: bytes) -> StreamConfig:
    """Parse an AudioSpecificConfig buffer (decoder.js:53-113; plus
    HE-AAC explicit SBR signaling, which the reference rejects)."""
    return parse_asc_bits(BitReader(cookie))


def parse_asc_bits(stream: BitReader) -> StreamConfig:
    """Bit-level AudioSpecificConfig parse — consumes exactly the ASC
    from an ongoing reader (LATM StreamMuxConfig embeds the ASC inline
    with no length field when audioMuxVersion == 0)."""
    profile = stream.read(5)
    if profile == AOT_ESCAPE:
        profile = 32 + stream.read(6)

    sample_index, sample_rate = _read_rate(stream)
    chan_config = stream.read(4)
    if chan_config in (9, 10, 14, 15):
        # 9/10/15 are reserved; 14 (7.1 top-front) has no layout in the
        # conformance oracle to pin an output order against
        raise UnsupportedError(f"channelConfiguration {chan_config}")

    sbr = 0
    ext_sample_rate = 0
    if profile == AOT_SBR:
        # explicit hierarchical signaling: the rate above is the core
        # rate; the extension rate is the SBR output rate, and the core
        # object type follows
        sbr = 1
        _ext_index, ext_sample_rate = _read_rate(stream)
        profile = stream.read(5)
        if profile == AOT_ESCAPE:
            profile = 32 + stream.read(6)

    frame_length = 1024
    if profile in (AOT_ER_AAC_LC, AOT_ER_AAC_LD):
        # ER AAC LC / Low Delay (the reference rejects every ER
        # profile): GASpecificConfig — 1024/960 frames for ER-LC,
        # 512/480 for LD — plus ER resilience flags and an epConfig
        # trailer
        short = bool(stream.read(1))  # frameLengthFlag
        if profile == AOT_ER_AAC_LD:
            frame_length = 480 if short else 512
        else:
            frame_length = 960 if short else 1024
        if stream.read(1):  # dependsOnCoreCoder
            stream.advance(14)
        ext = stream.read(1)  # extensionFlag (1 for ER profiles)
        pce_channels = 0
        if chan_config == CHANNEL_CONFIG_NONE:
            pce = decode_pce(stream)
            pce_channels = pce.channels
        if ext:
            if stream.read(1) or stream.read(1) or stream.read(1):
                raise UnsupportedError(
                    "ER resilience tools (RVLC/HCR) not supported.")
            if stream.read(1):  # extensionFlag3
                raise UnsupportedError("extensionFlag3 not supported.")
        ep = stream.read(2)  # epConfig
        if ep != 0:
            raise UnsupportedError(f"epConfig {ep} not supported.")
        if profile == AOT_ER_AAC_LD:
            counts = (tables.NUM_SWB_512 if frame_length == 512
                      else tables.NUM_SWB_480)
            if counts[sample_index] == 0:
                raise UnsupportedError(
                    f"AAC-LD undefined at sampling index {sample_index}")
        return StreamConfig(
            profile=profile, sample_index=sample_index,
            sample_rate=sample_rate, chan_config=chan_config,
            frame_length=frame_length, sbr=0, ext_sample_rate=0,
            pce_channels=pce_channels)
    if profile == AOT_ER_AAC_ELD:
        # ELDSpecificConfig (ISO/IEC 14496-3 §4.6.20.1): enhanced low
        # delay — 512/480-sample frames through the low-delay MDCT
        # filterbank (absent upstream: the reference rejects every ER
        # profile)
        frame_length = 480 if stream.read(1) else 512
        if stream.read(1) or stream.read(1) or stream.read(1):
            raise UnsupportedError(
                "ER resilience tools (RVLC/HCR) not supported.")
        if stream.read(1):  # ldSbrPresentFlag
            raise UnsupportedError("AAC-ELD with LD-SBR not supported.")
        while True:
            ext_type = stream.read(4)
            if ext_type == 0:  # ELDEXT_TERM
                break
            n = stream.read(4)
            if n == 15:
                n += stream.read(8)
            if n == 15 + 255:
                n += stream.read(16)
            stream.advance(8 * n)
        counts = (tables.NUM_SWB_512 if frame_length == 512
                  else tables.NUM_SWB_480)
        if counts[sample_index] == 0:
            raise UnsupportedError(
                f"AAC-ELD undefined at sampling index {sample_index}")
        return StreamConfig(
            profile=profile, sample_index=sample_index,
            sample_rate=sample_rate, chan_config=chan_config,
            frame_length=frame_length, sbr=0, ext_sample_rate=0,
            pce_channels=0)
    pce_channels = 0
    if profile in (AOT_AAC_MAIN, AOT_AAC_LC, AOT_AAC_LTP):
        if stream.read(1):  # frameLengthFlag => 960-sample frames
            # supported (the reference throws here, decoder.js:83-84)
            frame_length = 960
        if stream.read(1):  # dependsOnCoreCoder
            stream.advance(14)  # coreCoderDelay
        if stream.read(1):  # extensionFlag
            # ER-profile resilience flags would follow for profiles > 16
            # (decoder.js:92-96), but those profiles never reach this
            # branch — they are rejected below, in the reference too.
            stream.advance(1)
        if chan_config == CHANNEL_CONFIG_NONE:
            # channel layout comes from an embedded program_config_element
            # (the reference throws here, decoder.js:101-103)
            pce = decode_pce(stream)
            pce_channels = pce.channels
            if pce.sample_index != sample_index:
                sample_index = pce.sample_index
                sample_rate = int(tables.SAMPLE_RATES[sample_index])
    else:
        raise UnsupportedError(f"AAC profile {profile} not supported.")

    return StreamConfig(
        profile=profile,
        sample_index=sample_index,
        sample_rate=sample_rate,
        chan_config=chan_config,
        frame_length=frame_length,
        sbr=sbr,
        ext_sample_rate=ext_sample_rate,
        pce_channels=pce_channels,
    )


def make_asc(profile: int, sample_index: int, chan_config: int,
             frame_length: int = 1024, sbr: bool = False,
             ext_sample_index: int | None = None) -> bytes:
    """Build a minimal ASC (inverse of parse_asc for LC/HE streams)."""
    from aacjax_torch.host.bitio import BitWriter
    w = BitWriter()
    write_asc_bits(w, profile, sample_index, chan_config, frame_length,
                   sbr, ext_sample_index)
    w.align()
    return w.getvalue()


def write_asc_bits(w, profile: int, sample_index: int, chan_config: int,
                   frame_length: int = 1024, sbr: bool = False,
                   ext_sample_index: int | None = None) -> None:
    """Emit the ASC at the bit level (no byte padding — LATM embeds the
    AudioSpecificConfig inline in the StreamMuxConfig)."""
    if profile == AOT_ER_AAC_ELD:
        assert not sbr and frame_length in (512, 480)
        w.write(AOT_ESCAPE, 5)
        w.write(profile - 32, 6)
        w.write(sample_index, 4)
        w.write(chan_config, 4)
        w.write(1 if frame_length == 480 else 0, 1)
        w.write(0, 3)   # section/scalefactor/spectral resilience off
        w.write(0, 1)   # ldSbrPresentFlag
        w.write(0, 4)   # eldExtType = ELDEXT_TERM
        return
    if profile in (AOT_ER_AAC_LC, AOT_ER_AAC_LD):
        assert not sbr
        if profile == AOT_ER_AAC_LD:
            assert frame_length in (512, 480)
            short = frame_length == 480
        else:
            assert frame_length in (1024, 960)
            short = frame_length == 960
        w.write(profile, 5)
        w.write(sample_index, 4)
        w.write(chan_config, 4)
        w.write(1 if short else 0, 1)  # frameLengthFlag
        w.write(0, 1)   # dependsOnCoreCoder
        w.write(1, 1)   # extensionFlag (mandatory for ER profiles)
        w.write(0, 3)   # section/scalefactor/spectral resilience off
        w.write(0, 1)   # extensionFlag3
        w.write(0, 2)   # epConfig 0
        return
    assert frame_length in (1024, 960)
    if sbr:
        w.write(AOT_SBR, 5)
        w.write(sample_index, 4)       # core rate
        w.write(chan_config, 4)
        if ext_sample_index is None:
            # the usual 2x relationship: index of double the core rate
            rates = [int(r) for r in tables.SAMPLE_RATES]
            ext_sample_index = rates.index(2 * rates[sample_index])
        w.write(ext_sample_index, 4)   # output rate
    w.write(profile, 5)
    if not sbr:
        w.write(sample_index, 4)
        w.write(chan_config, 4)
    w.write(1 if frame_length == 960 else 0, 1)  # frameLengthFlag
    w.write(0, 1)  # dependsOnCoreCoder
    w.write(0, 1)  # extensionFlag
