"""LOAS/LATM transport demux (ISO/IEC 14496-3 §1.7.3).

The reference ships only an ADTS demuxer (adts_demuxer.js); LOAS
(AudioSyncStream framing 0x2B7 + 13-bit length) carrying LATM
AudioMuxElements is the other transport real AAC streams arrive in
(DVB/DAB broadcast, RTP).  This demuxer covers the broadcast-common
shape — single program/single layer, frameLengthType 0 (byte-escape
payload lengths) or 1 (fixed), any numSubFrames, muxConfigPresent=1
with useSameStreamMux carry — and hands the embedded
AudioSpecificConfig plus raw_data_block payloads to the normal decode
pipeline (aacjax.decode_loas).

Conformance: libavcodec's LATM decoder arbitrates (tests/test_latm.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from aacjax_torch.host.asc import StreamConfig, UnsupportedError, parse_asc_bits
from aacjax_torch.host.bitio import BitReader, BitstreamError, BitstreamUnderflow

LOAS_SYNC = 0x2B7


def probe_loas(data: bytes) -> bool:
    """True when `data` looks like a LOAS AudioSyncStream: two
    consecutive sync-framed AudioMuxElements (like adts.probe)."""
    if len(data) < 3:
        return False
    r = BitReader(data)
    try:
        if r.read(11) != LOAS_SYNC:
            return False
        n = r.read(13)
        if n == 0 or 3 + n + 3 > len(data):
            return n > 0 and 3 + n == len(data)
        r.advance(n * 8)
        return r.read(11) == LOAS_SYNC
    except (BitstreamError, BitstreamUnderflow):
        return False


def _extract_bits(data: bytes, start_bit: int, nbits: int) -> bytes:
    """MSB-aligned byte copy of a bit range (the raw embedded ASC, for
    handing to set_cookie when decoding on the streaming path)."""
    if nbits <= 0:
        return b""
    total = len(data) * 8
    val = int.from_bytes(data, "big")
    seg = (val >> (total - start_bit - nbits)) & ((1 << nbits) - 1)
    nbytes = (nbits + 7) // 8
    return int(seg << (nbytes * 8 - nbits)).to_bytes(nbytes, "big")


def _latm_get_value(r: BitReader) -> int:
    n_bytes = r.read(2)
    v = 0
    for _ in range(n_bytes + 1):
        v = (v << 8) | r.read(8)
    return v


@dataclass
class StreamMuxConfig:
    config: StreamConfig
    asc_bits: int = 0
    all_same_framing: bool = True
    num_subframes: int = 1
    frame_length_type: int = 0
    frame_length: int = 0           # frameLengthType 1: bytes per payload
    other_data_bits: int = 0
    asc_raw: bytes = b""            # embedded ASC, MSB-aligned bytes


def read_stream_mux_config(r: BitReader) -> StreamMuxConfig:
    ver = r.read(1)
    ver_a = r.read(1) if ver else 0
    if ver_a:
        raise UnsupportedError("LATM audioMuxVersionA != 0")
    if ver:
        _latm_get_value(r)          # taraBufferFullness
    all_same = bool(r.read(1))
    num_sub = r.read(6) + 1
    num_prog = r.read(4) + 1
    if num_prog != 1:
        raise UnsupportedError("LATM multi-program streams not supported")
    num_layer = r.read(3) + 1
    if num_layer != 1:
        raise UnsupportedError("LATM multi-layer streams not supported")
    if ver == 0:
        start = r.bit_position
        config = parse_asc_bits(r)
        asc_bits = r.bit_position - start
        asc_raw = _extract_bits(r._data, start, asc_bits)
    else:
        asc_len = _latm_get_value(r)
        start = r.bit_position
        config = parse_asc_bits(r)
        used = r.bit_position - start
        if used > asc_len:
            raise BitstreamError("LATM ascLen shorter than the ASC")
        r.advance(asc_len - used)   # fillBits
        asc_bits = asc_len
        asc_raw = _extract_bits(r._data, start, used)
    flt = r.read(3)
    cfg = StreamMuxConfig(config=config, asc_bits=asc_bits,
                          all_same_framing=all_same,
                          num_subframes=num_sub, frame_length_type=flt,
                          asc_raw=asc_raw)
    if flt == 0:
        r.read(8)                   # latmBufferFullness
    elif flt == 1:
        cfg.frame_length = r.read(9)
    else:
        raise UnsupportedError(f"LATM frameLengthType {flt} not supported")
    if r.read(1):                   # otherDataPresent
        if ver:
            cfg.other_data_bits = _latm_get_value(r)
        else:
            bits = 0
            esc = True
            while esc:
                bits <<= 8
                esc = bool(r.read(1))
                bits += r.read(8)
            cfg.other_data_bits = bits
    else:
        cfg.other_data_bits = 0
    if r.read(1):                   # crcCheckPresent
        r.read(8)
    return cfg


def read_audio_mux_element(r: BitReader,
                           prev: StreamMuxConfig | None
                           ) -> tuple[StreamMuxConfig, list[bytes]]:
    """AudioMuxElement(muxConfigPresent=1) -> (mux config in effect,
    raw_data_block payloads, one per subframe)."""
    if r.read(1):                   # useSameStreamMux
        if prev is None:
            raise BitstreamError("LATM frame reuses a mux config "
                                 "before any was sent")
        cfg = prev
    else:
        cfg = read_stream_mux_config(r)
    payloads = []
    for _ in range(cfg.num_subframes):
        if cfg.frame_length_type == 0:
            n = 0
            while True:
                tmp = r.read(8)
                n += tmp
                if tmp != 255:
                    break
        else:
            n = cfg.frame_length + 20   # §1.7.3.1: fixed length in bytes
        payload = bytes(r.read(8) for _ in range(n))
        payloads.append(payload)
    if getattr(cfg, "other_data_bits", 0):
        r.advance(cfg.other_data_bits)
    return cfg, payloads


def split_loas(data: bytes, on_error: str = "raise"
               ) -> tuple[StreamMuxConfig | None, list[bytes]]:
    """Demux a whole LOAS byte stream: returns (the first
    StreamMuxConfig — .config is the StreamConfig, .asc_raw the embedded
    ASC bytes — and the raw_data_block payloads).  on_error='skip'
    resynchronizes to the next 0x2B7 syncword after a corrupt frame."""
    pos = 0
    cfg: StreamMuxConfig | None = None
    config = None
    payloads: list[bytes] = []
    n = len(data)
    while pos + 3 <= n:
        r = BitReader(data[pos:])
        try:
            if r.read(11) != LOAS_SYNC:
                raise BitstreamError("LOAS sync lost")
            length = r.read(13)
            if pos + 3 + length > n:
                break               # trailing partial frame
            fr = BitReader(data[pos + 3: pos + 3 + length])
            cfg, frame_payloads = read_audio_mux_element(fr, cfg)
            if config is None:
                config = cfg
            payloads.extend(frame_payloads)
            pos += 3 + length
        except (BitstreamError, BitstreamUnderflow, UnsupportedError):
            if on_error == "raise":
                raise
            nxt = _next_sync(data, pos + 1)
            if nxt < 0:
                break
            pos = nxt
    return config, payloads


def _next_sync(data: bytes, start: int) -> int:
    for i in range(start, len(data) - 1):
        if data[i] == 0x56 and (data[i + 1] & 0xE0) == 0xE0:
            return i
    return -1
