"""ADTS transport parsing: probe, header parse, frame segmentation, cookie.

Reproduces the behavior of the reference adts_demuxer.js:
  - probe scans 16-bit words for the 0xFFFx syncword without moving the
    stream position (adts_demuxer.js:7-20),
  - readHeader parses the 7/9-byte header (adts_demuxer.js:28-52),
  - a 2-byte AudioSpecificConfig "magic cookie" is synthesized from the
    header fields (adts_demuxer.js:66-70).

Additionally provides frame segmentation (split a byte stream into ADTS
frames by walking frameLength), which the reference delegates to the decoder
re-reading headers inline (decoder.js:128-130) — our batched runtime needs
explicit frame boundaries up front.
"""
from __future__ import annotations

from dataclasses import dataclass

from aacjax_torch.host.bitio import BitReader, BitstreamError


@dataclass(frozen=True)
class ADTSHeader:
    profile: int           # MPEG-4 audioObjectType (profile bits + 1)
    sampling_index: int
    chan_config: int
    frame_length: int      # whole ADTS frame incl. header, bytes
    num_frames: int        # raw_data_blocks in frame (usually 1)
    protection_absent: bool
    header_bytes: int      # 7, 9, or 7 + 2*(num_frames-1) + 2 (multi-rdb)
    crc_value: int = 0     # transmitted crc_check when protection present
    # protected multi-rdb frames (13818-7 §6.2 adts_header_error_check):
    # raw_data_block_position[1..N], byte offsets of blocks 1..N from the
    # start of the first raw data block
    rdb_positions: tuple = ()


def probe(data: bytes) -> bool:
    """True if an ADTS syncword appears on any 16-bit-aligned scan position.

    Mirrors adts_demuxer.js:7-20: scans consecutive u16 reads (i.e. even
    byte offsets) for (word & 0xfff6) == 0xfff0.
    """
    for i in range(0, len(data) - 1, 2):
        word = (data[i] << 8) | data[i + 1]
        if (word & 0xFFF6) == 0xFFF0:
            return True
    return False


def read_header(stream: BitReader) -> ADTSHeader:
    """Parse one ADTS header at the current position (adts_demuxer.js:28-52)."""
    if stream.read(12) != 0xFFF:
        raise BitstreamError("Invalid ADTS header.")
    stream.advance(3)                       # MPEG version + layer
    protection_absent = bool(stream.read(1))
    profile = stream.read(2) + 1
    sampling_index = stream.read(4)
    stream.advance(1)                       # private
    chan_config = stream.read(3)
    stream.advance(4)                       # original/copy, home, (c), (c) start
    frame_length = stream.read(13)
    stream.advance(11)                      # buffer fullness
    num_frames = stream.read(2) + 1
    crc_value = 0
    positions: tuple = ()
    if not protection_absent:
        # ISO/IEC 13818-7 §6.2: single-rdb frames carry adts_error_check
        # (crc_check only); multi-rdb frames carry
        # adts_header_error_check (raw_data_block_position[1..N] then
        # crc_check), and each raw data block is followed by its own
        # 16-bit adts_raw_data_block_error_check.  The reference skips
        # verification entirely (adts_demuxer.js:48-49 advances 16 bits
        # without checking), as does libavcodec; compute_crc/check_crc
        # verify on request (decode_adts verify_crc=True).
        if num_frames > 1:
            positions = tuple(stream.read(16)
                              for _ in range(num_frames - 1))
        crc_value = stream.read(16)
    if protection_absent:
        header_bytes = 7
    else:
        header_bytes = 7 + 2 * (num_frames - 1) + 2
    return ADTSHeader(
        profile=profile,
        sampling_index=sampling_index,
        chan_config=chan_config,
        frame_length=frame_length,
        num_frames=num_frames,
        protection_absent=protection_absent,
        header_bytes=header_bytes,
        crc_value=crc_value,
        rdb_positions=positions,
    )


# ---------------------------------------------------------------------------
# ADTS CRC (ISO/IEC 13818-7 §6.2 adts_error_check, §8.2.2 CRC algorithm)
# ---------------------------------------------------------------------------
# Generator polynomial G(x) = x^16 + x^15 + x^2 + 1 (0x8005, MSB-first),
# register preset to all ones; the remainder is transmitted highest
# coefficient first ("rpchof") as the 16-bit crc_check field.
#
# Coverage (single-raw_data_block frames, number_of_raw_data_blocks == 0):
# the 56 bits of adts_fixed_header + adts_variable_header (everything
# before crc_check) followed by the first min(192, len) bits of the
# raw_data_block — §8.2.2 caps each block's protected span at 192 bits so
# a receiver can verify with bounded buffering.  Both spans are
# byte-aligned in ADTS (7-byte headers, byte-aligned blocks after the
# 9-byte protected header).
#
# There is no oracle for this field in this environment: the reference
# skips it (adts_demuxer.js:48-49), and so do libavcodec and faad-family
# decoders — so the implementation is validated by symmetric
# encode-verify round trips plus corruption rejection (tests/test_adts.py
# CRC cases), and the coverage rule above is the documented contract.

_CRC_SPAN_BYTES = 192 // 8   # §8.2.2: 192 protected bits per block


def _crc16(data: bytes, reg: int = 0xFFFF) -> int:
    for b in data:
        reg ^= b << 8
        for _ in range(8):
            reg = (((reg << 1) ^ 0x8005) if reg & 0x8000
                   else (reg << 1)) & 0xFFFF
    return reg


def compute_crc(header7: bytes, payload: bytes) -> int:
    """crc_check for a single-raw_data_block ADTS frame: header7 is the
    7 bytes preceding crc_check (with protection_absent already 0),
    payload the raw_data_block."""
    return _crc16(header7 + payload[:_CRC_SPAN_BYTES])


def check_crc(frame: bytes, header: ADTSHeader) -> bool:
    """Verify one whole ADTS frame's CRC protection.  Frames without
    protection verify trivially True.

    Multi-rdb frames (num_frames > 1) verify the header crc_check —
    covering the 56 header bits plus the raw_data_block_position words —
    AND every block's trailing adts_raw_data_block_error_check (each
    covering the first min(192, len) bits of its raw data block, the
    same §8.2.2 span rule as the single-rdb case)."""
    status = crc_block_status(frame, header)
    return status is None or all(status)


def crc_block_status(frame: bytes, header: ADTSHeader
                     ) -> list[bool] | None:
    """Per-unit CRC verdicts for one whole ADTS frame, or None when the
    frame carries no protection.  Single-rdb frames return [ok];
    multi-rdb frames return [header_ok, block0_ok, ..., blockN_ok] so a
    receiver can conceal just the corrupt raw_data_block(s)."""
    if header.protection_absent:
        return None
    if header.num_frames == 1:
        if len(frame) < 9:
            return [False]
        return [compute_crc(frame[:7], frame[9:]) == header.crc_value]
    n = header.num_frames
    base = header.header_bytes          # first raw data block start
    if len(frame) < base:
        return [False] * (n + 1)
    pos_bytes = frame[7: 7 + 2 * (n - 1)]
    header_ok = _crc16(frame[:7] + pos_bytes) == header.crc_value
    # block i spans [p_i, p_{i+1} - 2) relative to `base` (each block is
    # followed by its 2-byte crc_check); p_0 = 0, p_i from the header's
    # position words, the last block ends 2 bytes before the frame end
    bounds = [0, *header.rdb_positions, len(frame) - base]
    out = [header_ok]
    for i in range(n):
        lo, hi = base + bounds[i], base + bounds[i + 1] - 2
        ok = (0 <= lo <= hi <= len(frame) - 2
              and _crc16(frame[lo:hi][:_CRC_SPAN_BYTES])
              == int.from_bytes(frame[hi:hi + 2], "big"))
        out.append(ok)
    return out


def synthesize_cookie(header: ADTSHeader) -> bytes:
    """2-byte AudioSpecificConfig from ADTS fields (adts_demuxer.js:66-70)."""
    b0 = ((header.profile << 3) | ((header.sampling_index >> 1) & 7)) & 0xFF
    b1 = (((header.sampling_index & 1) << 7) | (header.chan_config << 3)) & 0xFF
    return bytes([b0, b1])


def split_frames(data: bytes, start: int = 0,
                 resync_overruns: bool = False
                 ) -> list[tuple[ADTSHeader, int, int]]:
    """Segment `data` into ADTS frames.

    Returns a list of (header, payload_start, payload_end) byte ranges, where
    the payload is the raw_data_block bytes (header/CRC stripped).  Resyncs
    to the next syncword on malformed lengths, which the reference does not
    attempt (its probe scan is the only sync logic — SURVEY.md §5).

    A frame whose length runs past the end of `data` is normally treated
    as a truncated tail (more data may arrive in a streaming feed) and
    segmentation stops; with resync_overruns=True it is treated as a false
    syncword (e.g. 0xFF bytes inside a corrupt payload) and the scan
    continues from the next byte — use when `data` is known complete.
    """
    frames = []
    pos = start
    n = len(data)
    while pos + 7 <= n:
        if not (data[pos] == 0xFF and (data[pos + 1] & 0xF6) == 0xF0):
            pos += 1  # resync scan
            continue
        # 15 bytes covers the longest header form: 7 fixed/variable +
        # 2*3 position words + 2 crc (protected 4-rdb frame)
        stream = BitReader(memoryview(data)[pos:pos + 15])
        try:
            header = read_header(stream)
        except BitstreamError:
            pos += 1
            continue
        if header.frame_length < header.header_bytes:
            pos += 1  # malformed length: resync scan from the next byte
            continue
        end = pos + header.frame_length
        if end > n:
            if resync_overruns:
                pos += 1
                continue
            break  # truncated trailing frame (more data may arrive)
        frames.append((header, pos + header.header_bytes, end))
        pos = end
    return frames


def wrap_frame(payload: bytes, config) -> bytes:
    """Wrap a raw_data_block in a 7-byte ADTS header — the inverse of
    split_frames for configs ADTS can signal (used e.g. to route LATM
    payloads through the batched ADTS decode path)."""
    from aacjax_torch.host.bitio import BitWriter
    w = BitWriter()
    length = len(payload) + 7
    w.write(0xFFF, 12)
    w.write(0b000, 3)            # MPEG-4, layer 00
    w.write(1, 1)                # protection_absent
    w.write(config.profile - 1, 2)
    w.write(config.sample_index, 4)
    w.write(0, 1)                # private
    w.write(config.chan_config, 3)
    w.write(0, 4)                # original/home/(c)/(c)start
    w.write(length, 13)
    w.write(0x7FF, 11)           # buffer fullness (VBR)
    w.write(0, 2)                # numFrames - 1
    return w.getvalue() + payload
