"""Minimal M4A/MP4 muxer for test fixtures.

Writes the classic (ftyp + mdat + moov with full sample tables) and
fragmented (moov+mvex, then moof+mdat runs) layouts that
aacjax.host.mp4 demuxes, including esds ASC embedding, co64 offsets,
and iTunes-style elst gapless metadata.  Test-only: the decode path
never imports this module.
"""
from __future__ import annotations

import struct


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


def _desc(tag: int, payload: bytes) -> bytes:
    # 4-byte expandable length (0x80-continued) like common muxers emit
    n = len(payload)
    size = bytes([0x80 | ((n >> 21) & 0x7F), 0x80 | ((n >> 14) & 0x7F),
                  0x80 | ((n >> 7) & 0x7F), n & 0x7F])
    return bytes([tag]) + size + payload


def _esds(asc: bytes) -> bytes:
    dsi = _desc(0x05, asc)
    dcd = _desc(0x04, bytes([0x40, 0x15]) + b"\x00\x00\x00"  # OTI, streamType
                + struct.pack(">II", 0, 0) + dsi)            # max/avg bitrate
    sl = _desc(0x06, b"\x02")
    es = _desc(0x03, struct.pack(">HB", 1, 0) + dcd + sl)
    return _full(b"esds", 0, 0, es)


def _mp4a_entry(asc: bytes, channels: int, sample_rate: int,
                qt_version: int = 0) -> bytes:
    body = (b"\x00" * 6 + struct.pack(">H", 1)            # data_ref_index
            + struct.pack(">HH", qt_version, 0) + b"\x00" * 4
            + struct.pack(">HHHH", channels, 16, 0, 0)
            + struct.pack(">I", min(sample_rate, 65535) << 16))
    if qt_version == 1:
        body += struct.pack(">IIII", 1024, 0, 0, 2)       # QT v1 extras
    body += _esds(asc)
    return _box(b"mp4a", body)


def _stbl(asc: bytes, channels: int, sample_rate: int, sizes: list[int],
          chunk_offsets: list[int], samples_per_chunk: int,
          frame_length: int, co64: bool = False,
          qt_version: int = 0) -> bytes:
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1)
                 + _mp4a_entry(asc, channels, sample_rate, qt_version))
    stts = _full(b"stts", 0, 0,
                 struct.pack(">III", 1, len(sizes), frame_length))
    stsc = _full(b"stsc", 0, 0,
                 struct.pack(">IIII", 1, 1, samples_per_chunk, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(sizes))
                 + b"".join(struct.pack(">I", s) for s in sizes))
    if co64:
        stco = _full(b"co64", 0, 0, struct.pack(">I", len(chunk_offsets))
                     + b"".join(struct.pack(">Q", o) for o in chunk_offsets))
    else:
        stco = _full(b"stco", 0, 0, struct.pack(">I", len(chunk_offsets))
                     + b"".join(struct.pack(">I", o) for o in chunk_offsets))
    return _box(b"stbl", stsd + stts + stsc + stsz + stco)


def _trak(asc: bytes, channels: int, sample_rate: int, sizes: list[int],
          chunk_offsets: list[int], samples_per_chunk: int,
          frame_length: int, duration: int, movie_ts: int,
          priming: int = 0, valid: int = 0, co64: bool = False,
          qt_version: int = 0) -> bytes:
    tkhd = _full(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0,
                 duration * movie_ts // max(sample_rate, 1))
                 + b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0x0100, 0)
                 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                               0x40000000) + struct.pack(">II", 0, 0))
    edts = b""
    if priming or valid:
        seg_movie = (valid or (duration - priming)) * movie_ts \
            // max(sample_rate, 1)
        elst = _full(b"elst", 0, 0, struct.pack(">I", 1)
                     + struct.pack(">IiH H", seg_movie, priming, 1, 0))
        edts = _box(b"edts", elst)
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, sample_rate,
                                            duration)
                 + struct.pack(">HH", 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0) + b"soun"
                 + b"\x00" * 12 + b"SoundHandler\x00")
    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1)
                 + _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    stbl = _stbl(asc, channels, sample_rate, sizes, chunk_offsets,
                 samples_per_chunk, frame_length, co64, qt_version)
    minf = _box(b"minf", smhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    return _box(b"trak", tkhd + edts + mdia)


def mux_m4a(payloads: list[bytes], asc: bytes, sample_rate: int,
            channels: int, frame_length: int = 1024,
            samples_per_chunk: int = 4, priming: int = 0,
            valid_samples: int = 0, co64: bool = False,
            moov_first: bool = False, qt_version: int = 0,
            movie_ts: int = 600) -> bytes:
    """Classic MP4: ftyp + mdat + moov (or moov-before-mdat faststart)."""
    ftyp = _box(b"ftyp", b"M4A \x00\x00\x02\x00M4A isommp42")
    mdat_payload = b"".join(payloads)
    sizes = [len(p) for p in payloads]
    duration = frame_length * len(payloads)

    def moov_for(mdat_pos: int) -> bytes:
        offsets = []
        pos = mdat_pos + 8
        for i in range(0, len(sizes), samples_per_chunk):
            offsets.append(pos)
            pos += sum(sizes[i:i + samples_per_chunk])
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, movie_ts,
                     duration * movie_ts // max(sample_rate, 1))
                     + struct.pack(">IH H II", 0x10000, 0x0100, 0, 0, 0)
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0,
                                   0, 0x40000000)
                     + b"\x00" * 24 + struct.pack(">I", 2))
        trak = _trak(asc, channels, sample_rate, sizes, offsets,
                     samples_per_chunk, frame_length, duration, movie_ts,
                     priming, valid_samples, co64, qt_version)
        return _box(b"moov", mvhd + trak)

    if moov_first:
        # faststart layout: moov size is stable (offsets are just shifted),
        # so compute it once with a dummy position, then re-emit
        dummy = moov_for(0)
        mdat_pos = len(ftyp) + len(dummy)
        return ftyp + moov_for(mdat_pos) + _box(b"mdat", mdat_payload)
    mdat_pos = len(ftyp)
    return ftyp + _box(b"mdat", mdat_payload) + moov_for(mdat_pos)


def mux_fmp4(payload_runs: list[list[bytes]], asc: bytes, sample_rate: int,
             channels: int, frame_length: int = 1024) -> bytes:
    """Fragmented MP4: moov carries only mvex/trex defaults; each run of
    payloads becomes one moof+mdat pair with a trun sample-size table."""
    ftyp = _box(b"ftyp", b"iso5\x00\x00\x02\x00iso5dash")
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, sample_rate, 0)
                 + struct.pack(">IH H II", 0x10000, 0x0100, 0, 0, 0)
                 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                               0x40000000)
                 + b"\x00" * 24 + struct.pack(">I", 2))
    trak = _trak(asc, channels, sample_rate, [], [], 1, frame_length, 0,
                 sample_rate)
    trex = _full(b"trex", 0, 0, struct.pack(">IIIII", 1, 1, frame_length,
                                            0, 0))
    mvex = _box(b"mvex", trex)
    moov = _box(b"moov", mvhd + trak + mvex)
    out = bytearray(ftyp + moov)
    for seq, run in enumerate(payload_runs, start=1):
        mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", seq))
        # default-base-is-moof (0x20000); per-sample sizes in trun
        tfhd = _full(b"tfhd", 0, 0x20000 | 0x8,
                     struct.pack(">II", 1, frame_length))
        tfdt = _full(b"tfdt", 1, 0,
                     struct.pack(">Q", (seq - 1) * frame_length * len(run)))
        trun_payload = struct.pack(">I", len(run))
        # data-offset + sample-size flags
        trun_flags = 0x1 | 0x200
        sizes_blob = b"".join(struct.pack(">I", len(p)) for p in run)
        traf_probe = _box(b"traf", tfhd + tfdt + _full(
            b"trun", 0, trun_flags,
            trun_payload + struct.pack(">i", 0) + sizes_blob))
        moof_size = 8 + len(mfhd) + len(traf_probe)
        data_offset = moof_size + 8  # first byte after the mdat header
        trun = _full(b"trun", 0, trun_flags,
                     trun_payload + struct.pack(">i", data_offset)
                     + sizes_blob)
        traf = _box(b"traf", tfhd + tfdt + trun)
        moof = _box(b"moof", mfhd + traf)
        out += moof + _box(b"mdat", b"".join(run))
    return bytes(out)
