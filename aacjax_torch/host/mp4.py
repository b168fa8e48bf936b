"""MP4/M4A container demux: extract AAC access units + the ASC cookie.

The reference registers itself for codec id 'mp4a' (decoder.js:30-31) and
relies on the Aurora.js ecosystem's separate MP4 demuxer to deliver the
esds "magic cookie" and raw sample payloads.  aacjax ships the demuxer so
`.m4a`/`.mp4` files decode end-to-end with no external framework:

  - classic MP4 (moov sample tables: stsd/esds, stts, stsc, stsz/stz2,
    stco/co64), moov before or after mdat,
  - fragmented MP4 (moov+mvex/trex defaults, moof/traf/tfhd/trun runs),
  - iTunes-style gapless metadata (edts/elst encoder delay + valid
    duration), exposed as `priming` / `total_samples` so the decode API
    can trim to the source PCM length.

Pure byte-aligned struct parsing (ISO/IEC 14496-12 box syntax +
14496-1 §7.2.6 ES_Descriptor); no BitReader needed.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from aacjax_torch.host.asc import StreamConfig, UnsupportedError, parse_asc

_FTYP_LIKE = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
              b"styp", b"sidx", b"moof", b"pdin")


def probe(data: bytes) -> bool:
    """True if `data` looks like an ISO-BMFF (MP4/M4A) file: a plausible
    box header at offset 0 whose type is a well-known top-level box."""
    if len(data) < 8:
        return False
    return data[4:8] in _FTYP_LIKE


def _be(data, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "big")


class MP4Error(UnsupportedError):
    pass


def _boxes(data, start: int, end: int):
    """Iterate (fourcc, payload_start, payload_end, box_start) over the
    sibling boxes in data[start:end].  Stops at the first malformed
    header (truncated or impossible size)."""
    pos = start
    while pos + 8 <= end:
        size = _be(data, pos, 4)
        typ = bytes(data[pos + 4:pos + 8])
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = _be(data, pos + 8, 8)
            hdr = 16
        elif size == 0:
            size = end - pos  # box extends to end of enclosing scope
        if size < hdr or pos + size > end:
            return
        yield typ, pos + hdr, pos + size, pos
        pos += size


def _find(data, start, end, fourcc: bytes):
    for typ, s, e, _ in _boxes(data, start, end):
        if typ == fourcc:
            return s, e
    return None


# -- esds --------------------------------------------------------------------

def _desc_len(data, pos: int) -> tuple[int, int]:
    """MPEG-4 descriptor expandable size: up to 4 bytes of 7-bit groups."""
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not (b & 0x80):
            break
    return size, pos


def parse_esds(data, start: int, end: int) -> bytes:
    """Extract the AudioSpecificConfig (DecoderSpecificInfo payload) from
    an esds box body (ISO/IEC 14496-1 §7.2.6.5-6)."""
    pos = start + 4  # version/flags
    if pos >= end or data[pos] != 0x03:  # ES_DescrTag
        raise MP4Error("esds: missing ES_Descriptor")
    _, pos = _desc_len(data, pos + 1)
    pos += 2  # ES_ID
    flags = data[pos]
    pos += 1
    if flags & 0x80:  # streamDependenceFlag
        pos += 2
    if flags & 0x40:  # URL_Flag
        pos += 1 + data[pos]
    if flags & 0x20:  # OCRstreamFlag
        pos += 2
    if pos >= end or data[pos] != 0x04:  # DecoderConfigDescrTag
        raise MP4Error("esds: missing DecoderConfigDescriptor")
    dlen, pos = _desc_len(data, pos + 1)
    dend = pos + dlen
    oti = data[pos]
    # 0x40 = MPEG-4 Audio; 0x66/67/68 = MPEG-2 AAC Main/LC/SSR (their
    # DecSpecificInfo is still an AudioSpecificConfig in practice)
    if oti not in (0x40, 0x66, 0x67, 0x68):
        raise MP4Error(f"esds: objectTypeIndication 0x{oti:02x} is not AAC")
    pos += 13  # OTI + streamType/upStream/bufferSizeDB(3) + max/avg bitrate(8)
    if pos >= dend or data[pos] != 0x05:  # DecSpecificInfoTag
        raise MP4Error("esds: missing DecoderSpecificInfo (ASC)")
    slen, pos = _desc_len(data, pos + 1)
    if pos + slen > end:
        raise MP4Error("esds: truncated ASC")
    return bytes(data[pos:pos + slen])


# -- track tables ------------------------------------------------------------

@dataclass
class MP4Track:
    asc_raw: bytes
    config: StreamConfig
    timescale: int                     # mdhd media timescale
    samples: list[tuple[int, int]]     # absolute (start, end) byte ranges
    priming: int = 0                   # encoder delay, media-timescale units
    total_samples: int = 0             # valid duration after priming (0 = all)
    sample_durations: list[int] = field(default_factory=list)


def _parse_stsd_audio(data, start: int, end: int) -> bytes:
    """Return the ASC from the first mp4a sample entry in an stsd body."""
    count = _be(data, start + 4, 4)
    pos = start + 8
    for _ in range(count):
        if pos + 16 > end:
            break
        size = _be(data, pos, 4)
        fmt = bytes(data[pos + 4:pos + 8])
        entry_end = min(pos + size, end)
        if fmt in (b"mp4a", b"enca"):
            # AudioSampleEntry: 6 reserved + 2 data_ref_index, then the
            # (QuickTime-versioned) 20-byte audio fields
            body = pos + 16
            version = _be(data, body, 2)
            extra = {0: 0, 1: 16, 2: 36}.get(version, 0)
            child0 = body + 20 + extra
            scope = [(child0, entry_end)]
            while scope:
                s, e = scope.pop()
                for typ, cs, ce, _ in _boxes(data, s, e):
                    if typ == b"esds":
                        return parse_esds(data, cs, ce)
                    if typ == b"wave":  # QuickTime wrapper around esds
                        scope.append((cs, ce))
            raise MP4Error("mp4a entry without esds")
        pos += max(size, 16)
    raise MP4Error("no mp4a sample entry in stsd")


def _parse_stbl(data, start: int, end: int):
    """Return (asc, sizes, chunk_offsets, stsc_entries, durations)."""
    asc = None
    sizes: list[int] = []
    offsets: list[int] = []
    stsc: list[tuple[int, int]] = []
    durations: list[int] = []
    for typ, s, e, _ in _boxes(data, start, end):
        if typ == b"stsd":
            asc = _parse_stsd_audio(data, s, e)
        elif typ == b"stsz":
            uniform = _be(data, s + 4, 4)
            count = _be(data, s + 8, 4)
            if uniform:
                sizes = [uniform] * count
            else:
                sizes = [_be(data, s + 12 + 4 * i, 4) for i in range(count)]
        elif typ == b"stz2":
            bits = _be(data, s + 4, 4) & 0xFF
            count = _be(data, s + 8, 4)
            if bits == 4:
                sizes = [(data[s + 12 + i // 2] >> (0 if i & 1 else 4)) & 0xF
                         for i in range(count)]
            elif bits in (8, 16):
                nb = bits // 8
                sizes = [_be(data, s + 12 + nb * i, nb)
                         for i in range(count)]
        elif typ in (b"stco", b"co64"):
            nb = 4 if typ == b"stco" else 8
            count = _be(data, s + 4, 4)
            offsets = [_be(data, s + 8 + nb * i, nb) for i in range(count)]
        elif typ == b"stsc":
            count = _be(data, s + 4, 4)
            stsc = [(_be(data, s + 8 + 12 * i, 4),
                     _be(data, s + 12 + 12 * i, 4)) for i in range(count)]
        elif typ == b"stts":
            count = _be(data, s + 4, 4)
            for i in range(count):
                n = _be(data, s + 8 + 8 * i, 4)
                d = _be(data, s + 12 + 8 * i, 4)
                durations.extend([d] * n)
    return asc, sizes, offsets, stsc, durations


def _resolve_ranges(sizes, offsets, stsc) -> list[tuple[int, int]]:
    """Expand stsc/stco/stsz into absolute per-sample byte ranges."""
    ranges: list[tuple[int, int]] = []
    if not offsets or not stsc:
        return ranges
    si = 0
    nchunks = len(offsets)
    for i, (first, per) in enumerate(stsc):
        last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else nchunks
        for chunk in range(first, last + 1):
            if chunk > nchunks or si >= len(sizes):
                break
            pos = offsets[chunk - 1]
            for _ in range(per):
                if si >= len(sizes):
                    break
                ranges.append((pos, pos + sizes[si]))
                pos += sizes[si]
                si += 1
    return ranges


# -- fragmented (moof/trun) ---------------------------------------------------

def _parse_trex(data, start: int, end: int) -> dict[int, int]:
    """mvex/trex default sample sizes keyed by track_ID."""
    out = {}
    for typ, s, e, _ in _boxes(data, start, end):
        if typ == b"trex":
            track_id = _be(data, s + 4, 4)
            out[track_id] = _be(data, s + 16, 4)  # default_sample_size
    return out


def _parse_moof(data, start: int, end: int, moof_pos: int, track_id: int,
                trex_size: int) -> list[tuple[int, int]]:
    ranges: list[tuple[int, int]] = []
    for typ, s, e, _ in _boxes(data, start, end):
        if typ != b"traf":
            continue
        base = moof_pos
        tfhd_size = trex_size
        this_track = False
        for t2, s2, e2, _ in _boxes(data, s, e):
            if t2 == b"tfhd":
                flags = _be(data, s2, 4) & 0xFFFFFF
                tid = _be(data, s2 + 4, 4)
                this_track = (tid == track_id)
                pos = s2 + 8
                if flags & 0x1:        # base-data-offset
                    base = _be(data, pos, 8)
                    pos += 8
                if flags & 0x2:        # sample-description-index
                    pos += 4
                if flags & 0x8:        # default-sample-duration
                    pos += 4
                if flags & 0x10:       # default-sample-size
                    tfhd_size = _be(data, pos, 4)
                    pos += 4
                # 0x20000 default-base-is-moof: base stays moof_pos
        if not this_track:
            continue
        for t2, s2, e2, _ in _boxes(data, s, e):
            if t2 != b"trun":
                continue
            flags = _be(data, s2, 4) & 0xFFFFFF
            count = _be(data, s2 + 4, 4)
            pos = s2 + 8
            offset = base
            if flags & 0x1:            # data-offset
                offset = base + int.from_bytes(
                    data[pos:pos + 4], "big", signed=True)
                pos += 4
            if flags & 0x4:            # first-sample-flags
                pos += 4
            for _ in range(count):
                if flags & 0x100:      # sample-duration
                    pos += 4
                size = tfhd_size
                if flags & 0x200:      # sample-size
                    size = _be(data, pos, 4)
                    pos += 4
                if flags & 0x400:      # sample-flags
                    pos += 4
                if flags & 0x800:      # sample-composition-time-offset
                    pos += 4
                ranges.append((offset, offset + size))
                offset += size
    return ranges


# -- top level ----------------------------------------------------------------

def parse(data: bytes) -> MP4Track:
    """Demux the first AAC audio track of an MP4/M4A byte buffer."""
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise MP4Error("no moov box")
    ms, me = moov
    movie_ts = 0
    mv = _find(data, ms, me, b"mvhd")
    if mv:
        version = data[mv[0]]
        movie_ts = _be(data, mv[0] + (20 if version else 12), 4)
    trex = {}
    mvex = _find(data, ms, me, b"mvex")
    if mvex:
        trex = _parse_trex(data, *mvex)

    for typ, ts_, te, _ in _boxes(data, ms, me):
        if typ != b"trak":
            continue
        track_id = 0
        tk = _find(data, ts_, te, b"tkhd")
        if tk:
            version = data[tk[0]]
            track_id = _be(data, tk[0] + (20 if version else 12), 4)
        mdia = _find(data, ts_, te, b"mdia")
        if mdia is None:
            continue
        hdlr = _find(data, *mdia, b"hdlr")
        if hdlr is None or data[hdlr[0] + 8:hdlr[0] + 12] != b"soun":
            continue
        mdhd = _find(data, *mdia, b"mdhd")
        timescale = 0
        if mdhd:
            version = data[mdhd[0]]
            timescale = _be(data, mdhd[0] + (20 if version else 12), 4)
        minf = _find(data, *mdia, b"minf")
        if minf is None:
            continue
        stbl = _find(data, *minf, b"stbl")
        if stbl is None:
            continue
        asc, sizes, offsets, stsc, durations = _parse_stbl(data, *stbl)
        if asc is None:
            continue
        ranges = _resolve_ranges(sizes, offsets, stsc)
        if not ranges:
            # fragmented MP4: walk the moof boxes
            for t2, s2, e2, p2 in _boxes(data, 0, len(data)):
                if t2 == b"moof":
                    ranges.extend(_parse_moof(data, s2, e2, p2, track_id,
                                              trex.get(track_id, 0)))
        # iTunes gapless: edts/elst encoder delay + valid duration
        priming = 0
        total = 0
        edts = _find(data, ts_, te, b"edts")
        if edts:
            elst = _find(data, *edts, b"elst")
            if elst:
                s2 = elst[0]
                version = data[s2]
                count = _be(data, s2 + 4, 4)
                pos = s2 + 8
                for _ in range(count):
                    if version:
                        seg = _be(data, pos, 8)
                        media = int.from_bytes(data[pos + 8:pos + 16],
                                               "big", signed=True)
                        pos += 20
                    else:
                        seg = _be(data, pos, 4)
                        media = int.from_bytes(data[pos + 4:pos + 8],
                                               "big", signed=True)
                        pos += 12
                    if media == -1:
                        continue  # empty edit (presentation delay)
                    priming = max(media, 0)
                    if movie_ts and timescale:
                        total = round(seg * timescale / movie_ts)
                    break
        # single pass: list-membership filtering is O(n*m) and a truncated
        # or fuzzed file can push most ranges past EOF
        ranges = [r for r in ranges if 0 <= r[0] and r[1] <= len(data)]
        if not ranges:
            raise MP4Error("audio track has no resolvable samples")
        return MP4Track(asc_raw=asc, config=parse_asc(asc),
                        timescale=timescale, samples=ranges,
                        priming=priming, total_samples=total,
                        sample_durations=durations)
    raise MP4Error("no AAC audio track")


def split_samples(data: bytes) -> tuple[MP4Track, list[bytes]]:
    """Demux to (track, raw access-unit payloads)."""
    track = parse(data)
    return track, [bytes(data[s:e]) for s, e in track.samples]
