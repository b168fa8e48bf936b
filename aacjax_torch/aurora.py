"""Aurora.js-style evented facade over the pull-style aacjax API.

The reference is a codec plugin for the Aurora (`av`) framework: its
demuxer surface is push/event-driven — `emit('format', ...)`,
`emit('cookie', ...)`, `emit('data', ...)` (adts_demuxer.js:59-70) —
and its decoder is driven by repeated `readChunk()` calls that emit
decoded PCM.  aacjax's native surface is pull-style (`probe`,
`feed`/`read_chunk`, `decode_adts`); this module completes the L6
mirror (SURVEY.md §1) with a thin event layer so Aurora-shaped callers
can port 1:1:

    demux = ADTSDemuxer()
    demux.on('format', lambda fmt: ...)
    demux.on('cookie', lambda asc: ...)
    dec = AuroraDecoder()
    demux.pipe(dec)                      # cookie/data -> decoder
    dec.on('data', lambda pcm: ...)      # interleaved float32, 1/32768
    demux.feed(adts_bytes)               # push as data arrives
    dec.decode_all()                     # or readChunk() per frame

Reference parity notes:
  - `data` events carry the raw buffers UNSTRIPPED — ADTS headers stay
    in-band and the decoder re-reads them per frame, exactly like
    decoder.js:128-130 tolerates header-interleaved payloads.
  - the cookie is the 2-byte AudioSpecificConfig synthesized from ADTS
    fields (adts_demuxer.js:66-70 semantics).
  - `format` mirrors the reference's event fields: formatID 'aac ',
    sampleRate, channelsPerFrame, plus floatingPoint=True the way the
    reference decoder's init() forces it (decoder.js:49-51).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable

import numpy as np

from aacjax_torch import tables
from aacjax_torch.api import AACDecoder
from aacjax_torch.host import adts
from aacjax_torch.host.bitio import BitReader


class EventEmitter:
    """Minimal Aurora-style emitter: on/off/once/emit."""

    def __init__(self):
        self._handlers: dict[str, list[Callable]] = defaultdict(list)
        self._once: dict[str, list[Callable]] = defaultdict(list)

    def on(self, event: str, fn: Callable) -> "EventEmitter":
        self._handlers[event].append(fn)
        return self

    def once(self, event: str, fn: Callable) -> "EventEmitter":
        self._once[event].append(fn)
        return self

    def off(self, event: str, fn: Callable) -> None:
        if fn in self._handlers.get(event, []):
            self._handlers[event].remove(fn)

    def emit(self, event: str, *args) -> None:
        for fn in list(self._handlers.get(event, [])):
            fn(*args)
        once, self._once[event] = self._once[event], []
        for fn in once:
            fn(*args)


class ADTSDemuxer(EventEmitter):
    """Push-style ADTS demuxer emitting 'format' / 'cookie' / 'data'
    (+ 'end'), mirroring the reference's Aurora demuxer."""

    def __init__(self):
        super().__init__()
        self._buf = bytearray()
        self._configured = False

    @staticmethod
    def probe(buffer: bytes) -> bool:
        """Syncword scan; position-preserving like adts_demuxer.js:7-20."""
        return adts.probe(bytes(buffer))

    def feed(self, data: bytes) -> None:
        """Push transport bytes; fires 'format'+'cookie' once the first
        full header is visible, then 'data' with the raw (unstripped)
        bytes."""
        if not self._configured:
            self._buf.extend(data)
            buf = bytes(self._buf)
            pos = 0
            while pos + 9 <= len(buf):
                if buf[pos] == 0xFF and (buf[pos + 1] & 0xF6) == 0xF0:
                    try:
                        header = adts.read_header(
                            BitReader(memoryview(buf)[pos:pos + 9]))
                    except Exception:  # noqa: BLE001 — resync scan
                        pos += 1
                        continue
                    self.emit("format", {
                        "formatID": "aac ",
                        "sampleRate": int(
                            tables.SAMPLE_RATES[header.sampling_index]),
                        "channelsPerFrame": header.chan_config,
                        "floatingPoint": True,
                    })
                    self.emit("cookie", adts.synthesize_cookie(header))
                    self._configured = True
                    break
                pos += 1
            if self._configured:
                out = bytes(self._buf)
                self._buf = bytearray()
                self.emit("data", out)
            return
        self.emit("data", bytes(data))

    def end(self) -> None:
        self.emit("end")

    def pipe(self, decoder: "AuroraDecoder") -> "AuroraDecoder":
        """Wire cookie/data/end into an AuroraDecoder (the Aurora player
        loop's plumbing in one call)."""
        self.once("cookie", decoder.setCookie)
        self.on("data", decoder.feed)
        self.on("end", lambda: decoder.decode_all(end=True))
        return decoder


class AuroraDecoder(EventEmitter):
    """Event-emitting wrapper over AACDecoder: readChunk() decodes one
    frame and emits 'data' with interleaved float32 PCM (1/32768 scale,
    reference decoder.js:204-215 convention); 'error' mirrors the
    reference's thrown decode errors."""

    def __init__(self, **kwargs):
        super().__init__()
        self._dec = AACDecoder(**kwargs)

    # reference-surface aliases
    def setCookie(self, buffer: bytes) -> None:  # noqa: N802
        self._dec.set_cookie(bytes(buffer))

    def feed(self, data: bytes) -> None:
        self._dec.feed(bytes(data))

    @property
    def format(self):
        cfg = self._dec.config
        return None if cfg is None else {
            "sampleRate": cfg.sample_rate,
            "channelsPerFrame": cfg.channels,
            "floatingPoint": True,
        }

    def readChunk(self) -> np.ndarray | None:  # noqa: N802
        """Decode one frame; emits 'data' (or 'error') and returns the
        PCM like the reference's readChunk."""
        try:
            pcm = self._dec.read_chunk()
        except Exception as exc:  # noqa: BLE001 — reference throws
            self.emit("error", exc)
            raise
        if pcm is not None:
            self.emit("data", pcm)
        return pcm

    def decode_all(self, end: bool = False) -> int:
        """Drain every decodable frame (the Aurora play-loop's repeated
        readChunk); returns the number of frames emitted."""
        n = 0
        while True:
            pcm = self.readChunk()
            if pcm is None:
                break
            n += 1
        if end:
            self.emit("end")
        return n
