"""Frame-by-frame float64 decode of one stream, the reference of the
output check: AAC-LC, or HE-AAC v1 with the SBR tool applied to every
channel element that carries an SBR extension (44.1 kHz out of a
22.05 kHz core).

A configuration names the module of portbench/reference/ that decodes its
streams by its `reference_decoder` key (this module where it names none).
Such a module gives `decoder(facts, precision)`: `facts` is the
configuration's file without its corpus, with `sbr` (the route's SBR)
added, and the result's `decode(payload)` returns one frame's float64 PCM
[samples, output channels] in the 1/32768 scale."""
from __future__ import annotations

import numpy as np

from portbench.reference import sbr as sbrmod
from portbench.reference.asc import StreamConfig, stream_config
from portbench.reference.bitio import BitReader
from portbench.reference.precision import PRECISIONS
from portbench.reference.refdec import ModelDecoder
from portbench.reference.sbr_decode import SBRChannelProc, process_channel
from portbench.reference.syntax import CPEData, SCEData, decode_frame


def to_int16(pcm: np.ndarray) -> np.ndarray:
    """Float PCM in the 1/32768 scale to int16, rounded to nearest even
    and clipped."""
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)


def decoder(facts: dict, precision: str) -> "Decoder":
    """The reference decoder of a configuration's streams: AAC-LC of its
    coded `channels` at its `sample_index`, with SBR where `sbr`."""
    return Decoder(stream_config(2, facts["sample_index"], facts["channels"]),
                   facts["sbr"], precision)


class Decoder:
    """One stream from its first frame on.  `sbr`: apply HE-AAC v1's SBR
    (the output then has twice the core's samples a frame).  `precision`:
    a key of precision.PRECISIONS.  `sbr_readers`: readers of the SBR
    extended data's payloads by extension id (sbr.read_sbr_extension),
    none by default."""

    def __init__(self, config: StreamConfig, sbr: bool,
                 precision: str = "exact", sbr_readers: dict | None = None):
        rnd = PRECISIONS[precision]
        self.config = config
        self.sbr_readers = sbr_readers
        self.prev_shapes = [0] * config.channels
        self.core = ModelDecoder(config, rnd=rnd)
        self.sbr_ctx = (sbrmod.SBRContext(sample_rate=2 * config.sample_rate)
                        if sbr else None)
        self.procs = [SBRChannelProc(rnd=rnd) for _ in range(config.channels)]

    def decode(self, payload: bytes) -> np.ndarray:
        """One frame's PCM [samples, channels], float64 in the 1/32768
        scale."""
        frame = decode_frame(BitReader(payload), self.config,
                             self.prev_shapes, sbr_ctx=self.sbr_ctx,
                             sbr_readers=self.sbr_readers)
        ch = 0
        for elem in frame.elements:
            if isinstance(elem, SCEData):
                self.prev_shapes[ch] = elem.ics.info.window_shape
                ch += 1
            elif isinstance(elem, CPEData):
                self.prev_shapes[ch] = elem.left.info.window_shape
                self.prev_shapes[ch + 1] = elem.right.info.window_shape
                ch += 2
        pcm = self.core.decode_frame(frame)
        if self.sbr_ctx is None:
            return pcm
        outs, ch = [], 0
        for elem in frame.elements:
            if not isinstance(elem, (SCEData, CPEData)):
                continue
            nch = 2 if isinstance(elem, CPEData) else 1
            sf = getattr(elem, "sbr", None)
            if sf is None:
                raise ValueError("an HE-AAC frame without an SBR extension")
            eq = sbrmod.dequant(sf)
            for c in range(nch):
                outs.append(process_channel(self.procs[ch], pcm[:, ch], sf,
                                            c, eq[c]))
                ch += 1
        return np.stack(outs, axis=1)
