"""Random-access decoding: AACFile — open a complete buffer of any
supported container (ADTS, LOAS/LATM, MP4/M4A, or raw blocks + cookie)
and read arbitrary sample ranges, decoded on an explicit `device`.
Counterpart of `aacjax/file.py`.

The reference has no seek support of its own — Aurora's Player seeks by
restarting the demuxer and the decoder keeps no index (the ADTS probe
scan, adts_demuxer.js:7-20, is its only sync logic).  AAC frames are
independent except for a short decoder-state warm-in (the overlap-add
half-frame and window-shape history, filter_bank.js:38-41 /
ics.js:283-284; plus QMF/envelope history for SBR), so random access is:
index the frame boundaries once, then decode from `warmup` frames before
the target and discard the warm-in output.

For AAC-LC the 1-frame overlap is the only carried state, so a seek-read
is bit-identical to the same range of a full-file decode (PNS streams
excepted: the noise LCG state is a running sequence, so reseeded noise
differs — by design it's noise).  SBR/PS carry longer QMF histories; the
default warmup covers them to below audibility (~-60 dB within a few
frames, converging further in).
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.host import adts
from aacjax_torch.host.asc import UnsupportedError, parse_asc


class AACFile:
    """Random-access reader over a complete AAC byte buffer.

    Usage:
        f = AACFile(open("song.m4a", "rb").read())
        pcm = f.read(start=44100 * 60, n=44100 * 10)   # 60s..70s
        f.seek(12.5); chunk = f.read_chunk()           # player-style

    `read` positions are in OUTPUT samples (2x the core rate for
    HE-AAC).  Decoding batches through the same device pipeline as
    decode_adts, on `device` ("cuda" unless the caller passes "cpu"; a
    CUDA request without CUDA raises); each call decodes only warmup +
    ceil(n/frame) frames.
    """

    def __init__(self, data: bytes, cookie: bytes | None = None,
                 warmup_frames: int | None = None, cce_slots: int = 2,
                 chunk_frames: int = 64,
                 device: str | torch.device = "cuda"):
        from aacjax_torch.host import mp4
        from aacjax_torch.host.latm import probe_loas, split_loas
        self._cce_slots = cce_slots
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self._device} requested but CUDA "
                               "is not available")
        # fixed decode chunk shape, equal to decode_adts's: every frame
        # then runs through the same program as in a full-file decode, so
        # ranged reads are bit-identical to it
        self._chunk_frames = chunk_frames
        # container gapless metadata, in container timescale units
        # (MP4 mdhd timescale — often the SBR output rate for HE-AAC
        # files, not the ASC core rate)
        self._priming = 0
        self._valid = 0
        self._container_ts = 0
        if cookie is not None:
            # raw access units: every payload is one raw_data_block, but
            # boundaries are only discoverable by parsing — random access
            # needs a container; treat the whole buffer as one payload run
            raise UnsupportedError(
                "raw cookie streams have no frame index; use AACDecoder")
        if mp4.probe(data):
            track, payloads = mp4.split_samples(data)
            self.config = track.config
            self._asc = track.asc_raw
            self._priming = track.priming
            self._valid = track.total_samples
            self._container_ts = track.timescale
        elif probe_loas(data):
            mux, payloads = split_loas(data)
            if mux is None or not payloads:
                raise UnsupportedError("no LOAS frames found")
            self.config = mux.config
            self._asc = mux.asc_raw
        else:
            frames = adts.split_frames(data)
            if not frames:
                raise UnsupportedError("no ADTS frames found")
            header = frames[0][0]
            self._asc = adts.synthesize_cookie(header)
            self.config = parse_asc(self._asc)
            payloads = [data[s:e] for _, s, e in frames]
        self._payloads: list[bytes] = payloads
        # warm-in: 1 frame covers the LC overlap/window history exactly;
        # ELD's low-delay filterbank carries THREE pending output
        # segments (pipeline.eld_synthesis), so its history needs 3;
        # SBR/PS carry QMF + envelope state, give them a longer run-in
        if warmup_frames is None:
            warmup_frames = (16 if self._maybe_sbr()
                             else 3 if self.config.profile == 39 else 1)
        self._warmup = warmup_frames
        # resolved on the first decode (implicit SBR doubles the rate,
        # PS doubles the channels — only discoverable by decoding)
        self._frame_out: int | None = None
        self._rate: int | None = None
        self._channels: int | None = None
        self._pos = 0  # streaming cursor for seek()/read_chunk()

    def _maybe_sbr(self) -> bool:
        return bool(self.config.sbr) or (
            self.config.profile in (1, 2) and self.config.sample_rate <= 24000)

    def _resolve(self) -> None:
        if self._frame_out is not None:
            return
        pcm, rate = self._decode_range(0, min(2, len(self._payloads)))
        self._frame_out = pcm.shape[0] // min(2, len(self._payloads))
        self._rate = rate
        self._channels = pcm.shape[1]

    def _decode_range(self, first: int, count: int
                      ) -> tuple[np.ndarray, int]:
        from aacjax_torch.api import _decode_raw_payloads
        group = self._payloads[first:first + count]
        return _decode_raw_payloads(self.config, self._asc, group,
                                    chunk_frames=self._chunk_frames,
                                    cce_slots=self._cce_slots,
                                    on_error="raise", device=self._device)

    # -- stream facts ---------------------------------------------------------
    @property
    def sample_rate(self) -> int:
        self._resolve()
        return self._rate

    @property
    def channels(self) -> int:
        self._resolve()
        return self._channels

    @property
    def frames(self) -> int:
        return len(self._payloads)

    @property
    def total_samples(self) -> int:
        """Output samples in the presentation (gapless trim applied)."""
        self._resolve()
        n = self._frame_out * len(self._payloads) - self._priming_out
        if self._valid:
            n = min(n, round(self._valid * self._rate
                             / (self._timescale or 1)))
        return n

    @property
    def _timescale(self) -> int:
        """Units of the container's priming/valid-duration values: the MP4
        track's mdhd timescale when present (for external HE-AAC .m4a it
        is commonly the SBR output rate, 2x the ASC core rate — dividing
        by the core rate would double the trim), else the core rate."""
        return self._container_ts or self.config.sample_rate

    @property
    def _priming_out(self) -> int:
        self._resolve()
        return round(self._priming * self._rate / (self._timescale or 1))

    @property
    def duration(self) -> float:
        return self.total_samples / self.sample_rate

    # -- random access --------------------------------------------------------
    def read(self, start: int = 0, n: int | None = None) -> np.ndarray:
        """Decode output samples [start, start+n) of the presentation.

        Decodes from `warmup` frames before the covering frame range and
        discards the warm-in, so for AAC-LC the result is bit-identical
        to the same slice of a full-file decode."""
        self._resolve()
        total = self.total_samples
        start = max(0, min(start, total))
        n = total - start if n is None else min(n, total - start)
        if n <= 0:
            return np.zeros((0, self._channels), np.float32)
        # presentation sample -> stream sample (undo the gapless trim)
        s0 = start + self._priming_out
        first = s0 // self._frame_out
        lead = first - max(0, first - self._warmup)
        first -= lead
        count = min((s0 + n - 1) // self._frame_out + 1,
                    len(self._payloads)) - first
        pcm, _ = self._decode_range(first, count)
        off = s0 - first * self._frame_out
        return pcm[off:off + n]

    def read_time(self, start_seconds: float,
                  duration_seconds: float) -> np.ndarray:
        r = self.sample_rate
        return self.read(round(start_seconds * r),
                         round(duration_seconds * r))

    # -- player-style cursor --------------------------------------------------
    def seek(self, seconds: float) -> None:
        self._pos = round(seconds * self.sample_rate)

    def tell(self) -> float:
        return self._pos / self.sample_rate

    def read_chunk(self, n: int | None = None) -> np.ndarray | None:
        """Sequential read at the cursor (None at EOF); default chunk is
        one frame of output samples."""
        self._resolve()
        n = n or self._frame_out
        if self._pos >= self.total_samples:
            return None
        out = self.read(self._pos, n)
        self._pos += out.shape[0]
        return out if out.size else None
