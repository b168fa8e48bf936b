"""Public API: `decode_adts`, `decode_loas`, `decode_m4a`, the streaming
`AACDecoder`.

Counterpart of `aacjax/api.py`: every stream the reference decodes decodes
here, on `device` ("cuda" unless the caller passes "cpu") -- AAC-LC, Main,
LTP, ER-LC, LD and ELD, 1024- and 960-sample frames (512 and 480 for LD /
ELD), mono through 7.1 with coupling channels, HE-AAC v1 (SBR, at twice the
core rate) and v2 (SBR + Parametric Stereo: a mono stream decoded as
stereo), ADTS frames with one or several raw_data_blocks, and LOAS/LATM.
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.host import adts, native
from aacjax_torch.host.asc import StreamConfig, UnsupportedError, parse_asc
from aacjax_torch.host.bitio import (BitReader, BitstreamError,
                                     BitstreamUnderflow)
from aacjax_torch.host.syntax import decode_frame
from aacjax_torch.runtime.batch import (ELD_PROFILE, LTP_PROFILE,
                                        MAIN_PROFILE, BatchDecoder)

CODEC_IDS = ('mp4a', 'aac ')
FRAME = 1024
LC_PROFILE, ER_LC_PROFILE, LD_PROFILE = 2, 17, 23

probe = adts.probe

# AAC decodes channels in element order (C, L, R, SL, SR, LFE for 5.1);
# WAV/FFmpeg use the canonical speaker order.  Permutations indexed by
# chanConfig: canonical[i] = element_order[CANONICAL_ORDER[cfg][i]].
CANONICAL_ORDER = {
    1: [0],
    2: [0, 1],
    3: [1, 2, 0],                 # L R C
    4: [1, 2, 0, 3],              # L R C rear-mono
    5: [1, 2, 0, 3, 4],           # L R C SL SR
    6: [1, 2, 0, 5, 3, 4],        # L R C LFE SL SR
    # chanConfig 7 is spec 7.1 (ISO/IEC 14496-3 Table 1.19): element order
    # C, FLC, FRC, FL, FR, BL, BR, LFE -> FL FR C LFE BL BR FLC FRC
    7: [3, 4, 0, 7, 5, 6, 1, 2],
    8: [1, 2, 0, 7, 5, 6, 3, 4],  # L R C LFE SL SR (side pair first)
    # 11 = 6.1: elements C, L/R, BL/BR, BC, LFE -> L R C LFE BL BR BC
    11: [1, 2, 0, 6, 3, 4, 5],
    # 12 = 7.1 (back): elements C, L/R, SL/SR, BL/BR, LFE
    12: [1, 2, 0, 7, 5, 6, 3, 4],
    # 13 = 22.2 (Amd.4): 16 elements / 24 channels
    13: [3, 4, 0, 10, 7, 8, 1, 2, 9, 11, 5, 6, 13, 14, 12, 17, 18, 19,
         15, 16, 20, 21, 22, 23],
}


def to_canonical_order(pcm: np.ndarray, chan_config: int) -> np.ndarray:
    """Reorder element-order channels to the canonical WAV/FFmpeg layout."""
    perm = CANONICAL_ORDER.get(chan_config)
    return pcm[:, perm] if perm else pcm


class AACDecoder:
    """Streaming decoder: each read_chunk decodes one raw_data_block from
    the current bit position of a continuous bitstream, consuming an
    interleaved ADTS header first when one is present -- so ADTS frames
    with several raw_data_blocks and raw streams both work; LOAS/LATM is
    recognised at the first feed and demuxed as it arrives.

        dec = AACDecoder(device="cpu")
        dec.set_cookie(asc_bytes)      # or feed ADTS / LOAS data and skip this
        dec.feed(data)
        pcm = dec.read_chunk()         # float32 [frame_length*channels],
                                       # interleaved, 1/32768 scale

    The core step of every block runs on `device`; an HE-AAC stream (SBR
    signalled in the ASC, or found on the first frame) gets its high band
    on the host's float64 SBR path (host/sbr_decode.py), the reference's
    streaming route, and read_chunk returns 2 * frame_length samples per
    channel; a mono stream whose SBR extensions carry ps_data (HE-AAC v2)
    becomes stereo there (host/ps_decode.py) from its first ps_data on."""

    floating_point = True

    def __init__(self, cookie: bytes | None = None, cce_slots: int = 2,
                 use_native: bool | None = None, drc_scale: float = 0.0,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.drc_scale = drc_scale
        self.config: StreamConfig | None = None
        self._buffer = bytearray()
        self._bitpos = 0  # bit offset of the next un-decoded raw_data_block
        self._reader: BitReader | None = None
        self._runtime: BatchDecoder | None = None
        self._cce_slots = cce_slots
        self._use_native = use_native  # None = native when built
        # SBR: None = not yet known (implicit signalling shows on the first
        # parsed frame), True/False once known
        self._sbr_mode: bool | None = None
        self._sbr_ctx = None
        self._sbr_procs: list = []
        # Parametric Stereo: (PSProc, right synthesis history) once a mono
        # stream's first ps_data arrives
        self._ps_state: tuple | None = None
        self._refdec = None
        self._transport: str | None = None
        # protected multi-raw_data_block ADTS (13818-7 6.2): the parser
        # records blocks-remaining / per-block-crc per frame here, and the
        # flag keeps the native streaming route off for streams whose blocks
        # carry trailing crc_check words
        self._adts_state: dict = {}
        self._multi_rdb_crc = False
        if cookie is not None:
            self.set_cookie(cookie)

    # -- reference-named aliases -------------------------------------------
    def setCookie(self, buffer: bytes) -> None:  # noqa: N802
        self.set_cookie(buffer)

    def readChunk(self) -> np.ndarray:  # noqa: N802
        return self.read_chunk()

    # -- configuration -------------------------------------------------------
    def _new_runtime(self) -> BatchDecoder:
        return BatchDecoder([self.config], chunk_frames=1,
                            cce_slots=self._cce_slots,
                            use_native=self._use_native,
                            drc_scale=self.drc_scale, device=self.device)

    def set_cookie(self, buffer: bytes) -> None:
        """Parse an AudioSpecificConfig."""
        self.config = parse_asc(buffer)
        self._runtime = self._new_runtime()
        if self.config.sbr:
            self._sbr_mode = True  # explicit signalling

    def feed(self, data: bytes) -> None:
        if self._transport == "loas":
            self._feed_loas(data)
            return
        self._buffer.extend(data)
        self._reader = None  # buffer changed; rebuild lazily
        if self.config is None and self._transport is None:
            # LOAS/LATM sniff: once a full first AudioSyncStream frame (plus
            # the next syncword) is buffered, switch to the incremental LATM
            # demuxer; while the buffer merely looks like LOAS (0x56 0xEx at
            # the start), hold off the ADTS sniff so 0xFFF patterns inside
            # LATM payloads cannot mis-latch it
            from aacjax_torch.host.latm import probe_loas
            buf = bytes(self._buffer)
            if probe_loas(buf):
                self._transport = "loas"
                self._loas_buf = bytearray()
                self._loas_pos = 0
                self._loas_mux = None
                self._buffer.clear()
                self._feed_loas(buf)
                return
            if (len(buf) >= 2 and buf[0] == 0x56
                    and (buf[1] & 0xE0) == 0xE0):
                return  # probably LOAS, first frame still in flight
        if self.config is None:
            # configure from the first ADTS header: a complete header is
            # enough, the frame body may still be in flight
            buf = bytes(self._buffer)
            for pos in range(0, max(len(buf) - 1, 0)):
                if buf[pos] == 0xFF and (buf[pos + 1] & 0xF6) == 0xF0:
                    try:
                        header = adts.read_header(BitReader(buf[pos:]))
                    except BitstreamUnderflow:
                        break  # header split across feeds; wait for more
                    except Exception:  # noqa: BLE001 — not a header; scan on
                        continue
                    self.set_cookie(adts.synthesize_cookie(header))
                    self._bitpos = pos * 8
                    if header.num_frames > 1 and not header.protection_absent:
                        self._multi_rdb_crc = True
                    break

    def _feed_loas(self, data: bytes) -> None:
        """Incremental LOAS demux: complete AudioSyncStream frames yield
        raw_data_block payloads into the decode buffer; a partial trailing
        frame waits for the next feed."""
        from aacjax_torch.host import latm
        self._loas_buf.extend(data)
        buf = self._loas_buf
        pos = self._loas_pos
        while pos + 3 <= len(buf):
            r = BitReader(bytes(buf[pos: pos + 3]))
            if r.read(11) != latm.LOAS_SYNC:
                pos += 1  # resync scan
                continue
            length = r.read(13)
            if pos + 3 + length > len(buf):
                break     # frame still in flight
            fr = BitReader(bytes(buf[pos + 3: pos + 3 + length]))
            try:
                self._loas_mux, payloads = latm.read_audio_mux_element(
                    fr, self._loas_mux)
            except Exception:  # noqa: BLE001 — scan past a corrupt frame
                pos += 1
                continue
            if self.config is None:
                self.set_cookie(self._loas_mux.asc_raw)
            for p in payloads:
                self._buffer.extend(p)
            self._reader = None
            pos += 3 + length
        if pos > 4096:      # drop the consumed prefix
            del self._loas_buf[:pos]
            pos = 0
        self._loas_pos = pos

    def reset(self) -> None:
        """Drop buffered data and decoder state (overlap, shape history);
        keeps the configuration.  Use when seeking to a new position."""
        self._buffer.clear()
        self._bitpos = 0
        self._reader = None
        self._adts_state = {}
        self._sbr_ctx = None
        self._sbr_procs = []
        self._ps_state = None
        self._refdec = None
        self._sbr_mode = (True if (self.config is not None
                                   and self.config.sbr) else None)
        if self.config is not None:
            self._runtime = self._new_runtime()

    @property
    def state(self) -> dict:
        """Serialisable decoder state: buffer bit offset + runtime state
        (overlap buffers, window-shape history)."""
        rt = self._runtime.save_state() if self._runtime else None
        return {"bitpos": self._bitpos, "runtime": rt}

    # -- decoding -------------------------------------------------------------
    def read_chunk(self) -> np.ndarray | None:
        """Decode the next raw_data_block; returns interleaved float32 PCM
        of frame_length*channels samples (1/32768 scale), or None until a
        complete block is buffered."""
        if self.config is None or self._runtime is None:
            if self._buffer:
                return None  # still waiting for a configuring ADTS header
            raise UnsupportedError("no configuration; call set_cookie or feed")
        if self._bitpos >= len(self._buffer) * 8:
            return None
        if self._bitpos // 8 >= 4096:
            # compact the consumed prefix
            drop = self._bitpos // 8
            del self._buffer[:drop]
            self._bitpos -= drop * 8
            self._reader = None
        if (self._runtime.use_native and self._bitpos % 8 == 0
                and self._sbr_mode is False and not self._multi_rdb_crc
                and not self._adts_state.get("block_crc")):
            # native streaming route (only once the stream is known to
            # carry no SBR: the C parser skips FIL extensions): parse one
            # block from the buffered tail; a miss (partial or corrupt
            # data) falls through to the python parser
            res = self._runtime.decode_block(
                bytes(self._buffer[self._bitpos // 8:]))
            if res is not None:
                pcm, consumed = res
                self._bitpos += consumed
                return self._runtime.stream_pcm(pcm, 0, 1).reshape(-1)
        if self._reader is None:
            # one reader per feed (the buffer is immutable between feeds)
            self._reader = BitReader(bytes(self._buffer))
        self._reader.seek_bits(self._bitpos)
        st = self._runtime.streams[0]
        if self._sbr_ctx is None and self._sbr_mode is not False:
            # the parser needs a context to recognise an SBR extension
            from aacjax_torch.host.sbr import SBRContext
            self._sbr_ctx = SBRContext(
                sample_rate=self.config.output_sample_rate if self.config.sbr
                else 2 * self.config.sample_rate)
        try:
            frame = decode_frame(self._reader, self.config, st.prev_shapes,
                                 sbr_ctx=self._sbr_ctx,
                                 drc_scale=self.drc_scale,
                                 adts_state=self._adts_state)
        except BitstreamUnderflow:
            return None  # need more data
        self._bitpos = self._reader.bit_position
        self._runtime._update_shapes(st, frame)
        st.frames_decoded += 1
        if self._sbr_mode is None:
            # implicit signalling resolves on the first decoded frame
            self._sbr_mode = any(
                getattr(e, "sbr", None) is not None for e in frame.elements)
        if self.config.profile == LTP_PROFILE:
            # AAC-LTP: the sequential time-feedback profile runs on the
            # host's float64 decoder (see decode_adts)
            if self._refdec is None:
                from aacjax_torch.host.refdec import ModelDecoder
                self._refdec = ModelDecoder(self.config)
            out = self._refdec.decode_frame(frame).astype(np.float32)
            return out.reshape(-1)
        pcm = self._runtime.step([[frame]])
        out = self._runtime.stream_pcm(pcm, 0, 1)
        if self._sbr_mode:
            out = self._apply_sbr(frame, out)
        return out.reshape(-1)

    def _apply_sbr(self, frame, pcm: np.ndarray) -> np.ndarray:
        """HE-AAC tail: upsample every core channel 2x, rebuilding the high
        band for the elements that carried an SBR payload (float64, the
        reference's per-channel path).  A mono element whose SBR extension
        carries ps_data becomes stereo: its adjusted QMF planes go through
        the PS stage and two synthesis banks.  pcm [frame_length,
        channels]."""
        from aacjax_torch.host import sbr as sbrmod
        from aacjax_torch.host.ps_decode import PSProc, apply_ps
        from aacjax_torch.host.sbr_decode import (SBRChannelProc,
                                                  _qmf_synthesis_np,
                                                  process_channel,
                                                  process_passthrough)
        from aacjax_torch.host.syntax import CPEData
        outs = []
        ch_idx = 0
        for elem in frame.elements:
            nch = 2 if isinstance(elem, CPEData) else 1
            sf = getattr(elem, "sbr", None)
            eq = sbrmod.dequant(sf) if sf is not None else None
            ps = getattr(sf, "ps", None) if sf is not None else None
            if nch == 1 and sf is not None and (
                    ps is not None or self._ps_state is not None):
                while len(self._sbr_procs) <= ch_idx:
                    self._sbr_procs.append(SBRChannelProc())
                proc = self._sbr_procs[ch_idx]
                if self._ps_state is None:
                    self._ps_state = (PSProc(), np.zeros_like(proc.v_hist))
                psproc, v_r = self._ps_state
                core = np.asarray(pcm[:, ch_idx], np.float64)
                X = process_channel(proc, core, sf, 0, eq[0], return_x=True)
                xl, xr = apply_ps(psproc, X, ps)
                left, proc.v_hist = _qmf_synthesis_np(xl, proc.v_hist)
                right, v_r = _qmf_synthesis_np(xr, v_r)
                self._ps_state = (psproc, v_r)
                scale = np.float32(1.0 / 32768.0)
                outs.append(left.astype(np.float32) * scale)
                outs.append(right.astype(np.float32) * scale)
                ch_idx += 1
                continue
            for c in range(nch):
                while len(self._sbr_procs) <= ch_idx:
                    self._sbr_procs.append(SBRChannelProc())
                proc = self._sbr_procs[ch_idx]
                core = np.asarray(pcm[:, ch_idx], np.float64)
                out = (process_channel(proc, core, sf, c, eq[c])
                       if sf is not None else process_passthrough(proc, core))
                outs.append(out.astype(np.float32))
                ch_idx += 1
        return np.stack(outs, axis=1)

    @property
    def output_sample_rate(self) -> int:
        """PCM rate of read_chunk output (2x the core rate with SBR)."""
        if self.config is None:
            raise UnsupportedError("no configuration")
        if self._sbr_mode:
            return (self.config.output_sample_rate if self.config.sbr
                    else 2 * self.config.sample_rate)
        return self.config.sample_rate

    @property
    def output_channels(self) -> int:
        """Channel count of read_chunk output (2 for a mono HE-AAC v2
        stream once ps_data has been seen)."""
        if self.config is None:
            raise UnsupportedError("no configuration")
        if self._ps_state is not None and self.config.channels == 1:
            return 2
        return self.config.channels


def _probe_sbr_ps(data: bytes, frames, config) -> tuple[bool, bool]:
    """Implicitly signalled HE-AAC: does the first frame carry an SBR FIL
    extension, and a ps_data payload?  (Throwaway python parse.)"""
    from aacjax_torch.host.sbr import SBRContext
    _, s, e = frames[0]
    try:
        f = decode_frame(BitReader(data[s:e]), config, [0] * config.channels,
                         sbr_ctx=SBRContext(2 * config.sample_rate))
    except Exception:  # noqa: BLE001 — probe only
        return False, False
    sfs = [getattr(el, "sbr", None) for el in f.elements]
    return (any(sf is not None for sf in sfs),
            any(getattr(sf, "ps", None) is not None for sf in sfs))


def _check_stream(dec: BatchDecoder, on_error: str) -> None:
    """After a chunk: a failed stream raises, or is concealed and goes on."""
    st = dec.streams[0]
    if st.failed:
        if on_error == "raise":
            raise UnsupportedError(f"stream failed: {st.last_error}")
        st.failed = False  # concealed; keep decoding


def _decode_chunks_pipelined(dec: BatchDecoder, payloads, chunk_frames: int,
                             on_error: str):
    """Run one stream's payloads through decode_pipelined with exact f32
    spectra.  Returns the list of per-chunk PCM blocks, or None when the
    native parser delegated the stream to the python route."""
    starts = range(0, len(payloads), chunk_frames)
    sizes = [min(chunk_frames, len(payloads) - i) for i in starts]
    chunks = ([payloads[i:i + chunk_frames]] for i in starts)
    out = []
    for k, pcm in enumerate(dec.decode_pipelined(chunks, out_int16=False,
                                                 compact=False)):
        if dec.streams[0].failed and any(
                int(c) == native.ERR_DELEGATE for c in dec._last_status):
            return None
        _check_stream(dec, on_error)
        out.append(dec.stream_pcm(pcm, 0, sizes[k]))
    return out


def _decode_chunks_stepwise(dec: BatchDecoder, payloads, chunk_frames: int,
                            on_error: str):
    out = []
    for i in range(0, len(payloads), chunk_frames):
        group = payloads[i:i + chunk_frames]
        pcm = dec.step_raw([group], compact=False)
        _check_stream(dec, on_error)
        out.append(dec.stream_pcm(pcm, 0, len(group)))
    return out


def _read_all_chunks(dec: AACDecoder, on_error: str, resync: bool):
    """Drain a fed streaming decoder.  on_error='skip' conceals a corrupt
    block as one frame of silence and, with `resync`, goes on from the next
    ADTS syncword (a raw payload stream has no resync points: it stops)."""
    config = dec.config
    chunks = []
    while True:
        try:
            chunk = dec.read_chunk()
        except Exception:  # noqa: BLE001 — concealment boundary
            if on_error == "raise":
                raise
            if not resync:
                break
            rest = adts.split_frames(bytes(dec._buffer),
                                     start=dec._bitpos // 8 + 1,
                                     resync_overruns=True)
            n = config.frame_length * dec.output_sample_rate \
                // config.sample_rate       # 2x with SBR
            chunks.append(np.zeros((n, dec.output_channels), np.float32))
            if not rest:
                break
            dec._bitpos = rest[0][1] * 8
            continue
        if chunk is None:
            break
        chunks.append(chunk.reshape(-1, dec.output_channels))
    if not chunks:
        raise UnsupportedError("no decodable raw_data_blocks")
    return chunks


def _decode_raw_payloads(config: StreamConfig, asc_raw: bytes,
                         payloads: list[bytes], chunk_frames: int,
                         cce_slots: int, on_error: str,
                         device: str | torch.device
                         ) -> tuple[np.ndarray, int]:
    """Route demuxed raw_data_block payloads (one access unit each):
    configurations that ADTS can express are re-framed onto decode_adts;
    the ER profiles run batched at their own frame length; everything else
    (960-sample frames, explicit SBR signalling, a PCE in the ASC) decodes on
    the streaming decoder with the embedded ASC as the cookie."""
    if (config.frame_length == FRAME and not config.sbr
            and 1 <= config.chan_config <= 7
            and config.profile in (MAIN_PROFILE, LC_PROFILE, LTP_PROFILE)):
        stream = b"".join(adts.wrap_frame(p, config) for p in payloads)
        return decode_adts(stream, chunk_frames=chunk_frames,
                           cce_slots=cce_slots, on_error=on_error,
                           device=device)
    if config.profile in (ER_LC_PROFILE, LD_PROFILE, ELD_PROFILE):
        # no cross-frame time feedback: the blocks run through the batched
        # device pipeline at the profile's frame length (ELD through the
        # low-delay filterbank)
        dec = BatchDecoder([config], chunk_frames=chunk_frames, device=device)
        decode = (_decode_chunks_pipelined if dec.use_native
                  else _decode_chunks_stepwise)
        out = decode(dec, payloads, chunk_frames, on_error)
        return np.concatenate(out, axis=0), config.sample_rate
    dec = AACDecoder(cookie=asc_raw, cce_slots=max(cce_slots, 1),
                     device=device)
    dec.feed(b"".join(payloads))
    chunks = _read_all_chunks(dec, on_error, resync=False)
    return np.concatenate(chunks, axis=0), dec.output_sample_rate


def _decode_he(data: bytes, frames, config, chunk_frames: int,
               cce_slots: int, on_error: str, device,
               has_ps: bool = False) -> tuple[np.ndarray, int]:
    """HE-AAC with one raw_data_block a frame: BatchDecoder.step_he_raw
    chunk by chunk (the core step on `device`, then the batched SBR, or
    SBR + PS, program on the device-resident core PCM), exact spectra and
    planes, f32 PCM at twice the core rate.  A mono stream with PS takes a
    spare slot for its right channel and decodes as stereo."""
    dec = BatchDecoder([config], chunk_frames=chunk_frames,
                       cce_slots=max(cce_slots, 1) if has_ps else cce_slots,
                       device=device)
    payloads = [data[s:e] for _, s, e in frames]
    nch = 2 if has_ps and config.channels == 1 else config.channels
    out = []
    for i in range(0, len(payloads), chunk_frames):
        group = payloads[i:i + chunk_frames]
        pcm = dec.step_he_raw([group], compact=False)       # [C, T, 2F]
        _check_stream(dec, on_error)
        block = pcm[:nch, :len(group)]
        out.append(np.ascontiguousarray(block.reshape(nch, -1).T))
    return np.concatenate(out, axis=0), 2 * config.sample_rate


def decode_loas(data: bytes, chunk_frames: int = 64, cce_slots: int = 2,
                on_error: str = "raise",
                device: str | torch.device = "cuda"
                ) -> tuple[np.ndarray, int]:
    """Decode a LOAS/LATM byte stream (ISO/IEC 14496-3 1.7.3, the broadcast
    transport) on `device`: demux the AudioMuxElements (host/latm.py) and
    route the raw_data_block payloads through _decode_raw_payloads."""
    from aacjax_torch.host import latm
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error: {on_error}")
    mux, payloads = latm.split_loas(data, on_error=on_error)
    if mux is None or not payloads:
        raise UnsupportedError("no LOAS frames found")
    return _decode_raw_payloads(mux.config, mux.asc_raw, payloads,
                                chunk_frames, cce_slots, on_error, device)


def decode_m4a(data: bytes, chunk_frames: int = 64, cce_slots: int = 2,
               on_error: str = "raise", trim: bool = True,
               device: str | torch.device = "cuda"
               ) -> tuple[np.ndarray, int]:
    """Decode an MP4/M4A file buffer (classic or fragmented layout) on
    `device`: demux the track's esds cookie and sample payloads
    (host/mp4.py) and route them through _decode_raw_payloads.

    trim=True applies the container's gapless metadata (edts/elst): the
    encoder-delay priming samples are dropped and the output is cut to the
    signalled valid duration.  Returns (pcm [n, channels], rate)."""
    from aacjax_torch.host import mp4
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error: {on_error}")
    track, payloads = mp4.split_samples(data)
    if not payloads:
        raise UnsupportedError("MP4 track has no samples")
    pcm, rate = _decode_raw_payloads(track.config, track.asc_raw, payloads,
                                     chunk_frames, cce_slots, on_error,
                                     device)
    if trim and (track.priming or track.total_samples):
        # elst units are the media timescale (the core sample rate unless
        # the track says otherwise); scale to output samples (2x with SBR)
        ts = track.timescale or track.config.sample_rate
        pcm = pcm[round(track.priming * rate / ts):]
        if track.total_samples:
            pcm = pcm[:round(track.total_samples * rate / ts)]
    return pcm, rate


def _decode_ltp(data: bytes, frames, config, on_error: str,
                drc_scale: float) -> tuple[np.ndarray, int]:
    """AAC-LTP: each frame's prediction reads the previous frames' time
    output, a sequential loop that would serialise the batched pipeline;
    the profile decodes on the host's float64 decoder (host/refdec.py).
    The native parser feeds it where it can; the per-frame python loop
    stays for concealment, DRC and a missing native parser."""
    from aacjax_torch.host.refdec import ModelDecoder, decode_ltp_native
    if drc_scale == 0.0:
        fast = decode_ltp_native([data[s:e] for _, s, e in frames], config)
        if fast is not None:
            return fast, config.sample_rate
    dec = ModelDecoder(config)
    prev_shapes = [0] * config.channels
    out = []
    for _, s, e in frames:
        try:
            frame = decode_frame(BitReader(data[s:e]), config, prev_shapes)
        except Exception:  # noqa: BLE001 — concealment boundary
            if on_error == "raise":
                raise
            out.append(np.zeros((config.frame_length, config.channels),
                                np.float32))
            continue
        ch = 0
        for el in frame.elements:
            infos = ([el.ics.info] if hasattr(el, "ics")
                     else [el.left.info, el.right.info])
            for info in infos:
                if ch < len(prev_shapes):
                    prev_shapes[ch] = info.window_shape
                ch += 1
        out.append(dec.decode_frame(frame).astype(np.float32))
    if not out:
        raise UnsupportedError("no decodable raw_data_blocks")
    return np.concatenate(out, axis=0), config.sample_rate


def _decode_multi_rdb(data: bytes, frames, header, config, cce_slots: int,
                      on_error: str, drc_scale: float, verify_crc: bool,
                      device) -> tuple[np.ndarray, int]:
    """ADTS frames with several raw_data_blocks: block boundaries show only
    by parsing, so the streaming decoder takes the whole file."""
    dec = AACDecoder(cookie=adts.synthesize_cookie(header),
                     cce_slots=max(cce_slots, 1), drc_scale=drc_scale,
                     device=device)
    if any(h.num_frames > 1 and not h.protection_absent
           for h, _, _ in frames):
        # protected layout (a crc_check word after each block): the python
        # parser skips the CRC words statefully
        dec._multi_rdb_crc = True
    if verify_crc and any(s == e for _, s, e in frames):
        # frames that failed the CRC (emptied by the verify pass) are cut
        # from the fed stream and concealed as silence, one block of
        # frame_length samples per raw_data_block they carried
        chunks = []
        for h, s, e in frames:
            if s == e:
                chunks.extend(
                    np.zeros((config.frame_length, config.channels),
                             np.float32) for _ in range(h.num_frames))
                continue
            dec.feed(data[s - h.header_bytes: e])
            while True:
                chunk = dec.read_chunk()
                if chunk is None:
                    break
                chunks.append(chunk.reshape(-1, config.channels))
        if not chunks:
            raise UnsupportedError("no decodable raw_data_blocks")
        return np.concatenate(chunks, axis=0), config.sample_rate
    dec.feed(data)
    chunks = _read_all_chunks(dec, on_error, resync=True)
    return np.concatenate(chunks, axis=0), config.sample_rate


def decode_adts(data: bytes, chunk_frames: int = 64, cce_slots: int = 2,
                on_error: str = "raise", drc_scale: float = 0.0,
                verify_crc: bool = False,
                device: str | torch.device = "cuda") -> tuple[np.ndarray, int]:
    """Decode a whole ADTS byte stream on `device`.

    Returns (pcm [total_samples, channels] float32 in 1/32768 scale,
    sample_rate).  on_error='raise' aborts on the first malformed frame;
    'skip' conceals it as silence and continues.  cce_slots reserves
    channel slots for coupling channels.  verify_crc=True checks each
    protected frame's crc_check first.  drc_scale in [0, 1] applies that
    fraction of any dynamic_range_info gains.

    AAC-LC and Main streams run through the pipelined batch runtime (content
    the native parser delegates, such as Main with intensity stereo, restarts
    on the python parser and packer); AAC-LTP on the host's float64 decoder;
    frames with several raw_data_blocks on the streaming decoder.  HE-AAC
    v1 (SBR, found by a probe of the first frame) decodes at twice the core
    rate: through BatchDecoder.step_he_raw (the core on the card, then the
    batched SBR program), or the streaming decoder for frames of several
    raw_data_blocks.  HE-AAC v2 (Parametric Stereo in a mono stream's SBR
    extensions) decodes the same way as stereo.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error: {on_error}")
    frames = adts.split_frames(data)
    if not frames:
        raise UnsupportedError("no ADTS frames found")
    if verify_crc:
        checked = []
        for i, (h, s, e) in enumerate(frames):
            # the CRC covers header bits too: rewind to the syncword
            if adts.check_crc(data[s - h.header_bytes: e], h):
                checked.append((h, s, e))
            elif on_error == "raise":
                raise BitstreamError(f"ADTS frame {i}: crc_check mismatch")
            else:
                # an empty payload fails to parse and is concealed
                checked.append((h, s, s))
        frames = checked
    header = frames[0][0]
    config = parse_asc(adts.synthesize_cookie(header))
    if config.profile == LTP_PROFILE:
        return _decode_ltp(data, frames, config, on_error, drc_scale)
    has_sbr, has_ps = _probe_sbr_ps(data, frames, config)
    multi_rdb = any(h.num_frames > 1 for h, _, _ in frames)
    if has_sbr and not multi_rdb:
        return _decode_he(data, frames, config, chunk_frames, cce_slots,
                          on_error, device, has_ps)
    if has_sbr:
        dec = AACDecoder(cookie=adts.synthesize_cookie(header),
                         cce_slots=max(cce_slots, 1), device=device)
        dec.feed(data)
        chunks = _read_all_chunks(dec, on_error, resync=True)
        return np.concatenate(chunks, axis=0), dec.output_sample_rate
    if multi_rdb:
        return _decode_multi_rdb(data, frames, header, config, cce_slots,
                                 on_error, drc_scale, verify_crc, device)
    dec = BatchDecoder([config], chunk_frames=chunk_frames,
                       cce_slots=cce_slots, drc_scale=drc_scale,
                       device=device)
    payloads = [data[s:e] for _, s, e in frames]
    if dec.use_native:
        out = _decode_chunks_pipelined(dec, payloads, chunk_frames, on_error)
        if out is not None:
            return np.concatenate(out, axis=0), config.sample_rate
        # legal content the native route delegates (Main + intensity,
        # prediction + coupling): restart the whole stream on the python
        # route
        dec = BatchDecoder([config], chunk_frames=chunk_frames,
                           cce_slots=cce_slots, drc_scale=drc_scale,
                           use_native=False, device=device)
    out = _decode_chunks_stepwise(dec, payloads, chunk_frames, on_error)
    return np.concatenate(out, axis=0), config.sample_rate
