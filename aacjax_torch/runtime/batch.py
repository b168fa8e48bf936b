"""Batched multi-stream AAC decode runtime on one device.

Counterpart of `aacjax/runtime/batch.py` `BatchDecoder` without its SBR/PS
half: AAC-LC, Main, LTP, ER-LC, LD and ELD streams at 1024, 960, 512 or 480
samples a frame, with coupling channels.  It owns the per-stream decoder
state (the per-channel overlap, [C, F] or [C, 3F] for ELD, and the
Main-profile predictor state [C, 672, 6], both kept on the device between
chunks, and the per-channel previous window shape used by the parsers) and
drives host parse -> host-to-device copy -> device step -> int16 or f32 PCM
back to the host.

Three parse routes, as in the reference: the native parser (one C call per
chunk, then `decode_spec_step`); the python parser and packer
(`runtime/pack.py`, then `decode_step`), which the native route hands a
chunk to when a stream carries content it delegates; and, for a batch of
AAC-LTP streams only, the vectorised float64 engine on the host
(`host/ltp_batch.py`).

On CUDA the host buffers the native parser writes into are pinned, the
copies to the device run on their own stream, the decode step on a
compute stream and the copies back on a third, ordered by CUDA events.
The overlap and the predictor state are read and written only on the
compute stream, so consecutive chunks need no event between them.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from aacjax_torch.host import native
from aacjax_torch.host.asc import StreamConfig
from aacjax_torch.host.bitio import BitReader
from aacjax_torch.host.syntax import CPEData, Frame, SCEData, decode_frame
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import pred
from aacjax_torch.runtime.pack import pack_frames
from aacjax_torch.runtime.stats import DecodeStats

FRAME = 1024
NATIVE_FRAME_LENGTHS = (1024, 960, 512, 480)
MAIN_PROFILE, LTP_PROFILE, ELD_PROFILE = 1, 4, 39


def _h2d_fields(F: int) -> dict:
    """SpecBatchArrays fields with leading [C, T] that travel to the
    device: name -> (dtype, trailing dims)."""
    return {
        "spec": (torch.float32, (F,)),
        "spec_i16": (torch.int16, (F,)),
        "spec_scale": (torch.float32, (F // native.I16_BLOCK,)),
        "meta": (torch.int32, (6,)),
        "tns_lpc": (torch.float32, (2, native.TNS_SLOTS, native.TNS_ORDER)),
        "tns_range": (torch.int32, (2, native.TNS_SLOTS, 2)),
    }


_PRED_FIELDS = {"pred_meta": (torch.int32, (3,)),
                "pred_used": (torch.uint8, (P.PRED_BINS,))}


@dataclass
class StreamState:
    """Host-side per-stream state (the overlap lives in BatchDecoder.overlap).
    prev_shapes is a view into the decoder's shared window-shape history."""
    config: StreamConfig
    base_slot: int
    n_slots: int               # channels + cce_slots
    prev_shapes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    frames_decoded: int = 0
    failed: bool = False
    last_error: str = ""


class BatchDecoder:
    """Decodes T-frame chunks for a fixed set of concurrent streams on
    `device` ("cuda" by default; "cpu" runs the kernels' plain versions).
    All streams share one frame length, and ELD streams are not mixed with
    others (both are part of the chunk's program)."""

    def __init__(self, configs: list[StreamConfig], chunk_frames: int = 16,
                 cce_slots: int = 0, use_native: bool | None = None,
                 drc_scale: float = 0.0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.T = chunk_frames
        self.drc_scale = drc_scale
        self._cce_slots = cce_slots
        self.streams: list[StreamState] = []
        c = 0
        for cfg in configs:
            n = cfg.channels + cce_slots
            self.streams.append(StreamState(cfg, base_slot=c, n_slots=n))
            c += n
        self.C = c
        frame_lens = {cfg.frame_length for cfg in configs} or {FRAME}
        if len(frame_lens) > 1:
            raise ValueError(
                f"streams mix frame lengths {sorted(frame_lens)}; "
                "use one BatchDecoder per frame length")
        self.F = frame_lens.pop()
        # AAC-ELD carries three pending output segments per channel
        self._eld = any(cfg.profile == ELD_PROFILE for cfg in configs)
        if self._eld and not all(cfg.profile == ELD_PROFILE
                                 for cfg in configs):
            raise ValueError("cannot mix ELD and non-ELD streams in one "
                             "BatchDecoder")
        # an all-LTP batch decodes on the host's vectorised float64 engine
        # (LTP's time feedback serialises the frames of a stream); a mixed
        # batch keeps the per-frame python route
        any_ltp = any(cfg.profile == LTP_PROFILE for cfg in configs)
        self._ltp_batch = None
        if (any_ltp and native.available()
                and all(cfg.profile == LTP_PROFILE
                        and cfg.frame_length == FRAME for cfg in configs)):
            from aacjax_torch.host.ltp_batch import LTPBatchDecoder
            self._ltp_batch = LTPBatchDecoder(configs)
        self._any_main = any(cfg.profile == MAIN_PROFILE for cfg in configs)
        self.use_native = ((native.available()
                            and self.F in NATIVE_FRAME_LENGTHS
                            and not any_ltp)
                           if use_native is None else use_native)
        if self.use_native and self.F not in NATIVE_FRAME_LENGTHS:
            raise ValueError(f"native parser: unsupported frame length "
                             f"{self.F}")
        # one shared window-shape history; the StreamStates view into it so
        # the native batch call updates everything in place
        self.prev_shapes = np.zeros(c, np.int32)
        for st in self.streams:
            st.prev_shapes = self.prev_shapes[
                st.base_slot:st.base_slot + st.n_slots]
        self._sample_indices = np.array(
            [st.config.sample_index for st in self.streams], np.int32)
        self._chan_configs = np.array(
            [st.config.chan_config for st in self.streams], np.int32)
        self._base_slots = np.array(
            [st.base_slot for st in self.streams], np.int32)
        self._n_slots = np.array([st.n_slots for st in self.streams], np.int32)
        self._tables_pack = (native.stream_tables(configs)
                             if self.use_native else None)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
        self._ov_width = 3 * self.F if self._eld else self.F
        self._set_overlap(np.zeros((c, self._ov_width), np.float32))
        self._pred_state: torch.Tensor | None = None
        # two parse buffers (double-buffered pipeline) for the native route,
        # made here so that no decode pays for pinning them; and per buffer
        # the event after which its last host-to-device copy has landed
        self._buffers = ([self._alloc_buffer(), self._alloc_buffer()]
                         if self.use_native else None)
        self._h2d_done: list[torch.cuda.Event | None] = [None, None]
        self._pending_steps: dict[int, tuple] = {}
        # a reset asked for while a pipelined generator runs waits for the
        # next chunk boundary (request_reset)
        self._pipeline_active = False
        self._deferred_resets: list[tuple[int, StreamConfig | None]] = []
        self._last_status = np.zeros(len(self.streams), np.int32)
        self._last_consumed = np.zeros(1, np.int64)
        self.stats = DecodeStats(
            sample_rate=configs[0].sample_rate if configs else 44100)

    # -- buffers and state ---------------------------------------------------
    def _alloc_buffer(self) -> tuple[native.SpecBatchArrays, dict]:
        """Parser output arrays whose device-bound fields are numpy views of
        torch tensors (pinned on CUDA): the native parser and compact_spec
        write straight into memory the copy engine can read."""
        arrays = native.SpecBatchArrays(self.C, self.T, self.F)
        # entries after TNS need a coupling slot each; two targets per
        # coupling channel and frame (SpecBatchArrays' fixed 64 fails a
        # wide batch of coupled streams with "post entries overflow")
        arrays.post_cap = max(arrays.post_cap,
                              2 * self._cce_slots * len(self.streams) * self.T)
        host = {}

        def bind(name, shape, dtype):
            t = torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)
            host[name] = t
            setattr(arrays, name, t.numpy())

        fields = dict(_h2d_fields(self.F))
        if self._any_main:
            fields.update(_PRED_FIELDS)
        for name, (dtype, dims) in fields.items():
            bind(name, (self.C, self.T) + dims, dtype)
        bind("cce_post_idx", (arrays.post_cap, 3), torch.int32)
        bind("cce_post_gain", (arrays.post_cap, self.F), torch.float32)
        bind("cce_time_idx", (arrays.time_cap, 3), torch.int32)
        bind("cce_time_gain", (arrays.time_cap,), torch.float32)
        return arrays, host

    def _on_compute(self):
        """Context in which device work joins the compute stream."""
        if self._cuda:
            return torch.cuda.stream(self._compute_stream)
        import contextlib
        return contextlib.nullcontext()

    def _set_overlap(self, overlap: np.ndarray) -> None:
        ov = torch.from_numpy(np.array(overlap, np.float32))   # a copy
        if ov.shape != (self.C, self._ov_width):
            raise ValueError(f"overlap shape {tuple(ov.shape)}, expected "
                             f"{(self.C, self._ov_width)}")
        with self._on_compute():
            self.overlap = ov.to(self.device)

    def _sync_compute(self) -> None:
        if self._cuda:
            self._compute_stream.synchronize()

    # -- host parse: the python route ------------------------------------------
    def parse_stream_frames(self, stream_idx: int,
                            payloads: list[bytes]) -> list[Frame]:
        """Parse raw_data_block payloads of one stream with the python
        parser, threading the previous window shape per channel."""
        st = self.streams[stream_idx]
        frames = []
        for payload in payloads:
            frame = decode_frame(BitReader(payload), st.config,
                                 st.prev_shapes, drc_scale=self.drc_scale)
            self._update_shapes(st, frame)
            st.frames_decoded += 1
            frames.append(frame)
        return frames

    @staticmethod
    def _update_shapes(st: StreamState, frame: Frame) -> None:
        ch = 0
        for elem in frame.elements:
            if isinstance(elem, SCEData):
                st.prev_shapes[ch] = elem.ics.info.window_shape
                ch += 1
            elif isinstance(elem, CPEData):
                st.prev_shapes[ch] = elem.left.info.window_shape
                st.prev_shapes[ch + 1] = elem.right.info.window_shape
                ch += 2

    def _to_device(self, name: str, a: np.ndarray) -> torch.Tensor:
        """A packed numpy array as the device step takes it: flags as
        int32, the predictor's `used` mask as uint8."""
        if a.dtype == np.bool_:
            a = a.astype(np.int32)
        elif name == "pred_used":
            a = a.astype(np.uint8)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self, frames_per_stream: list[list[Frame] | None]) -> np.ndarray:
        """Run one chunk of python-parsed frames: frames_per_stream[i] is
        up to T frames for stream i (None or empty to skip).  The packer's
        numpy batch is uploaded to the device and goes through
        `decode_step`.  Returns pcm [C, T, F] float32 in the 1/32768 scale;
        stream_pcm() slices it."""
        per_slot, limits = [], []
        for st, frames in zip(self.streams, frames_per_stream):
            if frames:
                if len(frames) > self.T:
                    raise ValueError(f"{len(frames)} frames > chunk size "
                                     f"{self.T}")
                per_slot.append((st.base_slot, frames))
                limits.append(st.n_slots)
        batch, flags = pack_frames(per_slot, self.C, self.T, limits,
                                   frame_len=self.F, eld=self._eld)
        flags = dataclasses.replace(flags, use_pallas=True)
        with self._on_compute():
            dev = {k: self._to_device(k, v) for k, v in batch.items()}
            if flags.has_pred:
                if self._pred_state is None:
                    self._pred_state = pred.pred_state_init(self.C,
                                                            self.device)
                pcm, self.overlap, self._pred_state = P.decode_step(
                    dev, self.overlap, flags, self._pred_state)
            else:
                pcm, self.overlap = P.decode_step(dev, self.overlap, flags)
            return pcm.cpu().numpy()

    def _step_python_raw(self, payloads_per_stream) -> np.ndarray:
        """The python-parser route with the native route's per-stream error
        isolation: a failing stream keeps the frames parsed before the
        corrupt one; the failing frame and what follows are dropped."""
        frames_per_stream = []
        for i, payloads in enumerate(payloads_per_stream):
            if not payloads:
                frames_per_stream.append(None)
                continue
            st = self.streams[i]
            frames: list[Frame] = []
            for payload in payloads:
                try:
                    frame = decode_frame(BitReader(payload), st.config,
                                         st.prev_shapes,
                                         drc_scale=self.drc_scale)
                except Exception as e:  # noqa: BLE001 — per-stream isolation
                    st.failed = True
                    st.last_error = str(e)
                    break
                self._update_shapes(st, frame)
                st.frames_decoded += 1
                frames.append(frame)
            frames_per_stream.append(frames or None)
        return self.step(frames_per_stream)

    # -- host parse: the native route --------------------------------------------
    def _parse_native(self, payloads_per_stream, buf_slot: int = 0,
                      compact: bool = True) -> dict:
        """One native C call parses every stream's chunk into buffer
        `buf_slot`.  Returns a batch of host tensors plus '_'-prefixed
        host-side facts.  A batch with a Main-profile stream ships exact f32
        spectra whatever `compact` says: the predictor's state feeds back
        across frames and is sensitive to the last bit."""
        if self._any_main:
            compact = False
        if self._buffers is None:
            raise RuntimeError("this decoder was made with use_native=False")
        arrays, host = self._buffers[buf_slot]
        ev = self._h2d_done[buf_slot]
        if ev is not None:
            # the previous copy out of this buffer must have landed before
            # the parser overwrites it
            ev.synchronize()
        t0 = time.perf_counter()
        status, has_tns, errmsg = native.parse_batch_spec(
            payloads_per_stream, self._sample_indices, self._chan_configs,
            self._base_slots, self._n_slots, self.prev_shapes, arrays,
            tables_pack=self._tables_pack, want_pred=self._any_main)
        self._last_status = status
        self._last_consumed = arrays.consumed_bits
        if self.drc_scale > 0 and arrays.fil_drc.any():
            self._apply_native_drc(payloads_per_stream, arrays)
        for i, st in enumerate(self.streams):
            code = int(status[i])
            if code == native.ERR_FALLBACK:
                st.failed = True
                st.last_error = (f"native parse: {errmsg or 'capacity'}; "
                                 "raise cce_slots to cover coupling channels")
            elif code == native.ERR_DELEGATE:
                # step_raw redoes the chunk on the python route; other
                # callers surface the reason
                st.failed = True
                st.last_error = (f"native parse delegates: {errmsg}; "
                                 "decodes on the python parse path "
                                 "(use_native=False)")
            elif code != 0:
                st.failed = True
                st.last_error = errmsg or f"native parse error code {code}"
                st.frames_decoded += len(payloads_per_stream[i] or [])
            elif payloads_per_stream[i]:
                st.frames_decoded += len(payloads_per_stream[i])
        if compact:
            native.compact_spec(arrays)   # writes into the host tensors
            keys = ["spec_i16", "spec_scale", "meta"]
        else:
            keys = ["spec", "meta"]
        if has_tns:
            keys += ["tns_lpc", "tns_range"]
        batch = {k: host[k] for k in keys}
        # the coupling entries travel as they are counted: eager PyTorch has
        # no program to recompile per entry count, so the reference's padding
        # to a power of two would only add gathers of zero-gain rows
        n_post, n_time = (int(n) for n in arrays.cce_counts)
        if n_post:
            batch.update(cce_post_idx=host["cce_post_idx"][:n_post],
                         cce_post_gain=host["cce_post_gain"][:n_post])
        if n_time:
            batch.update(cce_time_idx=host["cce_time_idx"][:n_time],
                         cce_time_gain=host["cce_time_gain"][:n_time])
        if self._any_main:
            batch.update(pred_meta=host["pred_meta"],
                         pred_used_u8=host["pred_used"])
        meta = arrays.meta
        batch.update(
            _slot=buf_slot, _has_tns=has_tns,
            _has_short=bool(meta[:, :, 4].any()), _spec_i16=compact,
            _has_pred=self._any_main, _has_cce_post=n_post > 0,
            _has_cce_time=n_time > 0,
            _parse_seconds=time.perf_counter() - t0,
            _n_stream_frames=sum(len(p) for p in payloads_per_stream if p),
            _n_channel_frames=int((meta[:, :, 5] != 0).sum()))
        return batch

    def _apply_native_drc(self, payloads_per_stream, out) -> None:
        """Fold each frame's dynamic_range_info gains (FIL payload found by
        the native walker at out.fil_drc) into the dequantized spectra."""
        from aacjax_torch.host.syntax import read_drc_info
        fil = out.fil_drc
        g = 0
        for i, payloads in enumerate(payloads_per_stream):
            st = self.streams[i]
            for t, payload in enumerate(payloads or []):
                bitpos = int(fil[g])
                g += 1
                if bitpos == 0:
                    continue
                r = BitReader(payload)
                r.seek_bits(bitpos)
                r.read(4)                      # EXT_DYNAMIC_RANGE
                drc = read_drc_info(r, self.F)
                lin = np.power(10.0, drc.gain_db * self.drc_scale / 20.0
                               ).astype(np.float32)
                gain_bin = np.empty(self.F, np.float32)
                lo = 0
                for bi, top in enumerate(drc.band_top):
                    hi = min(int(top), self.F)
                    gain_bin[lo:hi] = lin[bi]
                    lo = hi
                gain_bin[lo:] = lin[-1]
                for c in range(st.config.channels):
                    if (drc.excluded is not None and c < len(drc.excluded)
                            and drc.excluded[c]):
                        continue
                    out.spec[st.base_slot + c, t] *= gain_bin

    # -- device step ---------------------------------------------------------
    def _upload_batch(self, batch: dict) -> dict:
        """Host-to-device stage: on CUDA, asynchronous copies from the pinned
        buffer on the copy stream; the compute stream waits on their event,
        and so does the next parse into the same buffer."""
        arrs = {k: v for k, v in batch.items() if not k.startswith("_")}
        facts = {k: v for k, v in batch.items() if k.startswith("_")}
        if not self._cuda:
            return {**arrs, **facts}
        with torch.cuda.stream(self._h2d_stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in arrs.items()}
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        self._h2d_done[batch["_slot"]] = ev
        self._compute_stream.wait_event(ev)
        for v in dev.values():
            v.record_stream(self._compute_stream)
        return {**dev, **facts}

    def _device_step(self, batch: dict, out_int16: bool,
                     use_pallas: bool = True):
        """Dispatch decode_spec_step for an uploaded batch on the compute
        stream; returns the PCM on the device.  The overlap and, for a batch
        with a Main-profile stream, the predictor state (made at first use)
        are replaced by the step's results.  finalize_step completes the
        timing record."""
        facts = {k: batch.pop(k) for k in list(batch) if k.startswith("_")}
        flags = P.PipelineFlags(
            has_stereo=False, has_tns=facts["_has_tns"], out_int16=out_int16,
            use_pallas=use_pallas, has_cce_post=facts["_has_cce_post"],
            has_cce_time=facts["_has_cce_time"], spec_i16=facts["_spec_i16"],
            has_pred=facts["_has_pred"], has_short=facts["_has_short"],
            eld=self._eld)
        t0 = time.perf_counter()
        done = None
        with self._on_compute():
            if flags.has_pred:
                if self._pred_state is None:
                    self._pred_state = pred.pred_state_init(self.C,
                                                            self.device)
                pcm, self.overlap, self._pred_state = P.decode_spec_step(
                    batch, self.overlap, flags, self._pred_state)
            else:
                pcm, self.overlap = P.decode_spec_step(batch, self.overlap,
                                                       flags)
            if self._cuda:
                done = torch.cuda.Event()
                done.record(self._compute_stream)
        if len(self._pending_steps) > 16:  # caller never finalized; bound it
            self._pending_steps.clear()
        self._pending_steps[id(pcm)] = (
            t0, facts["_parse_seconds"], facts["_n_stream_frames"],
            facts["_n_channel_frames"], done)
        self.stats.streams_failed = sum(st.failed for st in self.streams)
        return pcm

    def finalize_step(self, pcm) -> np.ndarray:
        """Bring a _device_step result to the host and complete its stats
        record (device_seconds spans dispatch -> PCM on the host)."""
        pending = self._pending_steps.pop(id(pcm), None)
        if self._cuda:
            host = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            if pending is not None and pending[4] is not None:
                self._d2h_stream.wait_event(pending[4])
            else:
                self._d2h_stream.wait_stream(self._compute_stream)
            with torch.cuda.stream(self._d2h_stream):
                host.copy_(pcm, non_blocking=True)
                pcm.record_stream(self._d2h_stream)
                ev = torch.cuda.Event()
                ev.record(self._d2h_stream)
            ev.synchronize()
            out = host.numpy()
        else:
            out = pcm.numpy()
        if pending is not None:
            t0, parse_seconds, n_stream_frames, n_channel_frames, _ = pending
            self.stats.add_step(parse_seconds, time.perf_counter() - t0,
                                n_stream_frames, n_channel_frames)
        return out

    def stream_pcm(self, pcm: np.ndarray, stream_idx: int,
                   n_frames: int) -> np.ndarray:
        """Interleaved [n_frames*F, channels] PCM for one stream."""
        st = self.streams[stream_idx]
        nch = st.config.channels
        block = pcm[st.base_slot:st.base_slot + nch, :n_frames, :]
        return np.ascontiguousarray(block.reshape(nch, n_frames * self.F).T)

    def step_raw(self, payloads_per_stream: list[list[bytes] | None],
                 out_int16: bool = False, materialize: bool = True,
                 compact: bool = True, use_pallas: bool = True):
        """Decode one chunk from raw_data_block payload bytes.

        Native route: one C call parses every stream, coupling elements
        included (dependent coupling is fused on the host except AFTER_TNS
        onto TNS'd targets, which rides as device entries like the
        time-domain coupling), then one device step.  Per-stream bitstream
        errors are concealed as silence and flag the stream as failed.  A
        chunk with content the native route delegates (Main + intensity,
        prediction + coupling) is redone as a whole on the python route,
        after the window-shape history and the frame counts are rolled back.

        An all-LTP batch decodes on the host engine; a decoder made with
        use_native=False takes the python route.  Both return f32 PCM
        (int16 on the LTP route when asked).

        compact=True sends block-scaled int16 spectra (half the H2D bytes);
        compact=False the exact f32 spectra.  materialize=False returns the
        device tensor for a later finalize_step.  use_pallas=False runs the
        device step as plain PyTorch."""
        if self._ltp_batch is not None:
            # the carried state lives in the engine; the decoder's own
            # overlap is unused on this route
            pcm = self._ltp_batch.step_raw(payloads_per_stream)
            for st, p in zip(self.streams, payloads_per_stream):
                st.frames_decoded += len(p or [])
            if out_int16:
                pcm = np.clip(np.round(pcm * 32768.0),
                              -32768, 32767).astype(np.int16)
            return pcm
        if not self.use_native:
            return self._step_python_raw(payloads_per_stream)
        prev_snap = self.prev_shapes.copy()
        fd_snap = [st.frames_decoded for st in self.streams]
        parsed = self._parse_native(payloads_per_stream, compact=compact)
        if any(int(c) == native.ERR_DELEGATE for c in self._last_status):
            self.prev_shapes[:] = prev_snap
            for st, fd, code in zip(self.streams, fd_snap, self._last_status):
                st.frames_decoded = fd
                if int(code) == native.ERR_DELEGATE:
                    st.failed = False
                    st.last_error = ""
            return self._step_python_raw(payloads_per_stream)
        pcm = self._device_step(self._upload_batch(parsed), out_int16,
                                use_pallas=use_pallas)
        return self.finalize_step(pcm) if materialize else pcm

    def decode_block(self, buffer_tail: bytes):
        """Streaming route: natively parse and decode one raw_data_block
        from the head of `buffer_tail` (which may hold many more; the parser
        stops at the block's END element).  For a single stream with
        chunk_frames=1.  Returns (pcm [C,1,F] float32 in the 1/32768 scale,
        consumed bits), or None when the native parser did not decode a
        complete block: the caller reruns the python parser, which tells a
        wait for more data from an error."""
        if (not self.use_native or len(self.streams) != 1 or self.T != 1
                or not buffer_tail):
            return None
        st = self.streams[0]
        snap = (st.failed, st.last_error, st.frames_decoded)
        parsed = self._parse_native([[buffer_tail]], compact=False)
        if int(self._last_status[0]) != 0:
            st.failed, st.last_error, st.frames_decoded = snap
            return None
        consumed = int(self._last_consumed[0])
        pcm = self.finalize_step(
            self._device_step(self._upload_batch(parsed), out_int16=False))
        return pcm, consumed

    def decode_pipelined(self, chunk_iter, out_int16: bool = True,
                         compact: bool = True):
        """Generator decoding an iterator of payload chunks on the native
        route as a 3-stage pipeline over two parse buffers:

            main thread    : native parse of chunk k (releases the GIL)
            upload worker  : H2D copy + dispatch of chunk k-1
            download worker: D2H of chunk k-2

        so the steady-state wall per chunk is the slowest stage, not the
        sum.  On CUDA the copies in both directions run on their own
        streams, concurrently with the compute stream; the overlap and the
        predictor state advance on the upload worker only, in chunk order,
        on the compute stream.  A reset asked for through request_reset
        while this runs applies at the next chunk boundary, after the step
        in flight has been dispatched.  Yields host PCM arrays [C, T, F] in
        chunk order."""
        up_pool = concurrent.futures.ThreadPoolExecutor(1)
        down_pool = concurrent.futures.ThreadPoolExecutor(1)
        up_fut = down_fut = None
        slot = 0

        def upload_dispatch(batch):
            return self._device_step(self._upload_batch(batch), out_int16)

        try:
            self._pipeline_active = True
            for chunk in chunk_iter:
                if self._deferred_resets:
                    # a reset touches state the upload worker replaces
                    # (overlap, predictor state) and the parser's shape
                    # history: let the step in flight be dispatched first;
                    # the reset's device work then follows it on the
                    # compute stream
                    if up_fut is not None:
                        pcm_dev = up_fut.result()
                        up_fut = None
                        if down_fut is not None:
                            yield down_fut.result()
                        down_fut = down_pool.submit(self.finalize_step,
                                                    pcm_dev)
                    self._apply_deferred_resets()
                parsed = self._parse_native(chunk, buf_slot=slot,
                                            compact=compact)
                if up_fut is not None:
                    pcm_dev = up_fut.result()
                    if down_fut is not None:
                        yield down_fut.result()
                    down_fut = down_pool.submit(self.finalize_step, pcm_dev)
                up_fut = up_pool.submit(upload_dispatch, parsed)
                slot ^= 1
            if up_fut is not None:
                pcm_dev = up_fut.result()
                if down_fut is not None:
                    yield down_fut.result()
                down_fut = down_pool.submit(self.finalize_step, pcm_dev)
            if down_fut is not None:
                yield down_fut.result()
        finally:
            self._pipeline_active = False
            up_pool.shutdown(wait=True)
            down_pool.shutdown(wait=True)
            self._apply_deferred_resets()

    # -- stream reset --------------------------------------------------------
    def request_reset(self, idx: int, config: StreamConfig | None = None
                      ) -> None:
        """Recycle a stream's slots safely while serving: with a
        decode_pipelined generator running, the reset waits for the next
        chunk boundary; otherwise it applies at once."""
        if self._pipeline_active:
            self._deferred_resets.append((idx, config))
        else:
            self.reset_stream(idx, config)

    def _apply_deferred_resets(self) -> None:
        pending, self._deferred_resets = self._deferred_resets, []
        was_active, self._pipeline_active = self._pipeline_active, False
        try:
            for idx, config in pending:
                self.reset_stream(idx, config)
        finally:
            self._pipeline_active = was_active

    def reset_stream(self, idx: int, config: StreamConfig | None = None
                     ) -> None:
        """Recycle one stream's slots for a new client without touching the
        other streams: zeroes its decoder state (overlap, window-shape
        history, predictor rows) and clears the failure flag.  An optional
        new config swaps the stream's tables in place; it must keep the
        batch's frame length and ELD-ness and fit the stream's slots.

        Raises while a decode_pipelined generator has a chunk in flight:
        request_reset defers to the next chunk boundary."""
        if self._pipeline_active:
            raise RuntimeError(
                "reset_stream during a pipelined decode would race the "
                "in-flight chunk's state; use request_reset(idx, config) "
                "— it applies at the next chunk boundary")
        st = self.streams[idx]
        if config is not None:
            if config.frame_length != self.F:
                raise ValueError(
                    f"frame length {config.frame_length} != batch {self.F}")
            if (config.profile == ELD_PROFILE) != self._eld:
                raise ValueError("cannot swap ELD-ness of a batch slot")
            if config.channels > st.n_slots:
                raise ValueError(
                    f"config needs {config.channels} channels; stream has "
                    f"{st.n_slots} slots")
            st.config = config
            self._sample_indices[idx] = config.sample_index
            self._chan_configs[idx] = config.chan_config
            if self._tables_pack is not None:
                row = native.stream_tables([config])
                for k in ("profiles", "swb_long", "swb_long_count",
                          "swb_short", "swb_short_count", "tns_max",
                          "pred_sfb"):
                    self._tables_pack[k][idx] = row[k][0]
        st.failed = False
        st.last_error = ""
        st.frames_decoded = 0
        lo, hi = st.base_slot, st.base_slot + st.n_slots
        self.prev_shapes[lo:hi] = 0
        with self._on_compute():
            self.overlap[lo:hi] = 0.0
            if self._pred_state is not None:
                self._pred_state[lo:hi] = pred.pred_state_init(
                    st.n_slots, self.device)

    # -- state save/restore --------------------------------------------------
    def save_state(self) -> dict:
        """The decoder state at a chunk boundary, as numpy: overlap [C,F]
        ([C,3F] for ELD), prev_shapes [C], frames_decoded per stream, and
        pred_state [C,672,6] once a Main-profile chunk has run: the format
        of aacjax's BatchDecoder.save_state for a batch without SBR."""
        if self._pipeline_active:
            raise RuntimeError("save_state with a pipelined chunk in "
                               "flight; drain the generator first")
        self._sync_compute()
        out = {
            "overlap": self.overlap.cpu().numpy().copy(),
            "prev_shapes": self.prev_shapes.copy(),
            "frames_decoded": [st.frames_decoded for st in self.streams],
        }
        if self._pred_state is not None:
            out["pred_state"] = self._pred_state.cpu().numpy().copy()
        return out

    def restore_state(self, state: dict) -> None:
        """Inverse of save_state; also takes the dict aacjax's
        BatchDecoder.save_state returns for a batch of the same layout that
        has decoded no HE-AAC."""
        if "sbr" in state:
            raise NotImplementedError(
                "state key 'sbr': the SBR/PS state is not ported yet "
                "(ROADMAP Queue 1 items 8 and 9)")
        self._sync_compute()
        self._set_overlap(np.asarray(state["overlap"]))
        self.prev_shapes[:] = state["prev_shapes"]    # in place: keeps views
        for st, n in zip(self.streams, state["frames_decoded"]):
            st.frames_decoded = n
        if "pred_state" in state:
            ps = torch.from_numpy(np.array(state["pred_state"], np.float32))
            if ps.shape != (self.C, P.PRED_BINS, 6):
                raise ValueError(f"pred_state shape {tuple(ps.shape)}, "
                                 f"expected {(self.C, P.PRED_BINS, 6)}")
            with self._on_compute():
                self._pred_state = ps.to(self.device)
