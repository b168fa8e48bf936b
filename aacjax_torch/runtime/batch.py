"""Batched multi-stream AAC-LC decode runtime on one device.

Counterpart of the native LC subset of `aacjax/runtime/batch.py`
`BatchDecoder`.  It owns the per-stream decoder state (the per-channel
1024-sample overlap, kept on the device between chunks, and the
per-channel previous window shape used by the parser) and drives
native parse -> host-to-device copy -> `decode_spec_step` -> int16 or f32
PCM back to the host.

On CUDA the host buffers the native parser writes into are pinned, the
copies to the device run on their own stream, the decode step on a
compute stream and the copies back on a third, ordered by CUDA events.
"""
from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass

import numpy as np
import torch

from aacjax_torch.host import native
from aacjax_torch.host.asc import StreamConfig
from aacjax_torch.host.bitio import BitReader
from aacjax_torch.runtime.stats import DecodeStats
from aacjax_torch.kernels import pipeline as P

FRAME = 1024
LC_PROFILE = 2
# SpecBatchArrays fields that travel to the device: name -> (dtype, trailing dims)
_H2D_FIELDS = {
    "spec": (torch.float32, (FRAME,)),
    "spec_i16": (torch.int16, (FRAME,)),
    "spec_scale": (torch.float32, (FRAME // native.I16_BLOCK,)),
    "meta": (torch.int32, (6,)),
    "tns_lpc": (torch.float32, (2, native.TNS_SLOTS, native.TNS_ORDER)),
    "tns_range": (torch.int32, (2, native.TNS_SLOTS, 2)),
}


@dataclass
class StreamState:
    """Host-side per-stream state (the overlap lives in BatchDecoder.overlap)."""
    config: StreamConfig
    base_slot: int
    n_slots: int               # channels + cce_slots
    frames_decoded: int = 0
    failed: bool = False
    last_error: str = ""


class BatchDecoder:
    """Decodes T-frame chunks for a fixed set of concurrent AAC-LC streams
    on `device` ("cuda" by default; "cpu" runs the kernels' plain
    versions).  Only the native-parser path is ported."""

    def __init__(self, configs: list[StreamConfig], chunk_frames: int = 16,
                 cce_slots: int = 0, use_native: bool | None = None,
                 drc_scale: float = 0.0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        for cfg in configs:
            if cfg.profile != LC_PROFILE or cfg.frame_length != FRAME:
                raise NotImplementedError(
                    f"profile {cfg.profile} / frame length "
                    f"{cfg.frame_length}: only AAC-LC with 1024-sample frames "
                    "is ported (ROADMAP Queue 1 items 4 and 6)")
        if use_native is False or not native.available():
            raise NotImplementedError(
                "only the native-parser path is ported; the python packer "
                "path is ROADMAP Queue 1 item 7 (build native/ with make)")
        self.T = chunk_frames
        self.F = FRAME
        self.drc_scale = drc_scale
        self.streams: list[StreamState] = []
        c = 0
        for cfg in configs:
            n = cfg.channels + cce_slots
            self.streams.append(StreamState(cfg, base_slot=c, n_slots=n))
            c += n
        self.C = c
        self.prev_shapes = np.zeros(c, np.int32)   # per channel slot
        self._sample_indices = np.array(
            [st.config.sample_index for st in self.streams], np.int32)
        self._chan_configs = np.array(
            [st.config.chan_config for st in self.streams], np.int32)
        self._base_slots = np.array(
            [st.base_slot for st in self.streams], np.int32)
        self._n_slots = np.array([st.n_slots for st in self.streams], np.int32)
        self._tables_pack = native.stream_tables(configs)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
        self._set_overlap(np.zeros((c, self.F), np.float32))
        # two parse buffers (double-buffered pipeline) and, per buffer, the
        # event after which its last host-to-device copy has landed
        self._buffers = [self._alloc_buffer(), self._alloc_buffer()]
        self._h2d_done: list[torch.cuda.Event | None] = [None, None]
        self._pending_steps: dict[int, tuple] = {}
        self._pipeline_active = False
        self._last_status = np.zeros(len(self.streams), np.int32)
        self.stats = DecodeStats(
            sample_rate=configs[0].sample_rate if configs else 44100)

    # -- buffers and state ---------------------------------------------------
    def _alloc_buffer(self) -> tuple[native.SpecBatchArrays, dict]:
        """Parser output arrays whose device-bound fields are numpy views of
        torch tensors (pinned on CUDA): the native parser and compact_spec
        write straight into memory the copy engine can read."""
        arrays = native.SpecBatchArrays(self.C, self.T, self.F)
        host = {}
        for name, (dtype, dims) in _H2D_FIELDS.items():
            t = torch.zeros((self.C, self.T) + dims, dtype=dtype,
                            pin_memory=self._cuda)
            host[name] = t
            setattr(arrays, name, t.numpy())
        return arrays, host

    def _set_overlap(self, overlap: np.ndarray) -> None:
        ov = torch.from_numpy(np.array(overlap, np.float32))   # a copy
        if ov.shape != (self.C, self.F):
            raise ValueError(f"overlap shape {tuple(ov.shape)}, expected "
                             f"{(self.C, self.F)}")
        if self._cuda:
            with torch.cuda.stream(self._compute_stream):
                self.overlap = ov.to(self.device)
        else:
            self.overlap = ov

    def _sync_compute(self) -> None:
        if self._cuda:
            self._compute_stream.synchronize()

    # -- host parse ----------------------------------------------------------
    def _parse_native(self, payloads_per_stream, buf_slot: int = 0,
                      compact: bool = True) -> dict:
        """One native C call parses every stream's chunk into buffer
        `buf_slot`.  Returns a batch of host tensors plus '_'-prefixed
        host-side facts."""
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
            tables_pack=self._tables_pack)
        self._last_status = status
        if self.drc_scale > 0 and arrays.fil_drc.any():
            self._apply_native_drc(payloads_per_stream, arrays)
        for i, st in enumerate(self.streams):
            code = int(status[i])
            if code == native.ERR_FALLBACK:
                st.failed = True
                st.last_error = (f"native parse: {errmsg or 'capacity'}; "
                                 "raise cce_slots to cover coupling channels")
            elif code == native.ERR_DELEGATE:
                st.failed = True
                st.last_error = f"native parse delegates: {errmsg}"
            elif code != 0:
                st.failed = True
                st.last_error = errmsg or f"native parse error code {code}"
                st.frames_decoded += len(payloads_per_stream[i] or [])
            elif payloads_per_stream[i]:
                st.frames_decoded += len(payloads_per_stream[i])
        if int(arrays.cce_counts[0]) or int(arrays.cce_counts[1]):
            raise NotImplementedError(
                "coupling-channel entries (AFTER_TNS / AFTER_IMDCT) are not "
                "ported yet (ROADMAP Queue 1 item 6)")
        if compact:
            native.compact_spec(arrays)   # writes into the host tensors
            keys = ["spec_i16", "spec_scale", "meta"]
        else:
            keys = ["spec", "meta"]
        if has_tns:
            keys += ["tns_lpc", "tns_range"]
        batch = {k: host[k] for k in keys}
        meta = arrays.meta
        batch.update(
            _slot=buf_slot, _has_tns=has_tns,
            _has_short=bool(meta[:, :, 4].any()), _spec_i16=compact,
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

    def _device_step(self, batch: dict, out_int16: bool):
        """Dispatch decode_spec_step for an uploaded batch; returns the PCM
        on the device.  finalize_step completes the timing record."""
        facts = {k: batch.pop(k) for k in list(batch) if k.startswith("_")}
        flags = P.PipelineFlags(
            has_stereo=False, has_tns=facts["_has_tns"], out_int16=out_int16,
            use_pallas=True, spec_i16=facts["_spec_i16"],
            has_short=facts["_has_short"])
        t0 = time.perf_counter()
        done = None
        if self._cuda:
            with torch.cuda.stream(self._compute_stream):
                pcm, self.overlap = P.decode_spec_step(batch, self.overlap,
                                                       flags)
                done = torch.cuda.Event()
                done.record(self._compute_stream)
        else:
            pcm, self.overlap = P.decode_spec_step(batch, self.overlap, flags)
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
        """Interleaved [n_frames*1024, channels] PCM for one stream."""
        st = self.streams[stream_idx]
        nch = st.config.channels
        block = pcm[st.base_slot:st.base_slot + nch, :n_frames, :]
        return np.ascontiguousarray(block.reshape(nch, n_frames * self.F).T)

    def step_raw(self, payloads_per_stream: list[list[bytes] | None],
                 out_int16: bool = False, materialize: bool = True,
                 compact: bool = True):
        """Decode one chunk from raw_data_block payload bytes: one native
        parse of every stream, then one device step.  Per-stream bitstream
        errors are concealed as silence and flag the stream as failed.
        compact=True sends block-scaled int16 spectra (half the H2D bytes);
        compact=False the exact f32 spectra.  materialize=False returns the
        device tensor for a later finalize_step."""
        parsed = self._parse_native(payloads_per_stream, compact=compact)
        if any(int(c) == native.ERR_DELEGATE for c in self._last_status):
            raise NotImplementedError(
                "the native parser delegates this content to the python "
                "packer path (ROADMAP Queue 1 item 7)")
        pcm = self._device_step(self._upload_batch(parsed), out_int16)
        return self.finalize_step(pcm) if materialize else pcm

    def decode_pipelined(self, chunk_iter, out_int16: bool = True,
                         compact: bool = True):
        """Generator decoding an iterator of payload chunks as a 3-stage
        pipeline over two parse buffers:

            main thread    : native parse of chunk k (releases the GIL)
            upload worker  : H2D copy + dispatch of chunk k-1
            download worker: D2H of chunk k-2

        so the steady-state wall per chunk is the slowest stage, not the
        sum.  On CUDA the copies in both directions run on their own
        streams, concurrently with the compute stream.  Yields host PCM
        arrays [C, T, 1024] in chunk order."""
        up_pool = concurrent.futures.ThreadPoolExecutor(1)
        down_pool = concurrent.futures.ThreadPoolExecutor(1)
        up_fut = down_fut = None
        slot = 0

        def upload_dispatch(batch):
            return self._device_step(self._upload_batch(batch), out_int16)

        try:
            self._pipeline_active = True
            for chunk in chunk_iter:
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

    # -- state save/restore --------------------------------------------------
    def save_state(self) -> dict:
        """The core decoder state at a chunk boundary, as numpy: overlap
        [C,1024], prev_shapes [C], frames_decoded per stream -- the format
        of aacjax's BatchDecoder.save_state for an LC batch."""
        if self._pipeline_active:
            raise RuntimeError("save_state with a pipelined chunk in "
                               "flight; drain the generator first")
        self._sync_compute()
        return {
            "overlap": self.overlap.cpu().numpy().copy(),
            "prev_shapes": self.prev_shapes.copy(),
            "frames_decoded": [st.frames_decoded for st in self.streams],
        }

    def restore_state(self, state: dict) -> None:
        """Inverse of save_state; also takes the dict aacjax's
        BatchDecoder.save_state returns for an LC batch (core keys)."""
        extra = set(state) - {"overlap", "prev_shapes", "frames_decoded"}
        if extra:
            raise NotImplementedError(
                f"state keys {sorted(extra)}: only the LC core state is "
                "ported (ROADMAP Queue 1 items 6 and 8)")
        self._sync_compute()
        self._set_overlap(np.asarray(state["overlap"]))
        self.prev_shapes[:] = state["prev_shapes"]
        for st, n in zip(self.streams, state["frames_decoded"]):
            st.frames_decoded = n
