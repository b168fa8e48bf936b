"""Batched multi-stream AAC decode runtime on one device.

Counterpart of `aacjax/runtime/batch.py` `BatchDecoder`: AAC-LC, Main, LTP,
ER-LC, LD and ELD streams at 1024, 960, 512 or 480 samples a frame, with
coupling channels, HE-AAC v1 (SBR) and HE-AAC v2 (SBR + Parametric Stereo).
It owns the per-stream decoder state (the per-channel overlap, [C, F] or
[C, 3F] for ELD, the Main-profile predictor state [C, 672, 6], the SBR
filterbank FIFOs and the PS decorrelator and synthesis state, all kept on
the device between chunks, and the per-channel previous window shape and
SBR / PS sequential state used by the host) and drives host parse ->
host-to-device copy -> device step -> int16 or f32 PCM back to the host.

Three parse routes, as in the reference: the native parser (one C call per
chunk, then `decode_spec_step`); the python parser and packer
(`runtime/pack.py`, then `decode_step`), which the native route hands a
chunk to when a stream carries content it delegates; and, for a batch of
AAC-LTP streams only, the vectorised float64 engine on the host
(`host/ltp_batch.py`).

On CUDA the host buffers the native parser writes into are pinned, the
copies to the device run on their own stream, the decode step on a
compute stream and the copies back on a third, ordered by CUDA events.
The overlap, the predictor state and the SBR state are read and written
only on the compute stream, so consecutive chunks need no event between
them.  The device programs (the decode steps, the SBR and SBR + PS
programs) run compiled, as the reference's jitted programs run: a CUDA
graph per key, captured at a key's first chunk and replayed after
(runtime/graphs.py).  A replay copies its inputs in and its outputs and the
new state out on the compute stream, so chunk n + 1's upload lands in the
decoder's own tensors while chunk n replays, and the state that reset_stream,
restore_state or a mesh's re-split writes between chunks is what the next
replay reads.

HE-AAC (`step_he_raw`, `decode_he_pipelined`): the native parser decodes
the core and records where each frame's SBR extension sits; Python parses
those ~30-byte extensions (cached by payload), the host packs the dense
per-slot planes (host/sbr_pack.py), the core step runs on the card, and
then one batched SBR program (kernels/sbr_batch.py) runs on the
device-resident core PCM.  A mono stream whose SBR extensions carry
ps_data (HE-AAC v2) needs one spare slot (cce_slots >= 1): its SBR planes
go on through the Parametric Stereo program (kernels/ps_batch.py, packed
by host/ps_pack.py), which writes the left channel to the stream's slot and
the right one to the spare.  A slot whose SBR header changes mid-chunk, or
whose PS band scheme flips with state carried, replays that chunk on the
float64 per-channel path (host/sbr_decode.py, host/ps_decode.py) and
rejoins the batched path at the next chunk boundary.

Several devices (`mesh=` on decode_pipelined, step_he_raw and
decode_he_pipelined; runtime/mesh.py): each stream shard's slice of the
pinned parse buffers lands on its own devices, on their copy streams, the
shards' steps run on their devices' compute streams, and each shard's PCM
comes back into its rows of the pinned output.  A call without a mesh runs
the same code on a one-shard mesh of self.device.  The carried state lives
as row blocks on the stream shards' first devices; a call with another
mesh gathers and re-splits it, and stream resets write into the blocks in
place, so a decoder stays one decoder whatever meshes its calls use.

Measurement (runtime/stats.py): `stats` keeps running totals; setting
`trace` to a `Trace()` records spans at the serving layers' boundaries
(`parse` with `parse.wait_h2d`, `parse.native`, and `parse.compact`
only where a DRC fold sends the compact spectra through a pass of their
own, counted `compact_separate` against `compact_fused`;
`he_host` with `he.begin`, the core `parse`, `he.sbr`, `he.stage`;
`wait.upload` / `wait.download` on the main thread; `upload_dispatch`, or
`core_step`, `sbr_upload` and `sbr_dispatch`, on the upload worker;
`download` with `download.replay` on the download worker) and the SBR
loop's counters (`sbr_parse_ns`, `sbr_pack_ns`, `sbr_payloads`,
`sbr_cache_lookups`, `_hits`, `_inserts`), each under its chunk id.  A
call given a mesh also records the mesh's fan-out on the upload worker:
`mesh.h2d` a shard on CUDA (the shard's copies up issued) and
`mesh.dispatch` (every stream shard's step issued).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from aacjax_torch.host import native
from aacjax_torch.host import ps_pack as PP
from aacjax_torch.host import sbr as sbrmod
from aacjax_torch.host import sbr_decode as SD
from aacjax_torch.host import sbr_pack as SP
from aacjax_torch.host.asc import StreamConfig
from aacjax_torch.host.bitio import BitReader
from aacjax_torch.host.syntax import CPEData, Frame, SCEData, decode_frame
from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import pred
from aacjax_torch.kernels import ps_batch as PB
from aacjax_torch.kernels import sbr_batch as SB
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.runtime.pack import SlotOverflowError, pack_frames
from aacjax_torch.runtime.stats import DecodeStats, Trace

FRAME = 1024
NATIVE_FRAME_LENGTHS = (1024, 960, 512, 480)
MAIN_PROFILE, LTP_PROFILE, ELD_PROFILE = 1, 4, 39
# the native parse's counts, in its parse_counts order (traced only): the
# bands by path, then the pool's workers that took streams and its tail
PARSE_COUNTERS = ("parse_fused_bands", "parse_general_bands",
                  "parse_gain_table_misses", "parse_workers",
                  "parse_tail_ns")


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


def _qsf_fields(F: int) -> dict:
    """The exact-i16 q/sf spectra of the HE core (native ensure_qsf)."""
    return {"spec_q": (torch.int16, (F,)),
            "spec_sf": (torch.uint8, (F // 4,))}


# sbr_pack.compact_dense's planes with leading [C, T]: name -> (dtype,
# trailing dims)
_SBR_COMPACT_FIELDS = {
    "eq_l2": (torch.int16, (2, SB.MAX_ENV, SB.BANDS)),
    "eq_off": (torch.float32, (2,)),
    "sbits": (torch.int8, (SB.MAX_ENV, SB.BANDS)),
    "dtbits": (torch.int8, (SB.MAX_ENV,)),
    "covered": (torch.int8, (SB.YSLOTS,)),
    "has_sbr": (torch.int8, ()),
    "env_id": (torch.int8, (SB.YSLOTS,)),
    "sine_idx": (torch.int8, (SB.YSLOTS,)),
    "noise_base": (torch.int16, (SB.YSLOTS,)),
    "bw": (torch.float32, (SB.BANDS,)),
    "i_temp": (torch.int32, ()),
}
# the per-slot device state a sticky slot's float64 replay inherits
_SEED_KEYS = ("x_hist", "v_hist", "xlow_r", "xlow_i", "ytail_r", "ytail_i")
_PS_SEED_KEYS = ("v_l", "v_r", "delay_r", "delay_i", "ap_r", "ap_i", "peak",
                 "psmooth", "pdiff", "hist4_r", "hist4_i")
# ps_pack's planes as they travel: name -> (dtype, trailing dims) after a
# leading [C, T] ("chunk") or [C] ("slot"); the indices fit the narrow types
# (HA rows -1..45, ICC 0..7, phase indices 0..511, knots 0..5)
_PS_FIELDS = {
    "ps_ha": (torch.int8, (6, 34), "chunk"),
    "ps_icc": (torch.int8, (6, 34), "chunk"),
    "ps_opd": (torch.int16, (6, 17), "chunk"),
    "ps_ipd": (torch.int16, (6, 17), "chunk"),
    "ps_h0_r": (torch.float32, (34, 4), "chunk"),
    "ps_h0_i": (torch.float32, (34, 4), "chunk"),
    "ps_hslot": (torch.int8, (6,), "chunk"),
    "ps_knot_lo": (torch.int8, (32,), "chunk"),
    "ps_knot_hi": (torch.int8, (32,), "chunk"),
    "ps_alpha": (torch.float32, (32,), "chunk"),
    "ps_has": (torch.float32, (), "chunk"),
    "ps_himag": (torch.float32, (4, 34, 4), "slot"),
    "out_src": (torch.int32, (), "slot"),
    "out_role": (torch.int32, (), "slot"),
    "slot_is34": (torch.float32, (), "slot"),
}


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
        self.device = _build.indexed(self.device)
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
        # per device the (copy up, compute, copy down) CUDA streams
        self._dev_streams: dict = {}
        if self._cuda:
            (self._h2d_stream, self._compute_stream,
             self._d2h_stream) = self._streams(self.device)
        self._layouts: dict = {}
        # a call without a mesh runs on this one-shard mesh
        self._home = meshlib.Mesh([[self.device]])
        self._ov_width = 3 * self.F if self._eld else self.F
        self._set_overlap(np.zeros((c, self._ov_width), np.float32))
        self._pred_state: torch.Tensor | None = None
        # two parse buffers (double-buffered pipeline) for the native route,
        # made here so that no decode pays for pinning them; and per buffer
        # the event after which its last host-to-device copy has landed
        self._buffers = ([self._alloc_buffer(), self._alloc_buffer()]
                         if self.use_native else None)
        self._h2d_done: list[torch.cuda.Event | None] = [None, None]
        # HE-AAC: the pinned q/sf spectra and SBR-plane buffers (two slots,
        # like the parse buffers), made here when a stream may carry SBR
        # (its core rate is at most 24 kHz, or the ASC says so), else at the
        # first HE chunk; and per slot the event after which the last copy
        # of its SBR planes has landed
        self._sbr_bufs: list[dict] | None = None
        self._sbr_h2d_done: list[torch.cuda.Event | None] = [None, None]
        if self.use_native and any(cfg.sbr or cfg.sample_rate <= 24000
                                   for cfg in configs):
            self._he_buffers()
        # the same for the Parametric Stereo planes, made here when a mono
        # stream has the spare slot that PS needs
        self._ps_bufs: list[dict] | None = None
        self._ps_h2d_done: list[torch.cuda.Event | None] = [None, None]
        if self._sbr_bufs is not None and cce_slots >= 1 and any(
                cfg.channels == 1 for cfg in configs):
            self._ps_buffers()
        # each dispatched step's stats record, by chunk id, until
        # finalize_step completes it (direct calls: the latest, under None)
        self._pending_steps: dict[int | None, tuple] = {}
        # a reset asked for while a pipelined generator runs waits for the
        # next chunk boundary (request_reset)
        self._pipeline_active = False
        self._deferred_resets: list[tuple[int, StreamConfig | None]] = []
        self._last_status = np.zeros(len(self.streams), np.int32)
        self._last_consumed = np.zeros(1, np.int64)
        self.stats = DecodeStats(
            sample_rate=configs[0].sample_rate if configs else 44100)
        self.trace: Trace | None = None

    # -- carried state, whole or in row blocks -------------------------------
    # Each carried state is whole on self.device or meshlib.RowBlocks on the
    # stream shards' first devices of the mesh the last call ran on (a call
    # without a mesh runs on self._home, one block on self.device).  Reading
    # it through these properties gathers it whole; a step takes it through
    # _sharded.
    @property
    def overlap(self) -> torch.Tensor:
        """The carried overlap [C, F] ([C, 3F] for ELD) on self.device."""
        self._ov = self._whole(self._ov)
        return self._ov

    @overlap.setter
    def overlap(self, value) -> None:
        self._ov = value

    @property
    def _pred_state(self):
        self._pred = self._whole(self._pred)
        return self._pred

    @_pred_state.setter
    def _pred_state(self, value) -> None:
        self._pred = value

    @property
    def _sbr_dev_state(self) -> dict:
        self._sbr_dev = self._whole(self._sbr_dev)
        return self._sbr_dev

    @_sbr_dev_state.setter
    def _sbr_dev_state(self, value) -> None:
        self._sbr_dev = value

    @property
    def _ps_dev_states(self) -> dict:
        self._ps_dev = {m: self._whole(v) for m, v in self._ps_dev.items()}
        return self._ps_dev

    @_ps_dev_states.setter
    def _ps_dev_states(self, value) -> None:
        self._ps_dev = value

    def _whole(self, x):
        """x whole on self.device (row blocks gathered after their devices'
        compute streams drained; a single block on self.device is the whole
        as it stands)."""
        if not isinstance(x, meshlib.RowBlocks):
            return x
        if x.devices == (self.device,):
            return meshlib.gather(x, self.device)
        self._sync_compute()
        with self._on_devices(x.devices):
            return meshlib.gather(x, self.device)

    def _sharded(self, x, mesh: meshlib.Mesh, rows: tuple):
        """x (whole or row blocks) as row blocks over `rows` on the mesh's
        stream shards, re-split when its blocks differ."""
        if x is None or (isinstance(x, meshlib.RowBlocks)
                         and x.matches(rows, mesh.row_devices)):
            return x
        x = self._whole(x)
        with self._on_mesh(mesh):
            return meshlib.scatter(x, rows, mesh.row_devices)

    def _mesh(self, mesh) -> meshlib.Mesh:
        """The mesh a call runs on (self._home for None); an uneven split
        raises here."""
        mesh = self._home if mesh is None else mesh
        self._layout(mesh)
        return mesh

    def _layout(self, mesh: meshlib.Mesh) -> meshlib.Layout:
        """How this decoder's chunks split over `mesh` (whole streams a
        stream shard; ELD reads three frames back)."""
        lay = self._layouts.get(mesh)
        if lay is None:
            kinds = {d.type for d in mesh.device_set}
            if kinds != {self.device.type}:
                raise ValueError(f"mesh on {sorted(kinds)} for a decoder on "
                                 f"{self.device.type}")
            lay = self._layouts[mesh] = meshlib.layout(
                mesh, [st.n_slots for st in self.streams], self.T,
                halo=3 if self._eld else 1)
        return lay

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

    def _pinned(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)

    def _he_buffers(self) -> None:
        """Bind the q/sf spectra into both parse buffers and make the two
        slots of SBR-plane buffers (once)."""
        if self._sbr_bufs is not None:
            return
        for arrays, host in self._buffers or ():
            for name, (dtype, dims) in _qsf_fields(self.F).items():
                host[name] = self._pinned((self.C, self.T) + dims, dtype)
                setattr(arrays, name, host[name].numpy())
        self._sbr_bufs = [
            {name: self._pinned((self.C, self.T) + dims, dtype)
             for name, (dtype, dims) in _SBR_COMPACT_FIELDS.items()}
            for _ in range(2)]

    def _ps_buffers(self) -> None:
        """Make the two slots of pinned PS-plane buffers (once)."""
        if self._ps_bufs is not None or not self._cuda:
            return
        lead = {"chunk": (self.C, self.T), "slot": (self.C,)}
        self._ps_bufs = [
            {name: self._pinned(lead[kind] + dims, dtype)
             for name, (dtype, dims, kind) in _PS_FIELDS.items()}
            for _ in range(2)]

    def _streams(self, dev: torch.device) -> tuple:
        """The (copy up, compute, copy down) CUDA streams of `dev`."""
        s = self._dev_streams.get(dev)
        if s is None:
            s = self._dev_streams[dev] = tuple(torch.cuda.Stream(dev)
                                               for _ in range(3))
        return s

    def _on_compute(self):
        """Context in which device work joins the compute stream."""
        if self._cuda:
            return torch.cuda.stream(self._compute_stream)
        return contextlib.nullcontext()

    def _on_devices(self, devices):
        """Context in which each of `devices` (and self.device) has its
        compute stream current: work on any of them, and the copies
        between them, join those streams in order."""
        stack = contextlib.ExitStack()
        if self._cuda:
            for dev in dict.fromkeys((self.device, *devices)):
                stack.enter_context(torch.cuda.stream(self._streams(dev)[1]))
        return stack

    def _on_mesh(self, mesh: meshlib.Mesh):
        return self._on_devices(mesh.device_set)

    def _record_done(self, devices) -> dict:
        """Per device an event on its compute stream (none on the CPU)."""
        if not self._cuda:
            return {}
        done = {}
        for dev in dict.fromkeys(devices):
            done[dev] = torch.cuda.Event()
            done[dev].record(self._streams(dev)[1])
        return done

    def _traces_mesh(self, mesh: meshlib.Mesh) -> bool:
        """Whether a call on `mesh` records the mesh's spans: tracing, and a
        mesh given (not self._home)."""
        return self.trace is not None and mesh is not self._home

    def _set_overlap(self, overlap: np.ndarray) -> None:
        ov = torch.from_numpy(np.array(overlap, np.float32))   # a copy
        if ov.shape != (self.C, self._ov_width):
            raise ValueError(f"overlap shape {tuple(ov.shape)}, expected "
                             f"{(self.C, self._ov_width)}")
        with self._on_compute():
            self.overlap = ov.to(self.device)

    def _sync_compute(self) -> None:
        for _, compute, _ in self._dev_streams.values():
            compute.synchronize()

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
        pcm = self._packed_step(batch, flags, self._home)
        with self._on_compute():
            return meshlib.gather(pcm, self.device).cpu().numpy()

    def _packed_step(self, batch: dict, flags: P.PipelineFlags,
                     mesh: meshlib.Mesh) -> meshlib.RowBlocks:
        """The python packer's numpy batch through decode_step over `mesh`
        (meshlib.shard_batch): the PCM as row blocks."""
        flags = dataclasses.replace(flags, use_pallas=True)
        lay = self._layout(mesh)
        with self._on_mesh(mesh):
            shards = meshlib.shard_batch(mesh, batch, lay)
        return self._run_step(meshlib.sharded_decode_step(flags, mesh),
                              shards, flags, mesh)

    def _run_step(self, step, shards: meshlib.Shards, flags: P.PipelineFlags,
                  mesh: meshlib.Mesh) -> meshlib.RowBlocks:
        """One sharded decode step on every shard's compute stream: the
        overlap and, with flags.has_pred, the predictor state (made per
        shard at first use) go in as row blocks on the stream shards and are
        replaced by the step's.  Returns the PCM as row blocks."""
        rows = shards.layout.rows
        ov = self._sharded(self._ov, mesh, rows)
        with self._on_mesh(mesh):
            if not flags.has_pred:
                pcm, self._ov = step(shards, ov)
                return pcm
            if self._pred is None:
                self._pred = meshlib.RowBlocks(
                    [pred.pred_state_init(hi - lo, dev) for (lo, hi), dev
                     in zip(rows, mesh.row_devices)], rows, mesh.row_devices)
            state = self._sharded(self._pred, mesh, rows)
            pcm, self._ov, self._pred = step(shards, ov, state)
            return pcm

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
                      compact: bool = True, qsf: bool = False,
                      chunk_id: int | None = None) -> dict:
        """One native C call parses every stream's chunk into buffer
        `buf_slot`.  Returns a batch of host tensors plus '_'-prefixed
        host-side facts (`_chunk_id` among them: the serving entry's number
        for the chunk, None for a direct call).  A batch with a Main-profile
        stream ships exact f32 spectra whatever `compact` says: the
        predictor's state feeds back across frames and is sensitive to the
        last bit.

        qsf=True (the HE core) asks for the exact-i16 q/sf spectra (raw
        quantized coefficients and a scalefactor byte per 4 bins,
        dequantized on the device bit for bit); they travel only when every
        stream of the chunk could take them (native qsf_ok: no PNS,
        intensity, M/S, coupling or escape > 8191) and no DRC gain applies,
        else the exact f32 spectra do.  The SBR FIL records land in
        _last_fil_sbr.

        compact=True has the parse threads write the block-scaled int16
        spectra as they go; a chunk whose DRC gains are folded into the f32
        spectra after the parse converts them again in a pass of its own.

        When tracing, the parse's counts are counters of the chunk:
        parse_fused_bands, parse_general_bands, parse_gain_table_misses,
        parse_workers, parse_tail_ns."""
        t0 = time.perf_counter_ns()
        if self._any_main:
            compact = False
        if qsf:
            self._he_buffers()
        if self._buffers is None:
            raise RuntimeError("this decoder was made with use_native=False")
        tr = self.trace
        if tr is not None:
            span = tr.open("parse", chunk_id, t0)
        arrays, host = self._buffers[buf_slot]
        # the previous copies out of this buffer must have landed before the
        # parser overwrites it
        self._spanned("parse.wait_h2d", chunk_id, _wait,
                      self._h2d_done[buf_slot])
        # an untraced parse is asked for no counts
        counted = {} if tr is None else {
            "counts": np.zeros(len(PARSE_COUNTERS), np.int64)}
        status, has_tns, errmsg = self._spanned(
            "parse.native", chunk_id, native.parse_batch_spec,
            payloads_per_stream, self._sample_indices, self._chan_configs,
            self._base_slots, self._n_slots, self.prev_shapes, arrays,
            tables_pack=self._tables_pack, want_qsf=qsf,
            want_pred=self._any_main, want_i16=compact, **counted)
        for name, n in zip(PARSE_COUNTERS, counted.get("counts", ())):
            tr.count(name, chunk_id, int(n))
        self._last_status = status
        self._last_consumed = arrays.consumed_bits
        self._last_fil_sbr = arrays.fil_sbr
        use_qsf = qsf and bool(arrays.qsf_ok.all())
        drc = self.drc_scale > 0 and bool(arrays.fil_drc.any())
        if drc:
            self._apply_native_drc(payloads_per_stream, arrays)
            use_qsf = False   # DRC gains fold into the f32 spectra only
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
        if use_qsf:
            keys = ["spec_q", "spec_sf", "meta"]
        elif compact:
            # the parse threads wrote the int16 spectra into the host
            # tensors; a DRC fold changed the f32 spectra after them
            if drc:
                self._spanned("parse.compact", chunk_id, native.compact_spec,
                              arrays)
            if tr is not None:
                tr.count("compact_separate" if drc else "compact_fused",
                         chunk_id)
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
        has_short = bool(meta[:, :, 4].any())
        n_stream_frames = sum(len(p) for p in payloads_per_stream if p)
        n_channel_frames = int((meta[:, :, 5] != 0).sum())
        t1 = time.perf_counter_ns()
        if tr is not None:
            tr.close(span, t1)
        batch.update(
            _slot=buf_slot, _has_tns=has_tns, _has_short=has_short,
            _spec_i16=compact and not use_qsf, _spec_qsf=use_qsf,
            _has_pred=self._any_main, _has_cce_post=n_post > 0,
            _has_cce_time=n_time > 0, _chunk_id=chunk_id,
            _t_start=t0 * 1e-9, _parse_seconds=(t1 - t0) * 1e-9,
            _n_stream_frames=n_stream_frames,
            _n_channel_frames=n_channel_frames)
        return batch

    def _spanned(self, name: str, chunk_id: int | None, fn, *args, **kw):
        """fn(*args, **kw), inside span `name` when tracing."""
        tr = self.trace
        if tr is None:
            return fn(*args, **kw)
        span = tr.open(name, chunk_id)
        try:
            return fn(*args, **kw)
        finally:
            tr.close(span)

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
    def _upload_batch(self, batch: dict, mesh=None) -> dict:
        """Host-to-device stage: each shard's slice of the pinned parse
        buffers (meshlib.spec_batch_shardings; the whole buffer without a
        mesh) lands on its own device, on CUDA by asynchronous copies on that
        device's copy stream, which its compute stream waits for; so does
        the next parse into the buffer.  Returns {"_shards": meshlib.Shards,
        **facts}."""
        mesh = self._mesh(mesh)
        arrs = {k: v for k, v in batch.items() if not k.startswith("_")}
        facts = {k: v for k, v in batch.items() if k.startswith("_")}
        lay = self._layout(mesh)
        host = meshlib.spec_batch_shardings(mesh, arrs, lay)
        if not self._cuda:
            return {"_shards": meshlib.Shards(host, lay), **facts}
        tr = self.trace if self._traces_mesh(mesh) else None
        events, parts = [], []
        for i, row in enumerate(host):
            parts.append([])
            for k, shard in enumerate(row):
                dev = mesh.devices[i][k]
                h2d, compute, _ = self._streams(dev)
                span = (tr.open("mesh.h2d", facts["_chunk_id"])
                        if tr is not None else None)
                with torch.cuda.stream(h2d):
                    d = {key: _pinned(v).to(dev, non_blocking=True)
                         for key, v in shard.items()}
                    ev = torch.cuda.Event()
                    ev.record(h2d)
                compute.wait_event(ev)
                for v in d.values():
                    v.record_stream(compute)
                events.append(ev)
                parts[i].append(d)
                if span is not None:
                    tr.close(span)
        self._h2d_done[facts["_slot"]] = events
        return {"_shards": meshlib.Shards(parts, lay), **facts}

    def _spec_flags(self, facts: dict, out_int16: bool,
                    use_pallas: bool) -> P.PipelineFlags:
        return P.PipelineFlags(
            has_stereo=False, has_tns=facts["_has_tns"], out_int16=out_int16,
            use_pallas=use_pallas, has_cce_post=facts["_has_cce_post"],
            has_cce_time=facts["_has_cce_time"], spec_i16=facts["_spec_i16"],
            spec_qsf=facts["_spec_qsf"], has_pred=facts["_has_pred"],
            has_short=facts["_has_short"], eld=self._eld)

    def _pend(self, t0: float, facts: dict, done) -> None:
        """Open the stats record that finalize_step completes: (the step's
        start, its dispatch, its parse seconds, stream frames, channel
        frames, the devices' done events)."""
        self._pending_steps[facts["_chunk_id"]] = (
            facts["_t_start"], t0, facts["_parse_seconds"],
            facts["_n_stream_frames"], facts["_n_channel_frames"], done)
        self.stats.streams_failed = sum(st.failed for st in self.streams)

    def _device_step(self, batch: dict, out_int16: bool = False,
                     use_pallas: bool = True, mesh=None):
        """Dispatch decode_spec_step on every shard of `mesh` (no mesh: one
        shard, the whole chunk on self.device), each on its device's compute
        stream (meshlib.sharded_decode_spec_step: on the kernel route the
        compiled step, a CUDA graph replayed per shard on the card); the
        overlap and, for a
        batch with a Main-profile stream, the predictor state are replaced
        by the step's.  Takes a batch from _upload_batch over the same mesh,
        or a parsed one, which it uploads first.  Returns the PCM as
        meshlib.RowBlocks; finalize_step completes the timing record."""
        mesh = self._mesh(mesh)
        if "_shards" not in batch:
            batch = self._upload_batch(batch, mesh)
        shards = batch.pop("_shards")
        facts = {k: batch.pop(k) for k in list(batch) if k.startswith("_")}
        flags = self._spec_flags(facts, out_int16, use_pallas)
        t0 = time.perf_counter()
        step = meshlib.sharded_decode_spec_step(flags, mesh)
        if self._traces_mesh(mesh):     # every stream shard's step issued
            pcm = self._spanned("mesh.dispatch", facts["_chunk_id"],
                                self._run_step, step, shards, flags, mesh)
        else:
            pcm = self._run_step(step, shards, flags, mesh)
        self._pend(t0, facts, self._record_done(mesh.device_set))
        return pcm

    def finalize_step(self, pcm, chunk_id: int | None = None) -> np.ndarray:
        """Bring a _device_step result to the host and complete the stats
        record of chunk `chunk_id` (device_seconds spans dispatch -> PCM on
        the host; a direct call, chunk None, also adds its wall from its
        parse).  A direct call's record is the latest direct step's, so
        finalize a direct step before the next one.  Its row blocks land in
        their rows of one pinned buffer, each on its device's copy
        stream."""
        pending = self._pending_steps.pop(chunk_id, None)
        out = self._download_blocks(pcm, pending[-1] if pending else {})
        if pending is not None:
            t_start, t0, parse_s, n_stream_frames, n_channel_frames, _ = \
                pending
            now = time.perf_counter()
            self.stats.add_step(parse_s, now - t0, n_stream_frames,
                                n_channel_frames,
                                now - t_start if chunk_id is None else 0.0)
        return out

    def _download_blocks(self, pcm: meshlib.RowBlocks, done: dict
                         ) -> np.ndarray:
        first = pcm.parts[0]
        shape = (pcm.bounds[-1][1], *first.shape[1:])
        if not self._cuda:
            return torch.cat(pcm.parts).numpy()
        host = torch.empty(shape, dtype=first.dtype, pin_memory=True)
        events = []
        for part, (lo, hi), dev in zip(pcm.parts, pcm.bounds, pcm.devices):
            _, compute, d2h = self._streams(dev)
            if done.get(dev) is not None:
                d2h.wait_event(done[dev])
            else:
                d2h.wait_stream(compute)
            with torch.cuda.stream(d2h):
                host[lo:hi].copy_(part, non_blocking=True)
                part.record_stream(d2h)
                ev = torch.cuda.Event()
                ev.record(d2h)
            events.append(ev)
        _wait(events)
        return host.numpy()

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
        device PCM (meshlib.RowBlocks) for a later finalize_step.
        use_pallas=False runs the device step as plain PyTorch."""
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
        pcm = self._device_step(parsed, out_int16, use_pallas=use_pallas)
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
        pcm = self.finalize_step(self._device_step(parsed))
        return pcm, consumed

    def decode_pipelined(self, chunk_iter, out_int16: bool = True,
                         compact: bool = True, mesh=None):
        """Generator decoding an iterator of payload chunks on the native
        route as a 3-stage pipeline over two parse buffers (_pipeline):

            main thread    : native parse of chunk k (releases the GIL)
            upload worker  : H2D copy + dispatch of chunk k-1
            download worker: D2H of chunk k-2

        so the steady-state wall per chunk is the slowest stage, not the
        sum.  On CUDA the copies in both directions run on their own
        streams, concurrently with the compute stream; the overlap and the
        predictor state advance on the upload worker only, in chunk order,
        on the compute stream.  A reset asked for through request_reset
        while this runs applies at the next chunk boundary, after the steps
        in flight have finished.  Yields host PCM arrays [C, T, F] in
        chunk order.

        With `mesh` (runtime/mesh.py make_mesh) every stage runs sharded:
        the upload worker lands each shard's slice on its devices and
        dispatches every shard's step, the download worker brings each
        shard's PCM into its rows of the output."""
        mesh = self._mesh(mesh)

        def host(chunk, slot, k):
            return self._parse_native(chunk, buf_slot=slot, compact=compact,
                                      chunk_id=k)

        def upload(batch, k):
            return self._spanned("upload_dispatch", k, self._device_step,
                                 batch, out_int16, mesh=mesh)

        def download(pcm, k):
            return self._spanned("download", k, self.finalize_step, pcm, k)

        yield from self._pipeline(chunk_iter, host, upload, download,
                                  lambda: bool(self._deferred_resets),
                                  self._apply_deferred_resets)

    def _pipeline(self, chunk_iter, host, upload, download, unsettled,
                  settle):
        """The serving pipeline of decode_pipelined and decode_he_pipelined.
        Chunk k (numbered from 0 in the order chunk_iter hands them over)
        runs host(chunk, buffer slot, k) on this thread, upload(its result,
        k) on the upload worker, download(that result, k) on the download
        worker, while chunk k + 1 runs on this thread; the buffer slot
        alternates.  Before a chunk, when unsettled() says the state the
        workers use is to change (resets, re-adoption), everything in
        flight finishes first, then settle() runs.  Yields the downloads'
        results in chunk order; stats.wall_seconds grows from the first
        hand-over to each yield, and the waits on the workers are the spans
        wait.upload and wait.download."""
        up_pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="upload")
        down_pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="download")
        up = down = None     # (chunk id, future) in flight on each worker
        t_last = None

        def emit():
            nonlocal down, t_last
            k, fut = down
            out = self._spanned("wait.download", k, fut.result)
            down = None
            now = time.perf_counter()
            self.stats.wall_seconds += now - t_last
            t_last = now
            yield out

        def advance():       # the upload in flight moves to the download
            nonlocal up, down
            k, fut = up
            res = self._spanned("wait.upload", k, fut.result)
            up = None
            if down is not None:
                yield from emit()
            down = (k, down_pool.submit(download, res, k))

        try:
            self._pipeline_active = True
            for k, chunk in enumerate(chunk_iter):
                if t_last is None:
                    t_last = time.perf_counter()
                if unsettled():
                    if up is not None:
                        yield from advance()
                    if down is not None:
                        yield from emit()
                    settle()
                res = host(chunk, k & 1, k)
                if up is not None:
                    yield from advance()
                up = (k, up_pool.submit(upload, res, k))
            if up is not None:
                yield from advance()
            if down is not None:
                yield from emit()
        finally:
            self._pipeline_active = False
            up_pool.shutdown(wait=True)
            down_pool.shutdown(wait=True)
            self._apply_deferred_resets()

    # -- HE-AAC (SBR) --------------------------------------------------------
    def _sbr_init(self) -> None:
        """The SBR state, made at the first HE chunk: per stream the SBR
        parse context, per slot the host's sequential state, the float64
        replay processors of sticky slots, the per-slot header cfg planes
        and the device state; and the Parametric Stereo fields, which stay
        empty until a slot's first ps_data."""
        if hasattr(self, "_sbr_ctxs"):
            return
        self._sbr_ctxs = [
            sbrmod.SBRContext(sample_rate=2 * st.config.sample_rate)
            for st in self.streams]
        self._sbr_host_states = [SP.SBRHostState() for _ in range(self.C)]
        self._sbr_np_procs: list = [None] * self.C
        # slots replaying on the float64 path (a header change mid-chunk):
        # their filterbank state lives in the processor until
        # _readopt_sticky moves it back to the device at a chunk boundary
        self._sbr_np_sticky = [False] * self.C
        with self._on_compute():
            self._sbr_dev_state = SB.sbr_state_init(self.C, self.device)
        # per-slot header statics as rows of the cfg planes that the one
        # SBR program reads, so headers may mix across the batch;
        # _slot_sbr_key tracks the (header, id(tables)) rendered in a row.
        # _sbr_cfg_snap is the planes' copy the next chunk runs with (None
        # after a row changed), _sbr_cfg_dev its device copy
        self._sbr_cfg_planes = SB.cfg_planes_zeros(self.C)
        self._slot_sbr_key: list = [None] * self.C
        self._slot_sbr_hdr: list = [None] * self.C
        self._sbr_cfg_snap: dict | None = None
        self._sbr_cfg_dev: tuple | None = None
        # sticky slots _readopt_sticky could not re-adopt yet
        self._readopt_blocked: set[int] = set()
        # parsed context-free SBR payloads, shared across streams: serving
        # fleets repeat identical payloads
        self._sbr_parse_cache: dict = {}
        # Parametric Stereo: per slot its band mode (None until its first
        # ps_data; 20- and 34-band slots mix: a batch of one mode runs the
        # single-mode program, a mixed one the dual program), the chunk's
        # packed planes, the host's sequential pack state, the slot that
        # takes the right channel, the device state per band mode (made at
        # first use) with its freshness (a set that sat out a chunk while
        # the other mode ran re-seeds before reuse) and the row seeds of
        # re-adopted slots, and the float64 replay state of sticky slots
        self._ps_enabled = False
        self._ps_slot_is34: list = [None] * self.C
        self._ps_dense = None
        self._ps_pack_states = [PP.PSPackState() for _ in range(self.C)]
        self._ps_pair = [-1] * self.C
        self._ps_dev_states: dict = {False: None, True: None}
        self._ps_fresh: dict = {False: False, True: False}
        self._ps_row_seeds: dict = {False: {}, True: {}}
        self._ps_np: list = [None] * self.C

    def _ps_engage(self, slot: int) -> None:
        """First ps_data on `slot`: pick its pair slot (the spare slot after
        it, which takes the right channel), make the chunk's PS planes and
        switch the chunk to the SBR + PS program."""
        if self._ps_pair[slot] < 0:
            st = next(s for s in self.streams
                      if s.base_slot <= slot < s.base_slot + s.n_slots)
            pair = slot + 1
            if pair >= st.base_slot + st.n_slots:
                raise SlotOverflowError(
                    "HE-AAC v2 (Parametric Stereo) emits 2 channels from a "
                    "mono stream and needs a spare slot; raise cce_slots "
                    "(BatchDecoder/decode_adts) to at least 1")
            self._ps_pair[slot] = pair
        if self._ps_dense is None:
            self._ps_dense = PP.alloc_ps_dense(self.C, self.T)
        self._ps_enabled = True

    def _ps_mode_begin(self, modes: list, prev_state: meshlib.RowBlocks,
                       mesh: meshlib.Mesh) -> None:
        """Make sure a device PS state set exists and is fresh for every
        band mode that runs this chunk, then apply the pending row seeds of
        re-adopted slots.  The planes that do not depend on the mode (the
        two synthesis histories and the hybrid FIR history) come from the
        other set when it is fresh (the program that ran owned the
        synthesis of every slot, PS or not), or, before any PS program
        ran, the left synthesis continues the mono path's v_hist.  A set
        that sat out re-seeds those planes the same way and zeroes the
        rest; the returning slots then overlay their own rows.  Runs on the
        mesh's compute streams: prev_state (the SBR state) and the PS state
        sets are row blocks over the stream shards, and each block begins
        alone."""
        rows, devs = prev_state.bounds, prev_state.devices
        for m in modes:
            src = self._ps_dev[not m] if self._ps_fresh[not m] else None
            st = self._sharded(self._ps_dev[m], mesh, rows)
            src = self._sharded(src, mesh, rows)
            self._ps_dev[m] = meshlib.RowBlocks(
                [self._ps_block_begin(
                    m, None if st is None else st.parts[i],
                    None if src is None else src.parts[i],
                    prev_state.parts[i], lo, hi, devs[i])
                 for i, (lo, hi) in enumerate(rows)], rows, devs)
            self._ps_row_seeds[m] = {}
            self._ps_fresh[m] = True
        for m in (False, True):
            if m not in modes:
                self._ps_fresh[m] = False

    def _ps_block_begin(self, m: bool, st0, src, prev_state: dict, lo: int,
                        hi: int, dev) -> dict:
        """_ps_mode_begin for band mode m on the rows [lo, hi) held on
        `dev`: st0 their state of mode m (None before first use), src that
        of the other mode when fresh, prev_state their SBR state."""
        indep = ("v_l", "v_r", "hist4_r", "hist4_i")
        if st0 is None:
            st0 = PB.ps_state_init(hi - lo, m, dev)
            if src is not None:
                for k in indep:
                    st0[k] = src[k].clone()
            else:
                st0["v_l"] = prev_state["v_hist"].clone()
        elif not self._ps_fresh[m]:
            st0 = {k: (src[k].clone() if src is not None and k in indep
                       else torch.zeros_like(v)) for k, v in st0.items()}
        for s, rows in self._ps_row_seeds[m].items():
            if lo <= s < hi:
                for k, row in rows.items():
                    st0[k][s - lo] = torch.as_tensor(
                        np.asarray(row, np.float32), device=dev)
        return st0

    def _sbr_chunk_begin(self, payloads_per_stream) -> None:
        """Per-chunk bookkeeping for the float64 replay: frame counts per
        slot, the slot's SBR records, and a snapshot of the host's
        sequential state (a slot that turns sticky mid-chunk replays its
        whole chunk from the state before it)."""
        self._chunk_nframes = [0] * self.C
        for st, payloads in zip(self.streams, payloads_per_stream):
            for s in range(st.base_slot, st.base_slot + st.n_slots):
                self._chunk_nframes[s] = len(payloads or [])
        self._chunk_sbr_records: list[list] = [[] for _ in range(self.C)]
        # slots that packed an SBR frame this chunk: their cfg row is frozen
        # for the chunk
        self._sbr_packed_chunk = [False] * self.C
        if self._ps_dense is not None:
            self._ps_dense = PP.alloc_ps_dense(self.C, self.T)

        def clone(hs):
            return SP.SBRHostState(
                bw=hs.bw.copy(),
                invf_prev=(None if hs.invf_prev is None
                           else hs.invf_prev.copy()),
                index_noise=hs.index_noise, index_sine=hs.index_sine,
                la_prev=hs.la_prev,
                s_index_prev=(None if hs.s_index_prev is None
                              else hs.s_index_prev.copy()),
                t_env_last=hs.t_env_last)

        self._host_state_snap = [
            None if self._sbr_np_sticky[s] else
            clone(self._sbr_host_states[s]) for s in range(self.C)]

        def clone_ps(pst):
            return PP.PSPackState(
                h_prev=pst.h_prev.copy(),
                ipd_hist=pst.ipd_hist.copy(), opd_hist=pst.opd_hist.copy(),
                ps_prev=pst.ps_prev, is34_prev=pst.is34_prev,
                h_slot_imag=pst.h_slot_imag.copy())

        # a slot that turns sticky mid-chunk seeds its float64 PS replay
        # from the pack state before the chunk
        self._ps_pack_snap = (
            None if not self._ps_enabled else
            [None if self._sbr_np_sticky[s] else
             clone_ps(self._ps_pack_states[s]) for s in range(self.C)])

    def _sbr_pack_payload(self, dense, sf, slot: int, nch: int,
                          t: int) -> None:
        """Pack one parsed SBRFrame into the dense planes, and a mono
        element's PS parameters into the PS planes.  A header change
        re-renders the slot's cfg row when the slot has packed no SBR frame
        this chunk; mid-chunk, the slot replays the chunk on the float64
        path and re-adopts at the next boundary.  So does a PS band-scheme
        flip with state carried.  VAR-class envelope overhang runs on the
        device (the program's Y carry)."""
        ps = getattr(sf, "ps", None) if nch == 1 else None
        eq = sbrmod.dequant(sf)
        key = (sf.header, id(sf.tables))
        for c in range(nch):
            s = slot + c
            self._chunk_sbr_records[s].append((t, sf, c, eq[c]))
            if self._slot_sbr_key[s] != key and not self._sbr_np_sticky[s]:
                if self._sbr_packed_chunk[s]:
                    self._sbr_np_sticky[s] = True
                else:
                    self._set_cfg_row(s, sf.header, sf.tables)
            if not self._sbr_np_sticky[s]:
                SP.pack_channel_frame(dense, s, t, self._sbr_host_states[s],
                                      sf, c, eq[c])
                self._sbr_packed_chunk[s] = True
        if nch == 1 and (ps is not None
                         or self._ps_pack_states[slot].ps_prev is not None):
            self._ps_engage(slot)
            if not self._sbr_np_sticky[slot]:
                if not PP.pack_ps_frame(self._ps_dense, slot, t,
                                        self._ps_pack_states[slot], ps):
                    # a band-scheme flip with carried state: the remap of
                    # the carry runs on the float64 path for this chunk
                    self._sbr_np_sticky[slot] = True
                else:
                    self._ps_slot_is34[slot] = \
                        self._ps_pack_states[slot].is34_prev

    def _set_cfg_row(self, s: int, hdr, tbl) -> None:
        """Render slot `s`'s header statics into its cfg-plane row; the
        next chunk takes a fresh copy of the planes."""
        limgain = float(sbrmod._consts()["limgain"][hdr.limiter_gains])
        SB.set_cfg_row(self._sbr_cfg_planes, s,
                       SB.SBRStaticConfig.from_tables(tbl, limgain))
        self._slot_sbr_key[s] = (hdr, id(tbl))
        self._slot_sbr_hdr[s] = hdr
        self._sbr_cfg_snap = None

    def _clear_cfg_row(self, s: int) -> None:
        if self._slot_sbr_key[s] is None:
            return
        zero = SB.cfg_planes_zeros(1)
        for k in self._sbr_cfg_planes:
            self._sbr_cfg_planes[k][s] = zero[k][0]
        self._slot_sbr_key[s] = None
        self._slot_sbr_hdr[s] = None
        self._sbr_cfg_snap = None

    def _cfg_planes_device(self, snap: dict, mesh: meshlib.Mesh,
                           rows: tuple) -> list:
        """The cfg planes `snap` on the devices, kept until the planes or
        the mesh change: steady chunks copy no cfg bytes.  The list of the
        stream shards' rows of them, each on its shard's device."""
        key = (snap, mesh, rows)
        if (self._sbr_cfg_dev is None
                or any(a is not b for a, b in zip(self._sbr_cfg_dev[0], key))):
            with self._on_mesh(mesh):
                dev = meshlib.shard_stream_tree(mesh, snap, rows)
            self._sbr_cfg_dev = (key, dev)
        return self._sbr_cfg_dev[1]

    def _he_ctx(self, buf_slot: int, chunk_id: int | None = None) -> dict:
        """One chunk's SBR bookkeeping, captured so that the device phase
        can run on a worker while the next chunk parses (the captured
        objects are made anew per chunk; the sticky set and the cfg planes
        are frozen here).  Slots with no SBR payload yet keep a zeroed cfg
        row (has_sbr = 0 routes them through the upsampling branch).  With
        PS, the live band modes of the chunk (one: the single-mode program;
        two: the dual program), the per-slot modes and pairs, and the PS
        planes staged for the copy to the device."""
        if self._sbr_cfg_snap is None:
            self._sbr_cfg_snap = {k: v.copy()
                                  for k, v in self._sbr_cfg_planes.items()}
        ctx = dict(
            nframes=self._chunk_nframes,
            records=self._chunk_sbr_records,
            host_snap=self._host_state_snap,
            sticky=[s for s in range(self.C)
                    if self._sbr_np_sticky[s] and self._chunk_nframes[s]],
            cfg=self._sbr_cfg_snap, slot=buf_slot, chunk_id=chunk_id,
            ps_enabled=self._ps_enabled, ps_snap=self._ps_pack_snap,
            ps_slot_modes=list(self._ps_slot_is34),
            ps_pair=list(self._ps_pair))
        if self._ps_enabled:
            ctx["ps_modes"] = sorted({
                bool(self._ps_slot_is34[s]) for s in range(self.C)
                if self._ps_slot_is34[s] is not None
                and not self._sbr_np_sticky[s] and self._ps_pair[s] >= 0})
            ctx["ps_planes"] = self._stage_ps(ctx, buf_slot)
        return ctx

    def _stage_ps(self, ctx: dict, buf_slot: int) -> dict:
        """The chunk's PS planes (ps_pack.dense_to_dict with the output
        routing and, for a mixed chunk, the per-slot mode mask) as host
        tensors for the copy to the device: on CUDA in the pinned buffers
        of `buf_slot`, in the narrow types of _PS_FIELDS."""
        out_src = np.arange(self.C, dtype=np.int32)
        out_role = np.zeros(self.C, np.int32)
        for s, p in enumerate(ctx["ps_pair"]):
            if p >= 0:
                out_src[p] = s
                out_role[p] = 1
        planes = PP.dense_to_dict(self._ps_dense,
                                  PP.himag_plane(self._ps_pack_states, self.C),
                                  out_src, out_role)
        if len(ctx["ps_modes"]) == 2:
            planes["slot_is34"] = np.array(
                [1.0 if m else 0.0 for m in ctx["ps_slot_modes"]], np.float32)
        if not self._cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in planes.items()}
        self._ps_buffers()
        _wait(self._ps_h2d_done[buf_slot])   # the last copies out landed
        bufs = self._ps_bufs[buf_slot]
        for k, v in planes.items():
            np.copyto(bufs[k].numpy(), v, casting="unsafe")
        return {k: bufs[k] for k in planes}

    def _upload_tree(self, planes: dict, mesh: meshlib.Mesh, rows: tuple,
                     done: list, buf_slot: int) -> list:
        """Each stream shard's rows of `planes` (meshlib.
        stream_tree_shardings) copied to its device on that device's copy
        stream, which its compute stream waits for; done[buf_slot] keeps
        the copies' events for the next staging into the same buffers."""
        host = meshlib.stream_tree_shardings(mesh, planes, rows)
        if not self._cuda:
            return host
        out, events = [], []
        for part, dev in zip(host, mesh.row_devices):
            h2d, compute, _ = self._streams(dev)
            with torch.cuda.stream(h2d):
                d = {k: _pinned(v).to(dev, non_blocking=True)
                     for k, v in part.items()}
                ev = torch.cuda.Event()
                ev.record(h2d)
            compute.wait_event(ev)
            for v in d.values():
                v.record_stream(compute)
            events.append(ev)
            out.append(d)
        done[buf_slot] = events
        return out

    def _sbr_upload(self, dense: dict, ctx: dict, mesh: meshlib.Mesh):
        """The chunk's SBR planes and, with PS, its PS planes on the stream
        shards (_upload_tree): (SBR planes, PS planes or None)."""
        rows = self._layout(mesh).rows
        planes = self._upload_tree(dense, mesh, rows, self._sbr_h2d_done,
                                   ctx["slot"])
        ps = (self._upload_tree(ctx["ps_planes"], mesh, rows,
                                self._ps_h2d_done, ctx["slot"])
              if ctx["ps_enabled"] else None)
        return planes, ps

    def _stage_dense(self, dense, compact: bool, buf_slot: int) -> dict:
        """The SBR planes as host tensors for the copy to the device:
        compacted (sbr_pack.compact_dense) into the pinned buffers of
        `buf_slot`, or the exact planes as they are."""
        if not compact:
            return {k: torch.from_numpy(v) for k, v in vars(dense).items()}
        planes = SP.compact_dense(dense, buf_slot)
        if not self._cuda:
            return {k: torch.from_numpy(v) for k, v in planes.items()}
        self._he_buffers()
        _wait(self._sbr_h2d_done[buf_slot])   # the last copies out landed
        bufs = self._sbr_bufs[buf_slot]
        for k, v in planes.items():
            np.copyto(bufs[k].numpy(), v)
        return bufs

    def _he_host_phase(self, payloads_per_stream, compact: bool = True,
                       buf_slot: int = 0, chunk_id: int | None = None):
        """Host half of one HE chunk on the native route: the C core parse
        (which records the SBR FIL positions), the Python parse of the SBR
        extensions, the dense pack.  Returns (parsed core, SBR planes, ctx)
        for the device half, which may run on a worker while the next
        chunk's host phase runs.

        The core spectra stay exact: the envelope adjuster divides by the
        source bands' energies, so the int16 compaction's error would be
        amplified ~100x on near-empty bands.  compact=True sends them as
        the exact q/sf form (2.25 bytes a bin) where the chunk allows it and
        the SBR planes compacted; compact=False sends f32 spectra and the
        exact planes.

        When tracing, the SBR loop interleaves parse and pack a payload at
        a time, so it counts their nanoseconds (sbr_parse_ns: the cache
        lookup and, on a miss, read_sbr_extension; sbr_pack_ns) and the
        cache's lookups, hits (a lookup that found an entry) and inserts."""
        t0 = time.perf_counter_ns()
        tr = self.trace
        if tr is not None:
            span = tr.open("he_host", chunk_id, t0)
            part = tr.open("he.begin", chunk_id, t0)
        self._sbr_init()
        self._sbr_chunk_begin(payloads_per_stream)
        dense = (SP.alloc_dense_cached(self.C, self.T, buf_slot) if compact
                 else SP.alloc_dense(self.C, self.T))
        if tr is not None:
            tr.close(part)
        parsed = self._parse_native(payloads_per_stream, buf_slot=buf_slot,
                                    compact=False, qsf=compact,
                                    chunk_id=chunk_id)
        if tr is not None:
            part = tr.open("he.sbr", chunk_id)
            parse_ns = pack_ns = n_payloads = hits = inserts = 0
        fil = self._last_fil_sbr
        g = 0
        cache = self._sbr_parse_cache
        for i, payloads in enumerate(payloads_per_stream):
            ctx = self._sbr_ctxs[i]
            for t, payload in enumerate(payloads or []):
                for rec in fil[g]:
                    bitpos, slot, nch = int(rec[0]), int(rec[1]), int(rec[2])
                    if bitpos == 0:
                        continue
                    if tr is not None:
                        ta = time.perf_counter_ns()
                    key = (payload, bitpos, nch)
                    found = sf = cache.get(key)
                    if sf is not None and sf.header == ctx.header:
                        sbrmod.apply_frame_state(ctx, sf)
                    else:
                        r = BitReader(payload)
                        r.seek_bits(bitpos)
                        ext_type = r.read(4)
                        sf = sbrmod.read_sbr_extension(
                            r, ctx, nch == 2,
                            ext_type == sbrmod.EXT_SBR_DATA_CRC)
                        insert = sbrmod.frame_is_context_free(sf)
                        if insert:
                            if len(cache) > 512:
                                cache.clear()
                            cache[key] = sf
                    if tr is not None:
                        tb = time.perf_counter_ns()
                        parse_ns += tb - ta
                        n_payloads += 1
                        hits += found is not None
                        inserts += sf is not found and insert
                    self._sbr_pack_payload(dense, sf, slot, nch, t)
                    if tr is not None:
                        pack_ns += time.perf_counter_ns() - tb
                g += 1
        if tr is not None:
            tr.close(part)
            for name, n in (("sbr_parse_ns", parse_ns),
                            ("sbr_pack_ns", pack_ns),
                            ("sbr_payloads", n_payloads),
                            ("sbr_cache_lookups", n_payloads),
                            ("sbr_cache_hits", hits),
                            ("sbr_cache_inserts", inserts)):
                tr.count(name, chunk_id, n)
            part = tr.open("he.stage", chunk_id)
        staged = self._stage_dense(dense, compact, buf_slot)
        ctx = self._he_ctx(buf_slot, chunk_id)
        if tr is not None:
            t1 = time.perf_counter_ns()
            tr.close(part, t1)
            tr.close(span, t1)
        parsed["_t_start"] = t0 * 1e-9   # a direct step's wall starts here
        return parsed, staged, ctx

    def _sbr_dispatch(self, core_pcm: meshlib.RowBlocks, dev_dense: list,
                      ps_dense: list | None, ctx: dict, out_int16: bool,
                      mesh: meshlib.Mesh):
        """Device half of the SBR stage: on the core PCM, row blocks on the
        stream shards' first devices, each shard runs the compiled SBR
        program, or the SBR + PS program when the chunk carries PS (a CUDA
        graph replayed on the card: runtime/graphs.py), on its
        own rows there (its rows of the planes from _sbr_upload, of the cfg
        planes and of the state), on that device's compute stream.  Slots
        that turn sticky this chunk first get host copies of their state
        rows as they stand before the step (their float64 replay continues
        from them; a PS slot's from its PS state too).  Returns (device PCM
        [C, T, 2F] as row blocks, seeds) for _sbr_download; int16 PCM when
        out_int16 and no slot is sticky."""
        rows, devs = core_pcm.bounds, core_pcm.devices
        sticky = ctx["sticky"]
        prev = self._sharded(self._sbr_dev, mesh, rows)
        fresh = [s for s in sticky if self._sbr_np_procs[s] is None]
        seeds = {}
        with self._on_mesh(mesh):
            for s in fresh:
                row = meshlib.row_of(prev, s)
                seeds[s] = tuple(row[k].cpu().numpy().astype(np.float64)
                                 for k in _SEED_KEYS)
                m = ctx["ps_slot_modes"][s] if ctx["ps_enabled"] else None
                pdev = self._ps_dev[bool(m)] if m is not None else None
                if (ctx["ps_pair"][s] >= 0 and pdev is not None
                        and self._ps_np[s] is None):
                    prow = meshlib.row_of(pdev, s)
                    seeds[("ps", s)] = {
                        k: prow[k].cpu().numpy().astype(np.float64)
                        for k in _PS_SEED_KEYS}
        cfg = self._cfg_planes_device(ctx["cfg"], mesh, rows)
        i16 = out_int16 and not sticky
        modes = (ctx["ps_modes"] or [False]) if ctx["ps_enabled"] else []
        with self._on_mesh(mesh):
            if not ctx["ps_enabled"]:
                pcm2, state = meshlib.sharded_sbr_apply(mesh, i16)(
                    core_pcm, dev_dense, prev, cfg)
            elif len(modes) == 2:
                self._ps_mode_begin(modes, prev, mesh)
                pcm2, state, s20, s34 = meshlib.sharded_sbr_ps_apply_dual(
                    mesh, i16)(core_pcm, dev_dense, ps_dense, prev,
                               self._ps_dev[False], self._ps_dev[True], cfg)
                self._ps_dev = {False: s20, True: s34}
            else:
                self._ps_mode_begin(modes, prev, mesh)
                m = modes[0]
                pcm2, state, self._ps_dev[m] = meshlib.sharded_sbr_ps_apply(
                    mesh, i16, m)(core_pcm, dev_dense, ps_dense, prev,
                                  self._ps_dev[m], cfg)
            # contiguous: the state outlives the chunk's large intermediates
            state.parts = [{k: v.contiguous() for k, v in part.items()}
                           for part in state.parts]
            self._sbr_dev = state
            done = self._record_done(devs)
        # the core step's stats record now completes with the SBR output
        pending = self._pending_steps.get(ctx["chunk_id"])
        if pending is not None:
            self._pending_steps[ctx["chunk_id"]] = (*pending[:-1], done)
        return pcm2, seeds

    def _sbr_stage(self, core_pcm: meshlib.RowBlocks, dense: dict, ctx: dict,
                   out_int16: bool = False, mesh=None) -> np.ndarray:
        """Upload, dispatch and download of the SBR stage in one call."""
        mesh = self._mesh(mesh)
        pcm2, seeds = self._sbr_dispatch(
            core_pcm, *self._sbr_upload(dense, ctx, mesh), ctx, out_int16,
            mesh)
        return self._sbr_download(pcm2, seeds, ctx, core_pcm)

    def _sbr_download(self, pcm2, seeds: dict, ctx: dict,
                      core_pcm) -> np.ndarray:
        """Host half of the SBR stage: bring the PCM to the host, then
        replay the sticky slots on the float64 per-channel path, a slot
        that has just turned sticky starting from its pre-chunk device
        state (seeds) and host snapshot, so the switch is continuous."""
        sticky = ctx["sticky"]
        out = self.finalize_step(pcm2, ctx["chunk_id"])
        if not sticky:
            return out
        tr = self.trace
        if tr is not None:
            span = tr.open("download.replay", ctx["chunk_id"])
        # finalize_step waited for the SBR step, which followed the core's
        core_np = meshlib.gather(core_pcm, torch.device("cpu")).cpu().numpy()
        from aacjax_torch.host.ps_decode import apply_ps
        for slot in sticky:
            proc = self._sbr_np_procs[slot]
            if proc is None:
                proc = SD.SBRChannelProc()
                hs = ctx["host_snap"][slot]
                if hs is not None:
                    proc.bw = np.asarray(hs.bw, np.float64).copy()
                    proc.invf_prev = (None if hs.invf_prev is None
                                      else np.array(hs.invf_prev))
                    proc.index_noise = hs.index_noise
                    proc.index_sine = hs.index_sine
                    proc.la_prev = hs.la_prev
                    proc.s_index_prev = (None if hs.s_index_prev is None
                                         else np.array(hs.s_index_prev))
                    proc.t_env_last = hs.t_env_last
                x_hist, v_hist, xlr, xli, ytr, yti = seeds[slot]
                proc.x_hist = x_hist
                proc.v_hist = v_hist
                proc.xlow_hist = xlr + 1j * xli
                proc.y_tail = ytr + 1j * yti
                self._sbr_np_procs[slot] = proc
            recs = {t: (sf, c, eq) for (t, sf, c, eq) in ctx["records"][slot]}
            pair = ctx["ps_pair"][slot]
            for t in range(ctx["nframes"][slot]):
                core = core_np[slot, t].astype(np.float64)
                if t not in recs:
                    out[slot, t] = SD.process_passthrough(proc, core)
                    if pair >= 0:
                        out[pair, t] = out[slot, t]
                    continue
                sf, c, eq = recs[t]
                if pair < 0:
                    out[slot, t] = SD.process_channel(proc, core, sf, c, eq)
                    continue
                # a PS stream: the float64 stereo path, its state seeded
                # from the batched PS state and the pre-chunk pack state
                if self._ps_np[slot] is None:
                    self._ps_np[slot] = self._seed_ps_np(slot, ctx, seeds,
                                                         proc)
                psproc, vl, vr = self._ps_np[slot]
                X = SD.process_channel(proc, core, sf, 0, eq, return_x=True)
                xl, xr = apply_ps(psproc, X, getattr(sf, "ps", None))
                pl, vl = SD._qmf_synthesis_np(xl, vl)
                pr, vr = SD._qmf_synthesis_np(xr, vr)
                self._ps_np[slot] = (psproc, vl, vr)
                out[slot, t] = pl * (1.0 / 32768.0)
                out[pair, t] = pr * (1.0 / 32768.0)
        if tr is not None:
            tr.close(span)
        return out

    def _seed_ps_np(self, slot: int, ctx: dict, seeds: dict, proc):
        """The float64 PS replay state (PSProc, v_l, v_r) of a slot that
        turns sticky, warm where batched PS state exists: the synthesis
        histories, delay and allpass lines and transient trackers from the
        device state (apply_ps clears them itself if this frame flips the
        band scheme, as libavcodec does); the hybrid FIR's input history
        from the PS hist4 carry and the SBR xlow seed (X slots 26..29 and
        30..31 of the last frame); the H matrices, phase histories and the
        ps_data to replay from the pre-chunk pack snapshot."""
        from aacjax_torch.host.ps_decode import PSProc
        p = PSProc()
        vl = np.array(proc.v_hist)
        vr = vl * 0.0
        dev = seeds.get(("ps", slot))
        if dev is not None:
            vl = dev["v_l"].copy()
            vr = dev["v_r"].copy()
            nb = dev["delay_r"].shape[0]
            p.delay[:nb] = dev["delay_r"] + 1j * dev["delay_i"]
            nap = dev["ap_r"].shape[0]
            p.ap_delay[:nap] = dev["ap_r"] + 1j * dev["ap_i"]
            npar = dev["peak"].shape[0]
            p.peak_decay_nrg[:npar] = dev["peak"]
            p.power_smooth[:npar] = dev["psmooth"]
            p.peak_decay_diff[:npar] = dev["pdiff"]
        sd = seeds.get(slot)
        if sd is not None and dev is not None:
            xlr, xli = sd[2], sd[3]
            for i in range(5):
                p.in_hist[i] = np.concatenate([
                    dev["hist4_r"][:, i] + 1j * dev["hist4_i"][:, i],
                    xlr[0:2, i] + 1j * xli[0:2, i]])
        snap = (ctx.get("ps_snap") or [None] * self.C)[slot]
        if snap is not None and snap.ps_prev is not None:
            p.h_prev = snap.h_prev.copy()
            p.h_slot_imag[:] = snap.h_slot_imag
            p.ipd_hist[:17] = snap.ipd_hist
            p.opd_hist[:17] = snap.opd_hist
            p.ps_prev = snap.ps_prev
            p.is34_prev = snap.is34_prev
        return p, vl, vr

    def _readopt_sticky(self) -> set[int]:
        """Move sticky slots back onto the batched path at a settled chunk
        boundary: re-render the slot's cfg row from its stream's current
        header, rebuild its device state rows (x_hist, xlow, ytail, and
        v_hist for a slot without PS) from its float64 processor and its
        SBRHostState from the same.  A PS slot also gets its rows of its
        band mode's PS state set (applied by _ps_mode_begin after any
        re-seed of that set) and its PSPackState from its PSProc.  Returns
        the slots that cannot re-adopt yet (no header, or no PS band mode,
        seen since the divert); they retry at every boundary."""
        if not hasattr(self, "_sbr_ctxs"):
            return set()
        sticky = [s for s in range(self.C) if self._sbr_np_sticky[s]]
        if not sticky:
            self._readopt_blocked = set()
            return set()
        slot_stream = np.zeros(self.C, np.int32)
        for i, st in enumerate(self.streams):
            slot_stream[st.base_slot: st.base_slot + st.n_slots] = i
        blocked = set()
        rows = {k: [] for k in ("slot",) + _SEED_KEYS if k != "v_hist"}
        v_rows = {"slot": [], "v_hist": []}
        for s in sticky:
            ctx = self._sbr_ctxs[int(slot_stream[s])]
            proc = self._sbr_np_procs[s]
            ok = proc is not None and ctx.header is not None
            if ok and self._ps_pair[s] >= 0:
                pnp = self._ps_np[s]
                ok = pnp is not None and pnp[0].is34_prev is not None
            if not ok:
                blocked.add(s)
                continue
            self._set_cfg_row(s, ctx.header, sbrmod.derive_tables(
                ctx.header, ctx.sample_rate))
            rows["slot"].append(s)
            for k, v in (("x_hist", proc.x_hist),
                         ("xlow_r", proc.xlow_hist.real),
                         ("xlow_i", proc.xlow_hist.imag),
                         ("ytail_r", proc.y_tail.real),
                         ("ytail_i", proc.y_tail.imag)):
                rows[k].append(np.asarray(v, np.float32))
            if self._ps_pair[s] >= 0:
                self._ps_readopt(s)
            else:
                v_rows["slot"].append(s)
                v_rows["v_hist"].append(np.asarray(proc.v_hist, np.float32))
            self._sbr_host_states[s] = SP.SBRHostState(
                bw=np.asarray(proc.bw, np.float64).copy(),
                invf_prev=(None if proc.invf_prev is None
                           else np.array(proc.invf_prev)),
                index_noise=proc.index_noise, index_sine=proc.index_sine,
                la_prev=proc.la_prev,
                s_index_prev=(None if proc.s_index_prev is None
                              else np.array(proc.s_index_prev)),
                t_env_last=proc.t_env_last)
            self._sbr_np_procs[s] = None
            self._sbr_np_sticky[s] = False
        with self._on_compute():
            for r in (rows, v_rows):
                if not r["slot"]:
                    continue
                idx = torch.tensor(r["slot"], device=self.device)
                for k in r:
                    if k != "slot":
                        self._sbr_dev_state[k][idx] = torch.from_numpy(
                            np.stack(r[k])).to(self.device)
        self._readopt_blocked = blocked
        return blocked

    def _ps_readopt(self, s: int) -> None:
        """A re-adopted PS slot: its exact rows for its band mode's state
        set, kept as seeds for _ps_mode_begin, and its PSPackState from the
        float64 replay's PSProc."""
        pp, vl, vr = self._ps_np[s]
        m = bool(pp.is34_prev)
        nb, nap, npar = PB._NB[m], PB._NAP[m], PB._NPAR[m]
        self._ps_row_seeds[m][s] = dict(
            v_l=vl, v_r=vr,
            hist4_r=np.stack([pp.in_hist[i][:4].real for i in range(5)], 1),
            hist4_i=np.stack([pp.in_hist[i][:4].imag for i in range(5)], 1),
            delay_r=pp.delay[:nb].real, delay_i=pp.delay[:nb].imag,
            ap_r=pp.ap_delay[:nap].real, ap_i=pp.ap_delay[:nap].imag,
            peak=pp.peak_decay_nrg[:npar], psmooth=pp.power_smooth[:npar],
            pdiff=pp.peak_decay_diff[:npar])
        self._ps_slot_is34[s] = m
        self._ps_pack_states[s] = PP.PSPackState(
            h_prev=pp.h_prev.copy(), ipd_hist=pp.ipd_hist[:17].copy(),
            opd_hist=pp.opd_hist[:17].copy(), ps_prev=pp.ps_prev,
            is34_prev=pp.is34_prev, h_slot_imag=pp.h_slot_imag.copy())
        self._ps_np[s] = None

    def step_he_raw(self, payloads_per_stream: list[list[bytes] | None],
                    compact: bool = True, out_int16: bool = False,
                    mesh=None) -> np.ndarray:
        """Decode one chunk of HE-AAC streams: the core as step_raw does it
        (native parse when built: the C walker records where each frame's
        SBR extension sits, so Python parses only those), then the batched
        SBR stage on the device-resident core PCM.  Returns [C, T, 2F]
        PCM at the 2x output rate: f32 in the 1/32768 scale, or int16 with
        out_int16 when no slot replays on the float64 path this chunk.

        SBR headers are per-slot data, so any mix of headers decodes in the
        one program; a mid-chunk header change replays that slot's chunk on
        the float64 path and re-adopts at the next boundary.  compact: see
        _he_host_phase (the python route ignores it).

        With `mesh` the core step runs sharded (on a mesh with a frame
        axis, each row's frame shards are gathered on its first device),
        then each stream shard's SBR or SBR + PS program on its rows."""
        # a chunk boundary with nothing in flight: re-adopt sticky slots
        self._readopt_sticky()
        mesh = self._mesh(mesh)
        if self.use_native:
            parsed, dense, ctx = self._he_host_phase(payloads_per_stream,
                                                     compact)
            core_pcm = self._device_step(parsed, mesh=mesh)
            return self._sbr_stage(core_pcm, dense, ctx, out_int16, mesh)

        self._sbr_init()
        self._sbr_chunk_begin(payloads_per_stream)
        dense = SP.alloc_dense(self.C, self.T)
        frames_per_stream: list[list | None] = []
        for i, payloads in enumerate(payloads_per_stream):
            if not payloads:
                frames_per_stream.append(None)
                continue
            st = self.streams[i]
            frames = []
            for payload in payloads:
                frame = decode_frame(BitReader(payload), st.config,
                                     st.prev_shapes,
                                     sbr_ctx=self._sbr_ctxs[i])
                self._update_shapes(st, frame)
                st.frames_decoded += 1
                frames.append(frame)
            frames_per_stream.append(frames)
        per_slot, limits = [], []
        for st, frames in zip(self.streams, frames_per_stream):
            if frames:
                per_slot.append((st.base_slot, frames))
                limits.append(st.n_slots)
        batch, flags = pack_frames(per_slot, self.C, self.T, limits,
                                   frame_len=self.F, eld=self._eld)
        core_pcm = self._packed_step(batch, flags, mesh)
        for st, frames in zip(self.streams, frames_per_stream):
            for t, frame in enumerate(frames or []):
                slot = st.base_slot
                for elem in frame.elements:
                    nch = 2 if isinstance(elem, CPEData) else 1
                    sf = getattr(elem, "sbr", None)
                    if sf is not None:
                        self._sbr_pack_payload(dense, sf, slot, nch, t)
                    slot += nch
        return self._sbr_stage(core_pcm, self._stage_dense(dense, False, 0),
                               self._he_ctx(0), out_int16, mesh)

    def decode_he_pipelined(self, chunk_iter, out_int16: bool = True,
                            compact: bool = True, mesh=None):
        """Generator decoding an iterator of HE-AAC payload chunks on the
        native route as a 3-stage pipeline, the HE counterpart of
        decode_pipelined:

            main thread    : host phase of chunk k (core parse, SBR parse,
                             pack)
            upload worker  : copies to the device, core and SBR steps of
                             chunk k-1
            download worker: copy to the host of chunk k-2, float64 replay
                             of sticky slots

        The copies run on their own CUDA streams, the steps on the compute
        stream, ordered by events.  Each chunk's SBR bookkeeping is captured
        into its own context, so the stages share no mutable chunk state.
        Deferred resets and sticky re-adoption happen at a drained chunk
        boundary.  Yields host PCM arrays [C, T, 2F] in chunk order.  With
        `mesh`, the device half runs as step_he_raw(mesh=) runs it."""
        if not self.use_native:
            raise RuntimeError("decode_he_pipelined requires the native "
                               "parser (use step_he_raw)")
        mesh = self._mesh(mesh)

        def host(chunk, slot, k):
            return self._he_host_phase(chunk, compact, buf_slot=slot,
                                       chunk_id=k)

        def upload(phase, k):
            parsed, dense, ctx = phase
            core_pcm = self._spanned("core_step", k, self._device_step,
                                     parsed, mesh=mesh)
            planes = self._spanned("sbr_upload", k, self._sbr_upload, dense,
                                   ctx, mesh)
            pcm2, seeds = self._spanned("sbr_dispatch", k, self._sbr_dispatch,
                                        core_pcm, *planes, ctx, out_int16,
                                        mesh)
            return pcm2, seeds, ctx, core_pcm

        def download(args, k):
            return self._spanned("download", k, self._sbr_download, *args)

        def unsettled():
            # resets and re-adoption touch state both workers use (overlap,
            # SBR device state, replay processors)
            return self._deferred_resets or (
                hasattr(self, "_sbr_np_sticky") and any(
                    self._sbr_np_sticky[s] and s not in self._readopt_blocked
                    for s in range(self.C)))

        def settle():
            self._apply_deferred_resets()
            self._readopt_sticky()

        yield from self._pipeline(chunk_iter, host, upload, download,
                                  unsettled, settle)

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
        history, predictor rows, SBR and PS state, header rows, the PS pair)
        and clears the failure flag.  An optional
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
        # the state's rows are zeroed where they lie, whole or in row blocks
        with self._on_devices(self._dev_streams):
            for part, a, b in meshlib.blocks(self._ov, lo, hi):
                part[a:b] = 0.0
            for part, a, b in meshlib.blocks(self._pred, lo, hi):
                if part is not None:
                    part[a:b] = pred.pred_state_init(b - a, part.device)
            if hasattr(self, "_sbr_ctxs"):
                for d in (self._sbr_dev, *self._ps_dev.values()):
                    for part, a, b in meshlib.blocks(d, lo, hi):
                        for v in (part or {}).values():
                            v[a:b] = 0.0
        if hasattr(self, "_sbr_ctxs"):
            self._sbr_ctxs[idx] = sbrmod.SBRContext(
                sample_rate=2 * st.config.sample_rate)
            for s in range(lo, hi):
                self._sbr_host_states[s] = SP.SBRHostState()
                self._sbr_np_procs[s] = None
                self._sbr_np_sticky[s] = False
                self._readopt_blocked.discard(s)
                self._clear_cfg_row(s)
                self._ps_np[s] = None
                self._ps_pair[s] = -1
                self._ps_slot_is34[s] = None
                for m in (False, True):
                    self._ps_row_seeds[m].pop(s, None)
                self._ps_pack_states[s] = PP.PSPackState()

    # -- state save/restore --------------------------------------------------
    def save_state(self) -> dict:
        """The decoder state at a chunk boundary, as numpy arrays and
        picklable objects: overlap [C,F] ([C,3F] for ELD), prev_shapes [C],
        frames_decoded per stream, pred_state [C,672,6] once a Main-profile
        chunk has run, and once an HE chunk has run the `sbr` dict: the
        device FIFOs (`dev`, with aacjax's names and shapes), the parse
        contexts, the host's sequential state, the float64 processors of
        sticky slots, the per-slot headers, and the Parametric Stereo state
        (the device state per band mode, `ps_dev`, the pack states, pairs,
        band modes and replay state).  The format of aacjax's
        BatchDecoder.save_state."""
        import copy
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
        if hasattr(self, "_sbr_ctxs"):
            out["sbr"] = dict(
                dev={k: v.cpu().numpy().copy()
                     for k, v in self._sbr_dev_state.items()},
                ctxs=copy.deepcopy(self._sbr_ctxs),
                host=copy.deepcopy(self._sbr_host_states),
                procs=copy.deepcopy(self._sbr_np_procs),
                sticky=list(self._sbr_np_sticky),
                slot_hdr=copy.deepcopy(self._slot_sbr_hdr),
                ps_enabled=self._ps_enabled,
                ps_slot_is34=list(self._ps_slot_is34),
                ps_fresh=dict(self._ps_fresh),
                ps_row_seeds=copy.deepcopy(self._ps_row_seeds),
                ps_pair=list(self._ps_pair),
                ps_pack=copy.deepcopy(self._ps_pack_states),
                ps_np=copy.deepcopy(self._ps_np),
                ps_dev={m: (None if d is None else
                            {k: v.cpu().numpy().copy() for k, v in d.items()})
                        for m, d in self._ps_dev_states.items()})
        return out

    def restore_state(self, state: dict) -> None:
        """Inverse of save_state; the decoder must have the same stream
        layout (C, T, frame length).  Host objects are deep-copied, so the
        checkpoint stays reusable.  Also takes the dict aacjax's
        BatchDecoder.save_state returns for the same layout."""
        import copy
        sbr = state.get("sbr")
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
        if sbr is None:
            return
        self._sbr_init()
        with self._on_compute():
            for k, v in sbr["dev"].items():
                want = tuple(self._sbr_dev_state[k].shape)
                if np.shape(v) != want:
                    raise ValueError(f"sbr state {k}: shape {np.shape(v)}, "
                                     f"expected {want}")
                self._sbr_dev_state[k] = torch.from_numpy(
                    np.array(v, np.float32)).to(self.device)
        self._sbr_ctxs = copy.deepcopy(sbr["ctxs"])
        self._sbr_host_states = copy.deepcopy(sbr["host"])
        self._sbr_np_procs = copy.deepcopy(sbr["procs"])
        self._sbr_np_sticky = list(sbr["sticky"])
        # the cfg rows re-render from the restored headers (table identity
        # is process-local)
        self._sbr_cfg_planes = SB.cfg_planes_zeros(self.C)
        self._slot_sbr_key = [None] * self.C
        self._slot_sbr_hdr = [None] * self.C
        self._sbr_cfg_snap = self._sbr_cfg_dev = None
        for st, ctx in zip(self.streams, self._sbr_ctxs):
            for s in range(st.base_slot, st.base_slot + st.n_slots):
                hdr = sbr["slot_hdr"][s]
                if hdr is not None:
                    self._set_cfg_row(s, hdr, sbrmod.derive_tables(
                        hdr, ctx.sample_rate))
        self._readopt_blocked = set()
        self._ps_enabled = sbr["ps_enabled"]
        self._ps_slot_is34 = list(sbr["ps_slot_is34"])
        self._ps_fresh = dict(sbr["ps_fresh"])
        self._ps_row_seeds = copy.deepcopy(sbr["ps_row_seeds"])
        self._ps_pair = list(sbr["ps_pair"])
        self._ps_pack_states = copy.deepcopy(sbr["ps_pack"])
        self._ps_np = copy.deepcopy(sbr["ps_np"])
        with self._on_compute():
            for m, d in sbr["ps_dev"].items():
                if d is None:
                    self._ps_dev_states[m] = None
                    continue
                want = PB.ps_state_init(self.C, m, "cpu")
                for k, v in d.items():
                    if np.shape(v) != tuple(want[k].shape):
                        raise ValueError(
                            f"ps state {k}: shape {np.shape(v)}, expected "
                            f"{tuple(want[k].shape)}")
                self._ps_dev_states[m] = {
                    k: torch.from_numpy(np.array(v, np.float32)).to(
                        self.device) for k, v in d.items()}
        self._ps_dense = (PP.alloc_ps_dense(self.C, self.T)
                          if self._ps_enabled else None)


def _wait(events) -> None:
    """Wait on the host for an event or a list of them (None: nothing)."""
    for ev in (events if isinstance(events, list) else [events]):
        if ev is not None:
            ev.synchronize()


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """t in contiguous pinned host memory (itself when it already is), so
    that a copy to the device can run asynchronously."""
    if t.is_contiguous() and t.is_pinned():
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
