"""ctypes binding to the port's native parser
(aacjax_torch/native/libaacparse.so, the port's copy of native/aacparse.cc
whose parse also writes the block-scaled int16 spectra).

One call parses every stream of a chunk and writes directly into the
caller's [C, T, ...] batch buffers (zero copies); the call releases the
GIL.

Falls back cleanly: available() is False when the library hasn't been
built (`make -C aacjax_torch/native`); a stream that needs features the
native path delegates (CCE elements) gets status ERR_FALLBACK and the
runtime reparses the chunk with the Python parser.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB_PATH = (pathlib.Path(__file__).resolve().parent.parent
             / "native" / "libaacparse.so")

FRAME = 1024
TNS_SLOTS = 8
TNS_ORDER = 20

ERR_OK = 0
ERR_BITSTREAM = 1
ERR_UNSUPPORTED = 2
ERR_FALLBACK = 3       # capacity limit: caller must raise a knob
ERR_BOUNDS = 4
ERR_DELEGATE = 5       # legal content the fast path delegates: the
                       # runtime redoes the chunk on the python path


class NativeParseError(Exception):
    def __init__(self, code: int, msg: str, frame: int):
        super().__init__(f"frame {frame}: {msg}")
        self.code = code
        self.frame = frame


_lib = None
_ABI_VERSION = 12  # must match native aacparse_version()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # best-effort (re)build: a no-op when libaacparse.so is newer than its
    # sources, builds it on fresh checkouts, and refreshes a stale .so
    # after a source update (the binding checks the ABI version below)
    import subprocess
    try:
        subprocess.run(["make", "-C", str(_LIB_PATH.parent), "-s",
                        "libaacparse.so"],
                       check=False, capture_output=True, timeout=120)
    except Exception:  # noqa: BLE001
        pass
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    if lib.aacparse_version() != _ABI_VERSION:
        return None  # stale binary that make could not refresh
    lib.aacjax_spec_to_i16.restype = None
    lib.aacjax_spec_to_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.aacparse_batch_spec.restype = ctypes.c_int
    lib.aacparse_batch_spec.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_void_p, ctypes.c_int,                     # profiles, F
        ctypes.c_void_p, ctypes.c_void_p,                  # swb long
        ctypes.c_void_p, ctypes.c_void_p,                  # swb short
        ctypes.c_void_p,                                   # tns max
        ctypes.c_void_p,                                   # pred sfb max
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # cce post
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # cce time
        ctypes.c_void_p,                                   # cce counts
        ctypes.c_void_p,                                   # consumed bits
        ctypes.c_void_p,                                   # fil sbr records
        ctypes.c_void_p,                                   # fil drc records
        ctypes.c_void_p, ctypes.c_void_p,                  # status, has_tns
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q/sf/ok
        ctypes.c_void_p, ctypes.c_void_p,                  # pred meta/used
        ctypes.c_void_p, ctypes.c_void_p,                  # ltp meta/used
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,                  # i16 / scales
        ctypes.c_void_p,                                   # parse counts
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray):
    assert arr.flags["C_CONTIGUOUS"], "array must be contiguous"
    return arr.ctypes.data_as(ctypes.c_void_p)


class SpecBatchArrays:
    """Dense outputs for the fused host-prep path, whole batch at once."""

    def __init__(self, C: int, T: int, F: int = FRAME):
        self.C, self.T, self.F = C, T, F
        self.spec = np.zeros((C, T, F), np.float32)
        self.meta = np.zeros((C, T, 6), np.int32)
        self.tns_lpc = np.zeros((C, T, 2, TNS_SLOTS, TNS_ORDER), np.float32)
        self.tns_range = np.zeros((C, T, 2, TNS_SLOTS, 2), np.int32)
        # device-side coupling entries (AFTER_TNS onto TNS'd targets needs
        # the device pass; AFTER_IMDCT couples time samples)
        self.post_cap = 64
        self.time_cap = max(64, C * T)
        self.cce_post_idx = np.zeros((self.post_cap, 3), np.int32)
        self.cce_post_gain = np.zeros((self.post_cap, F), np.float32)
        self.cce_time_idx = np.zeros((self.time_cap, 3), np.int32)
        self.cce_time_gain = np.zeros(self.time_cap, np.float32)
        self.cce_counts = np.zeros(2, np.int32)
        self.consumed_bits: np.ndarray | None = None  # set per parse call
        # compact-transfer buffers (allocated on first use)
        self.spec_i16: np.ndarray | None = None
        self.spec_scale: np.ndarray | None = None
        # exact-i16 q/sf transfer buffers (allocated on first use)
        self.spec_q: np.ndarray | None = None
        self.spec_sf: np.ndarray | None = None
        self.qsf_ok: np.ndarray | None = None  # [n_streams] of last parse
        # Main-profile predictor / AAC-LTP side-info planes (on first use)
        self.pred_meta: np.ndarray | None = None
        self.pred_used: np.ndarray | None = None
        self.ltp_meta: np.ndarray | None = None
        self.ltp_used: np.ndarray | None = None

    def ensure_qsf(self) -> None:
        if self.spec_q is None:
            self.spec_q = np.zeros((self.C, self.T, self.F), np.int16)
            self.spec_sf = np.zeros((self.C, self.T, self.F // 4), np.uint8)

    def ensure_pred(self) -> None:
        if self.pred_meta is None:
            self.pred_meta = np.zeros((self.C, self.T, 3), np.int32)
            self.pred_used = np.zeros((self.C, self.T, 672), np.uint8)

    def ensure_ltp(self) -> None:
        if self.ltp_meta is None:
            self.ltp_meta = np.zeros((self.C, self.T, 3), np.int32)
            self.ltp_used = np.zeros((self.C, self.T, 40), np.uint8)


def stream_tables(configs) -> dict:
    """Per-stream parse tables for parse_batch_spec, resolved from the
    frozen StreamConfigs (frame-length aware: 1024/960/512/480).  The
    native parser takes these instead of re-deriving tables from the
    sample index, so every profile's SWB layout and TNS clamps match the
    python parser exactly."""
    from aacjax_torch import tables as T
    n = len(configs)
    swb_long = np.zeros((n, 64), np.int32)
    swb_long_count = np.zeros(n, np.int32)
    swb_short = np.zeros((n, 20), np.int32)
    swb_short_count = np.zeros(n, np.int32)
    tns_max = np.zeros((n, 2), np.int32)
    profiles = np.zeros(n, np.int32)
    pred_sfb = np.zeros(n, np.int32)
    for i, cfg in enumerate(configs):
        profiles[i] = cfg.profile
        if cfg.profile == 1:  # Main: predictor sfb cap (Table 4.128)
            pred_sfb[i] = cfg.pred_sfb_max
        lo = cfg.swb_offsets_long
        nl = cfg.swb_count_long
        swb_long[i, :nl + 1] = lo[:nl + 1]
        swb_long_count[i] = nl
        if cfg.frame_length in (1024, 960):  # short windows exist
            so = cfg.swb_offsets_short
            ns = cfg.swb_count_short
            swb_short[i, :ns + 1] = so[:ns + 1]
            swb_short_count[i] = ns
            tns_max[i, 0] = int(T.TNS_MAX_BANDS_1024[cfg.sample_index])
            tns_max[i, 1] = int(T.TNS_MAX_BANDS_128[cfg.sample_index])
        else:  # LD / ELD
            tns_max[i, 0] = cfg.tns_max_bands_ld
            tns_max[i, 1] = 0
    return dict(profiles=profiles, swb_long=swb_long,
                swb_long_count=swb_long_count, swb_short=swb_short,
                swb_short_count=swb_short_count, tns_max=tns_max,
                pred_sfb=pred_sfb,
                frame_len=int(configs[0].frame_length) if configs else FRAME)


def parse_batch_spec(payloads_per_stream: list[list[bytes] | None],
                     sample_indices: np.ndarray, chan_configs: np.ndarray,
                     base_slots: np.ndarray, n_slots: np.ndarray,
                     prev_shapes: np.ndarray,
                     out: SpecBatchArrays,
                     tables_pack: dict | None = None,
                     want_qsf: bool = False,
                     want_pred: bool = False,
                     want_ltp: bool = False,
                     want_i16: bool = False,
                     counts: np.ndarray | None = None
                     ) -> tuple[np.ndarray, bool]:
    """One C call parsing every stream's chunk into final f32 spectra.

    tables_pack: stream_tables(configs) output — per-stream profile, SWB
    and TNS tables.  Defaults to plain AAC-LC at 1024 derived from the
    sample indices (the historical behavior).

    want_qsf=True additionally fills out.spec_q / out.spec_sf with the
    exact-i16 spectral representation (raw quantized coefficients +
    8-bit scalefactor index per 4-bin group) and sets out.qsf_ok[s]=1
    for every stream whose whole chunk rode it — those streams can skip
    the f32 spectra on H2D and dequantize on-device bit-exactly (the
    HE-AAC fast path, where block-scaled i16 would lose precision on
    near-empty patch source bands).

    want_i16=True also fills out.spec_i16 / out.spec_scale with what
    compact_spec(out) would give, each stream's rows converted by the
    parse thread that wrote them.

    counts (int64 [5], optional) receives the parse's band
    counts (bands decoded straight into the f32 rows, bands on the
    general path, scale-factor gains that missed the table), the workers
    of its pool that took streams (the calling thread included) and the
    nanoseconds from the last streams handed out to the last worker
    done.

    Returns (stream_status [n_streams] int32, has_tns).  Status 0 = ok,
    3 = needs Python fallback (capacity overflow), other nonzero = the
    stream hit a bitstream error: the corrupt frame is concealed as
    silence and the remaining frames still decode (see aacparse.cc)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not built "
                           "(make -C aacjax_torch/native)")
    if counts is not None and (counts.shape != (5,)
                               or counts.dtype != np.int64):
        raise ValueError("counts must be int64 [5]")
    n_streams = len(payloads_per_stream)
    if tables_pack is None:
        from aacjax_torch.host.asc import StreamConfig
        from aacjax_torch import tables as T
        tables_pack = stream_tables([
            StreamConfig(profile=2, sample_index=int(si),
                         sample_rate=int(T.SAMPLE_RATES[int(si)]),
                         chan_config=int(cc))
            for si, cc in zip(sample_indices, chan_configs)])
    parts: list[bytes] = []
    frame_lens: list[int] = []
    stream_frame_start = np.zeros(n_streams + 1, np.int32)
    for i, payloads in enumerate(payloads_per_stream):
        payloads = payloads or []
        parts.extend(payloads)
        frame_lens.extend(len(p) for p in payloads)
        stream_frame_start[i + 1] = len(parts)
    blob = b"".join(parts)
    frame_offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum(frame_lens, out=frame_offsets[1:])
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)

    status = np.zeros(n_streams, np.int32)
    has_tns = np.zeros(1, np.int32)
    qsf_ok = np.zeros(n_streams, np.int32)
    if want_qsf:
        out.ensure_qsf()
    if want_pred:
        out.ensure_pred()
    if want_ltp:
        out.ensure_ltp()
    if want_i16 and out.spec_i16 is None:
        out.spec_i16 = np.zeros((out.C, out.T, out.F), np.int16)
        out.spec_scale = np.zeros((out.C, out.T, out.F // I16_BLOCK),
                                  np.float32)
    consumed = np.zeros(max(len(parts), 1), np.int64)
    fil_sbr = np.zeros((max(len(parts), 1), 4, 3), np.int64)
    fil_drc = np.zeros(max(len(parts), 1), np.int64)
    errbuf = ctypes.create_string_buffer(256)
    tp = tables_pack
    code = lib.aacparse_batch_spec(
        _ptr(buf), _ptr(frame_offsets), _ptr(stream_frame_start),
        _ptr(np.ascontiguousarray(sample_indices, np.int32)),
        _ptr(np.ascontiguousarray(chan_configs, np.int32)),
        _ptr(np.ascontiguousarray(base_slots, np.int32)),
        _ptr(np.ascontiguousarray(n_slots, np.int32)),
        _ptr(tp["profiles"]), int(tp["frame_len"]),
        _ptr(tp["swb_long"]), _ptr(tp["swb_long_count"]),
        _ptr(tp["swb_short"]), _ptr(tp["swb_short_count"]),
        _ptr(tp["tns_max"]),
        _ptr(tp["pred_sfb"]) if "pred_sfb" in tp else ctypes.c_void_p(0),
        n_streams, out.C, out.T,
        _ptr(prev_shapes),
        _ptr(out.spec), _ptr(out.meta), _ptr(out.tns_lpc), _ptr(out.tns_range),
        _ptr(out.cce_post_idx), _ptr(out.cce_post_gain), out.post_cap,
        _ptr(out.cce_time_idx), _ptr(out.cce_time_gain), out.time_cap,
        _ptr(out.cce_counts),
        _ptr(consumed),
        _ptr(fil_sbr), _ptr(fil_drc),
        _ptr(status), _ptr(has_tns),
        # exact-i16 q/sf outputs, nullable (emit_qsf in aacparse.cc)
        _ptr(out.spec_q) if want_qsf else ctypes.c_void_p(0),
        _ptr(out.spec_sf) if want_qsf else ctypes.c_void_p(0),
        _ptr(qsf_ok) if want_qsf else ctypes.c_void_p(0),
        # Main-profile predictor / LTP side-info planes, nullable
        _ptr(out.pred_meta) if want_pred else ctypes.c_void_p(0),
        _ptr(out.pred_used) if want_pred else ctypes.c_void_p(0),
        _ptr(out.ltp_meta) if want_ltp else ctypes.c_void_p(0),
        _ptr(out.ltp_used) if want_ltp else ctypes.c_void_p(0),
        errbuf, len(errbuf),
        _ptr(out.spec_i16) if want_i16 else ctypes.c_void_p(0),
        _ptr(out.spec_scale) if want_i16 else ctypes.c_void_p(0),
        _ptr(counts) if counts is not None else ctypes.c_void_p(0))
    if code != ERR_OK:
        raise NativeParseError(code, errbuf.value.decode(), -1)
    out.qsf_ok = qsf_ok if want_qsf else None
    out.consumed_bits = consumed  # per successful global frame index
    out.fil_sbr = fil_sbr         # SBR FIL records per global frame index
    out.fil_drc = fil_drc         # DRC FIL bit offsets per global frame
    return status, bool(has_tns[0]), errbuf.value.decode()


I16_BLOCK = 16  # bins per compact-transfer scale block (native kI16Block)


def compact_spec(out: SpecBatchArrays) -> tuple[np.ndarray, np.ndarray]:
    """Convert out.spec to block-scaled int16 fixed point (compact
    transfer mode): returns (spec_i16 [C,T,F],
    spec_scale [C,T,F/16] f32 — one scale per 16-bin block).  Quantization
    tracks the spectral envelope (~>90 dB decoded SNR); ~44% fewer
    spectral H2D bytes."""
    lib = _load()
    if out.spec_i16 is None:
        out.spec_i16 = np.zeros((out.C, out.T, out.F), np.int16)
        out.spec_scale = np.zeros((out.C, out.T, out.F // I16_BLOCK),
                                  np.float32)
    lib.aacjax_spec_to_i16(_ptr(out.spec), out.C * out.T, out.F,
                           _ptr(out.spec_i16), _ptr(out.spec_scale))
    return out.spec_i16, out.spec_scale
