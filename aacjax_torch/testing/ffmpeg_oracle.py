"""ctypes wrapper for the FFmpeg conformance oracle (test-only).

Provides an *independent industry decoder* (libavcodec) to validate
aacjax's whole stack end-to-end, plus FFmpeg's real AAC encoder to build
corpora with production codebook/window statistics.  The aacjax decode
path never touches FFmpeg; this exists only under aacjax.testing.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB_PATH = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "native" / "libfforacle.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.ffdec_decode_adts.restype = ctypes.c_int64
    lib.ffdec_decode_adts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "ffdec_decode_loas"):
        lib.ffdec_decode_loas.restype = ctypes.c_int64
        lib.ffdec_decode_loas.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "ffdec_decode_raw"):
        lib.ffdec_decode_raw.restype = ctypes.c_int64
        lib.ffdec_decode_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.ffenc_encode_aac.restype = ctypes.c_int64
    lib.ffenc_encode_aac.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_adts(data: bytes) -> tuple[np.ndarray, int]:
    """FFmpeg-decode an ADTS stream -> (pcm [n, ch] float32 in ±1 scale,
    sample_rate)."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    cap = len(data) * 64 + (1 << 20)
    out = np.zeros(cap, np.float32)
    ch = np.zeros(1, np.int32)
    rate = np.zeros(1, np.int32)
    n = lib.ffdec_decode_adts(_ptr(buf), len(data), _ptr(out), cap,
                              _ptr(ch), _ptr(rate))
    if n < 0:
        raise RuntimeError(f"ffmpeg decode failed: {n}")
    nch = int(ch[0])
    return out[:n * nch].reshape(-1, nch).copy(), int(rate[0])


def decode_loas(data: bytes) -> tuple[np.ndarray, int]:
    """FFmpeg-decode a LOAS/LATM stream -> (pcm [n, ch] float32, rate)."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    cap = len(data) * 64 + (1 << 20)
    out = np.zeros(cap, np.float32)
    ch = np.zeros(1, np.int32)
    rate = np.zeros(1, np.int32)
    n = lib.ffdec_decode_loas(_ptr(buf), len(data), _ptr(out), cap,
                              _ptr(ch), _ptr(rate))
    if n < 0:
        raise RuntimeError(f"ffmpeg LATM decode failed: {n}")
    nch = int(ch[0])
    return out[:n * nch].reshape(-1, nch).copy(), int(rate[0])


def decode_raw(asc: bytes, payloads: list[bytes]) -> tuple[np.ndarray, int]:
    """FFmpeg-decode raw raw_data_block packets with an explicit ASC
    (for modes ADTS cannot signal: 960-sample frames, explicit SBR)."""
    lib = _load()
    if not hasattr(lib, "ffdec_decode_raw"):
        raise RuntimeError("oracle built without ffdec_decode_raw")
    blob = b"".join(payloads)
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    offsets = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offsets[1:])
    asc_buf = np.frombuffer(asc, np.uint8)
    cap = len(blob) * 64 + (1 << 20)
    out = np.zeros(cap, np.float32)
    ch = np.zeros(1, np.int32)
    rate = np.zeros(1, np.int32)
    n = lib.ffdec_decode_raw(_ptr(asc_buf), len(asc), _ptr(buf),
                             _ptr(offsets), len(payloads), _ptr(out), cap,
                             _ptr(ch), _ptr(rate))
    if n < 0:
        raise RuntimeError(f"ffmpeg raw decode failed: {n}")
    nch = int(ch[0])
    return out[:n * nch].reshape(-1, nch).copy(), int(rate[0])


def encode_adts(pcm: np.ndarray, sample_rate: int, bit_rate: int = 192_000,
                opts: str = "") -> bytes:
    """Encode interleaved float PCM (±1 scale) with FFmpeg's native AAC
    encoder and wrap the packets in ADTS headers.

    opts: encoder tool switches like "aac_pns=0:aac_tns=1" — conformance
    tests disable PNS because its noise is decoder-specific by design.
    """
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.testing.encoder import adts_frame
    from aacjax_torch import tables

    lib = _load()
    n, ch = pcm.shape
    flat = np.ascontiguousarray(pcm, np.float32)
    out = np.zeros(n * ch * 8 + (1 << 20), np.uint8)
    sizes = np.zeros(4096, np.int32)
    npkts = lib.ffenc_encode_aac(_ptr(flat), n, ch, sample_rate, bit_rate,
                                 opts.encode(), _ptr(out), len(out),
                                 _ptr(sizes), len(sizes))
    if npkts < 0:
        raise RuntimeError(f"ffmpeg encode failed: {npkts}")
    si = int(np.where(tables.SAMPLE_RATES == sample_rate)[0][0])
    config = parse_asc(make_asc(2, si, ch))
    stream = bytearray()
    pos = 0
    for i in range(int(npkts)):
        sz = int(sizes[i])
        stream += adts_frame(bytes(out[pos:pos + sz]), config)
        pos += sz
    return bytes(stream)
