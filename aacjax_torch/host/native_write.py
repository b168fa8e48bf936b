"""ctypes binding to the native bitstream writer (native/libaacwrite.so).

One call writes every frame of a BatchEncoder chunk — codebook
selection, section RLE, scalefactor DPCM and spectral Huffman coding,
multi-threaded across streams — byte-identical to the Python path
(`BatchEncoder._write_stream`), which remains the fallback and the
equality oracle (tests/test_native_write.py).

Falls back cleanly: available() is False when the library hasn't been
built (`make -C native`).
"""
from __future__ import annotations

import ctypes
import os
import pathlib

import numpy as np

_LIB_PATH = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "native" / "libaacwrite.so")

_lib = None
_ABI_VERSION = 1  # must match native aacwrite_version()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    import subprocess
    try:
        subprocess.run(["make", "-C", str(_LIB_PATH.parent), "-s",
                        "libaacwrite.so"],
                       check=False, capture_output=True, timeout=120)
    except Exception:  # noqa: BLE001
        pass
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    if lib.aacwrite_version() != _ABI_VERSION:
        return None
    lib.aacwrite_lc_batch.restype = ctypes.c_int
    lib.aacwrite_lc_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def write_lc_batch(seqs: np.ndarray, q: np.ndarray, sf: np.ndarray,
                   ptr_l: np.ndarray, off_s: np.ndarray,
                   max_sfb_l: int, max_sfb_s: int
                   ) -> list[list[bytes]]:
    """seqs [S, nF] window sequences; q int16 [S, ch, nF, F];
    sf int16 [S, ch, nF, nb].  Returns per-stream raw_data_block
    payload lists (same shape as BatchEncoder._write_stream output)."""
    lib = _load()
    assert lib is not None
    S, ch, nF, F = q.shape
    nb = sf.shape[3]
    seqs32 = np.ascontiguousarray(seqs, np.int32)
    q16 = np.ascontiguousarray(q, np.int16)
    sf16 = np.ascontiguousarray(sf, np.int16)
    ptr32 = np.ascontiguousarray(ptr_l, np.int32)
    offs32 = np.ascontiguousarray(off_s, np.int32)
    # worst-case payload bound: ~49 bits per escape-book pair + side info
    stride = ch * (F * 4 + 1024) + 64
    out = np.empty((S * nF, stride), np.uint8)
    sizes = np.zeros(S * nF, np.int32)
    n_threads = int(os.environ.get("AACJAX_WRITE_THREADS", "0"))
    rc = lib.aacwrite_lc_batch(
        S, ch, nF, F, nb, max_sfb_l, max_sfb_s,
        seqs32.ctypes.data, q16.ctypes.data, sf16.ctypes.data,
        ptr32.ctypes.data, offs32.ctypes.data,
        out.ctypes.data, stride, sizes.ctypes.data, n_threads)
    if rc != 0:
        raise RuntimeError(f"native write failed at frame {-rc - 1}")
    return [[out[s * nF + f, : int(sizes[s * nF + f])].tobytes()
             for f in range(nF)] for s in range(S)]
