"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

The sources under `csrc/` have a plain C interface, so `nvcc` builds them
into one shared library in seconds (no PyTorch headers).  The library lands
in `build/aacjax_torch/` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached file.  Nothing here runs at import time: a machine without
`nvcc` imports every kernel module and uses the plain versions on CPU
tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "aacjax_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
              "--threads", "0"]      # the sources compile side by side

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream are
# c_void_p, every int is c_int, every float c_float; each returns
# cudaGetLastError())
_SIGNATURES = {
    "aacjax_tail": [_P, _P, _I,                 # spec, scale, spec_i16
                    _P, _P, _P, _P, _P, _P,     # f/s/shape/prev idx, short, valid
                    _P, _P,                     # last_valid, overlap_in
                    _P, _P, _P, _P, _P,         # twiddles, f s rise fall
                    _P, _P, _I, _I, _I, _I,     # pcm, ov_out, out_i16, has_short, C, T
                    _P],                        # stream
    "aacjax_synth": [_P, _P, _P, _P, _P, _P,    # spec, f/s/shape/prev idx, short
                     _P, _P, _P, _P, _P,        # twiddles, f s rise fall
                     _P, _P, _I, _P],           # first, second, B, stream
    "aacjax_tns": [_P, _P, _I,                  # x, scale, x_i16
                   _P, _P, _I,                  # fwd lpc, rev lpc, row stride
                   _P, _P, _P, _P, _I, _I,      # fwd/rev start, end; strides
                   _P, _P, _P, _I, _I, _P],     # out, items, counts, rows, F, stream
    "aacjax_pred": [_P, _P, _P, _P, _P,         # spec, mode, reset, nbins, used
                    _P, _P, _I, _I, _I, _P],    # state in, out, C, T, F, stream
    "aacjax_ps_decorrelate": [_P, _P, _P, _P,   # s_r, s_i, delay_r, delay_i
                              _P, _P, _P, _P, _P,   # ap_r, ap_i, peak, psm, pdf
                              _P, _P, _P, _P, _P,   # phi_r, phi_i, qf_r, qf_i, ag
                              _P, _P, _P, _P,       # k_to_i, members, d_r, d_i
                              _P, _P, _P, _P,       # delay, ap out (r, i)
                              _P, _P, _P,           # peak, psm, pdf out
                              _I, _I, _I, _I,       # B, S, nb, npar
                              _I, _I, _I, _P],      # nap, sdb, M, stream
    "aacjax_enc_spread": [_P, _P, _I, _I,       # e, out, N, nb
                          _F, _F, _F, _P],      # up, down, smr, stream
    "aacjax_enc_rate_cost": [_P, _P, _P,        # t34, is_short, regions
                             _P, _P, _P,        # base, fit_sf, zero_sf
                             _P, _P, _P, _P,    # pair table, exp2, offsets, est
                             _I, _I, _I, _I, _P],   # N, Pe, nb, K, stream
}


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaacjax_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, float]:
    """Compile the kernels if the cached library is missing.  Returns the
    library path and the seconds spent compiling (0.0 when cached).
    nvcc's output (ptxas registers, shared memory and spills of every
    kernel) is kept beside the library, in `ptxas_log()`."""
    path = _lib_path()
    if path.exists():
        return path, 0.0
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(looked on PATH and in /usr/local/cuda/bin)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def ptxas_log() -> str:
    """What ptxas reported for the built library ("" before a build)."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built kernel library, with argtypes set for every entry point."""
    path, _ = build()
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


_capture = threading.local()


@contextlib.contextmanager
def capturing(held: list):
    """While this thread captures a CUDA graph (runtime/graphs.py), `launch`
    appends the name of each entry point it calls to `held` instead of
    counting a launch: the graph holds the launch, and each replay counts
    it."""
    _capture.held = held
    try:
        yield
    finally:
        _capture.held = None


def launch(name: str, device: torch.device, *args) -> int:
    """Call entry point `name` with `device` current (the entry points read
    the current device, and their stream argument belongs to `device`);
    raise if the launch reported a CUDA error (at a capture too).  Returns
    the launches to count: 1, or 0 when the call was captured into a
    graph."""
    with torch.cuda.device(device):
        err = getattr(lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    held = getattr(_capture, "held", None)
    if held is None:
        return 1
    held.append(name)
    return 0


def check(t, name: str, dtype, shape: tuple, device, align: int = 4) -> int:
    """Validate a kernel argument (device, type, shape, contiguity and an
    address aligned to `align` bytes); returns its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: address not aligned to {align} bytes")
    return t.data_ptr()


def require_cuda(t, what: str) -> None:
    """Kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (the kernel); anything else is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; expected cpu or cuda")


def indexed(device) -> torch.device:
    """`device` with its index: a bare "cuda" names the current CUDA device,
    which a later `torch.cuda.set_device` changes, so caches and meshes key
    on `cuda:<index>` instead."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def per_device(fn):
    """`functools.lru_cache` for a function of constants on a device: every
    `torch.device` argument is keyed by its indexed form (`indexed`)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args = tuple(indexed(a) if isinstance(a, torch.device) else a
                     for a in args)
        kwargs = {k: indexed(v) if isinstance(v, torch.device) else v
                  for k, v in kwargs.items()}
        return cached(*args, **kwargs)

    return wrapper
