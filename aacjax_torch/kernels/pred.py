"""Main-profile backward prediction, with a CUDA kernel.

Counterpart of `aacjax/kernels/pipeline.py` `apply_prediction` (an XLA
`lax.scan` over the frame axis in the reference; it has no Pallas kernel).
`apply_prediction` runs `csrc/pred.cu` on CUDA tensors and its plain
PyTorch version, `apply_prediction_ref` (a Python loop over the frames),
on CPU tensors.

Per spectral bin k < 672 a second-order backward-adaptive lattice
predictor (ISO/IEC 14496-3 4.6.2, with libavcodec's numerics) whose six
state values (r0, r1, cor0, cor1, var0, var1) are rounded to a 16-bit
mantissa after every frame, so that independent decoders stay in step bit
for bit.  Every product, sum and quotient is a single f32 operation,
rounded on its own: the kernel writes each with __fmul_rn / __fadd_rn /
__fsub_rn / __fdiv_rn (nvcc would otherwise contract a*b + c*d into an
FMA), and so computes the plain version's bits, step for step.

Per frame (c, t): mode 0 leaves the state alone, mode 1 (a long Main
frame) adds the prediction to the bins whose `used` bit is set and updates
the state of every bin k < nbins, used or not, and mode 2 (EIGHT_SHORT)
resets every bin.  The reset of group rg > 0 (bins with k % 30 == rg - 1)
and the reset of mode 2 apply after the frame's update: var0 / var1 to 1,
the rest to 0.
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.kernels import _build
from aacjax_torch.kernels.pipeline import PRED_BINS

_A = 0.953125        # 61/64
_ALPHA = 0.90625     # 29/32

launches = 0    # kernel launches since the last reset


def pred_state_init(C: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """A fresh predictor state [C, 672, 6]: var0 / var1 start at 1."""
    st = torch.zeros((C, PRED_BINS, 6), dtype=torch.float32, device=device)
    st[..., 4:] = 1.0
    return st


def _flt16(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Rounding of an f32 to a 16-bit mantissa (libavcodec's flt16_round /
    flt16_even / flt16_trunc), on int32 views: the wrap-around of int32
    gives the bits of the reference's uint32 arithmetic."""
    b = x.view(torch.int32)
    if mode == "round":
        b = (b + 0x8000) & -65536
    elif mode == "even":
        b = (b + 0x7FFF + ((b >> 16) & 1)) & -65536
    else:  # trunc
        b = b & -65536
    return b.view(torch.float32)


def apply_prediction_ref(spec, mode, reset, nbins, used, state):
    """Plain PyTorch version.  spec f32 [C,T,F] (post-M/S); mode, reset,
    nbins integer [C,T]; used [C,T,672] (nonzero = predicted; uint8 or
    float); state f32 [C,672,6].  Returns (new spectra, new state); no
    argument is changed."""
    C, T, F = spec.shape
    dev = spec.device
    kvec = torch.arange(PRED_BINS, device=dev)
    a = torch.tensor(_A, dtype=torch.float32, device=dev)
    al = torch.tensor(_ALPHA, dtype=torch.float32, device=dev)
    half = torch.tensor(0.5, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    r0, r1, cor0, cor1, var0, var1 = state.unbind(-1)
    out = spec.clone()
    for t in range(T):
        s_t = spec[:, t, :PRED_BINS]
        k1 = torch.where(var0 > 1.0, cor0 * _flt16(a / var0, "even"), zero)
        k2 = torch.where(var1 > 1.0, cor1 * _flt16(a / var1, "even"), zero)
        pv = _flt16(k1 * r0 + k2 * r1, "round")
        long_f = (mode[:, t] == 1)[:, None]
        coef = s_t + pv * ((used[:, t] != 0) & long_f).to(torch.float32)
        e0 = coef
        e1 = e0 - k1 * r0
        cor1n = _flt16(al * cor1 + r1 * e1, "trunc")
        var1n = _flt16(al * var1 + half * (r1 * r1 + e1 * e1), "trunc")
        cor0n = _flt16(al * cor0 + r0 * e0, "trunc")
        var0n = _flt16(al * var0 + half * (r0 * r0 + e0 * e0), "trunc")
        r1n = _flt16(a * (r0 - k1 * e0), "trunc")
        r0n = _flt16(a * e0, "trunc")
        # the state moves only on long Main frames, below the frame's bound
        upd = long_f & (kvec[None, :] < nbins[:, t, None])
        # a group's reset applies after the frame; a short frame resets all
        rg = reset[:, t, None]
        rm = (((kvec[None, :] % 30) == (rg - 1)) & (rg > 0) & long_f) | (
            mode[:, t] == 2)[:, None]

        def sel(new, old, init):
            return torch.where(rm, zero + init, torch.where(upd, new, old))

        r0, r1 = sel(r0n, r0, 0.0), sel(r1n, r1, 0.0)
        cor0, cor1 = sel(cor0n, cor0, 0.0), sel(cor1n, cor1, 0.0)
        var0, var1 = sel(var0n, var0, 1.0), sel(var1n, var1, 1.0)
        out[:, t, :PRED_BINS] = coef
    return out, torch.stack([r0, r1, cor0, cor1, var0, var1], dim=-1)


def apply_prediction(spec, mode, reset, nbins, used, state,
                     inplace: bool = False):
    """Backward prediction over a [C,T,F] chunk (F >= 672): spec f32; mode,
    reset, nbins int32 [C,T]; used uint8 [C,T,672]; state f32 [C,672,6].
    Returns (spectra, new state [C,672,6]).  With inplace=True the kernel
    writes the bins k < 672 into `spec` itself and returns it (the bins
    above are never touched); otherwise it works on a copy.  `state` is
    left as it was."""
    args = (spec, mode, reset, nbins, used, state)
    if spec.device.type == "cpu":
        return apply_prediction_ref(*args)
    _build.require_cuda(spec, "apply_prediction")
    global launches
    if spec.dim() != 3 or spec.shape[-1] < PRED_BINS:
        raise ValueError(f"spec: shape {tuple(spec.shape)}, expected [C,T,F] "
                         f"with F >= {PRED_BINS}")
    C, T, F = spec.shape
    dev = spec.device
    ck = _build.check
    ck(spec, "spec", torch.float32, (C, T, F), dev)
    out = spec if inplace else spec.clone()
    ptrs = [out.data_ptr()]
    for name, a in zip(("mode", "reset", "nbins"), args[1:4]):
        ptrs.append(ck(a, name, torch.int32, (C, T), dev))
    ptrs.append(ck(used, "used", torch.uint8, (C, T, PRED_BINS), dev, align=1))
    ptrs.append(ck(state, "state", torch.float32, (C, PRED_BINS, 6), dev,
                   align=8))
    new_state = torch.empty_like(state)
    launches += _build.launch("aacjax_pred", dev, *ptrs,
                              new_state.data_ptr(), C, T, F,
                              torch.cuda.current_stream(dev).cuda_stream)
    return out, new_state


# -- what the kernel computes, in numpy -----------------------------------------
def _flt16_np(x: np.ndarray, mode: str) -> np.ndarray:
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if mode == "round":
        b = (b + np.uint32(0x8000)) & np.uint32(0xFFFF0000)
    elif mode == "even":
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
             ) & np.uint32(0xFFFF0000)
    else:
        b = b & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def model(spec, mode, reset, nbins, used, state):
    """The kernel's loop in numpy, one bin at a time as a thread runs it:
    for each (c, k) the six state values stay in scalars over the T frames,
    every operation a single f32 operation in the kernel's order, resets
    after the update, the state written once at the end.  Arrays in,
    (spectra, state) out; for small inputs (a Python loop per bin)."""
    spec = np.array(spec, np.float32)
    state = np.array(state, np.float32)
    C, T, _ = spec.shape
    f32 = np.float32
    a, al, half = f32(_A), f32(_ALPHA), f32(0.5)

    def rnd(x, how):
        return _flt16_np(np.array([x], np.float32), how)[0]

    with np.errstate(all="ignore"):
        for c in range(C):
            for k in range(PRED_BINS):
                r0, r1, cor0, cor1, var0, var1 = (f32(v) for v in state[c, k])
                for t in range(T):
                    m, rg = int(mode[c, t]), int(reset[c, t])
                    k1 = (cor0 * rnd(a / var0, "even")
                          if var0 > 1.0 else f32(0.0))
                    k2 = (cor1 * rnd(a / var1, "even")
                          if var1 > 1.0 else f32(0.0))
                    pv = rnd(f32(k1 * r0) + f32(k2 * r1), "round")
                    u = f32(1.0 if (used[c, t, k] != 0 and m == 1) else 0.0)
                    e0 = f32(spec[c, t, k] + f32(pv * u))
                    spec[c, t, k] = e0
                    if m == 1 and k < int(nbins[c, t]):
                        e1 = f32(e0 - f32(k1 * r0))
                        n_cor1 = rnd(f32(al * cor1) + f32(r1 * e1), "trunc")
                        n_var1 = rnd(f32(al * var1) + f32(half * f32(
                            f32(r1 * r1) + f32(e1 * e1))), "trunc")
                        n_cor0 = rnd(f32(al * cor0) + f32(r0 * e0), "trunc")
                        n_var0 = rnd(f32(al * var0) + f32(half * f32(
                            f32(r0 * r0) + f32(e0 * e0))), "trunc")
                        n_r1 = rnd(f32(a * f32(r0 - f32(k1 * e0))), "trunc")
                        n_r0 = rnd(f32(a * e0), "trunc")
                        r0, r1, cor0, cor1, var0, var1 = (
                            f32(v) for v in (n_r0, n_r1, n_cor0, n_cor1,
                                             n_var0, n_var1))
                    if m == 2 or (m == 1 and rg > 0 and k % 30 == rg - 1):
                        r0 = r1 = cor0 = cor1 = f32(0.0)
                        var0 = var1 = f32(1.0)
                state[c, k] = (r0, r1, cor0, cor1, var0, var1)
    return spec, state
