"""TNS (temporal noise shaping) along the spectral bins, with a CUDA kernel.

Counterpart of `aacjax/kernels/pipeline.py` `tns` / `_tns_directional_scan`
(an XLA `lax.scan` in the reference).  `tns` runs `csrc/tns.cu` on CUDA
tensors and `tns_ref`, its plain PyTorch version, on CPU tensors.

Both compute y[n] = x[n] - sum_i lpc_n[i] * y[n-1-i] (order <= 20, up to 8
filters per direction, taps masked to the active filter's range), forward
and on the reversed spectrum, in compensated float-float arithmetic: the
recursion state is an f32 hi + lo pair, products split exactly by mantissa
masking (TwoProd), sums by Knuth TwoSum.  That keeps high-gain order-12..20
filters at fp64-class accuracy, where a plain f32 recursion drifts ~1e-3
full scale.
"""
from __future__ import annotations

import torch

from aacjax_torch.kernels import _build

FRAME = 1024
SLOTS = 8
ORDER = 20

launches = 0    # kernel launches since the last reset

_HI_MASK = -4096  # 0xFFFFF000 as int32: the top 12 mantissa bits


def _split_hi(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) & _HI_MASK).view(torch.float32)


def _two_prod(a, b):
    """a*b = p + e exactly (f32 pair)."""
    p = a * b
    a_hi = _split_hi(a)
    a_lo = a - a_hi
    b_hi = _split_hi(b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _two_sum(a, b):
    """a+b = s + e exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _directional_scan(x, lpc, start, end):
    """The recurrence over x [B,F] in one direction; lpc [B,S,20],
    start/end [B,S].  Only the bins [min start, max end) of any filter are
    scanned: before a filter starts its taps are masked, and outside every
    filter the output is not used."""
    B, F = x.shape
    used = start < end
    y = x.clone()
    if not bool(used.any()):
        return y
    lo = int(start[used].min())
    hi = min(int(end[used].max()), F)
    lags = torch.arange(1, ORDER + 1, dtype=torch.int32, device=x.device)
    hist_hi = torch.zeros((B, ORDER), dtype=x.dtype, device=x.device)
    hist_lo = torch.zeros_like(hist_hi)
    for n in range(lo, hi):
        active = (start <= n) & (n < end)                          # [B,S]
        lpc_n = torch.einsum("bs,bso->bo", active.to(x.dtype), lpc)
        start_n = torch.where(active, start, 0).sum(dim=1)
        tap_ok = ((n - lags[None, :]) >= start_n[:, None]).to(x.dtype)
        c = lpc_n * tap_ok
        p_hi, p_lo = _two_prod(c, hist_hi)                         # [B,20]
        p_lo = p_lo + c * hist_lo
        s, e = -p_hi[:, 0], -p_lo[:, 0]
        for i in range(1, ORDER):
            s, e2 = _two_sum(s, -p_hi[:, i])
            e = e + e2 - p_lo[:, i]
        y_hi, e2 = _two_sum(x[:, n], s)
        y_hi, y_lo = _two_sum(y_hi, e + e2)
        hist_hi = torch.cat([y_hi[:, None], hist_hi[:, :-1]], dim=1)
        hist_lo = torch.cat([y_lo[:, None], hist_lo[:, :-1]], dim=1)
        y[:, n] = y_hi
    return y


def tns_ref(spec, fwd_lpc, fwd_start, fwd_end, rev_lpc, rev_start, rev_end):
    """Plain PyTorch TNS.  spec [C,T,F]; lpc [C,T,8,20]; start/end [C,T,8]
    (reverse ranges in flipped coordinates: start' = F - end)."""
    C, T, F = spec.shape
    x = spec.reshape(C * T, F)

    def flat(a):
        return a.reshape((C * T,) + tuple(a.shape[2:]))

    y_f = _directional_scan(x, flat(fwd_lpc), flat(fwd_start), flat(fwd_end))
    y_r = _directional_scan(x.flip(1), flat(rev_lpc), flat(rev_start),
                            flat(rev_end)).flip(1)
    ns = torch.arange(F, dtype=torch.int32, device=spec.device)[None, None]
    fwd_cover = ((flat(fwd_start)[..., None] <= ns)
                 & (ns < flat(fwd_end)[..., None])).any(dim=1)
    rev_s = F - flat(rev_end)
    rev_e = F - flat(rev_start)
    rev_cover = ((rev_s[..., None] <= ns) & (ns < rev_e[..., None])).any(dim=1)
    out = torch.where(fwd_cover, y_f, x)
    out = torch.where(rev_cover, y_r, out)
    return out.reshape(C, T, F)


def tns(spec, fwd_lpc, fwd_start, fwd_end, rev_lpc, rev_start, rev_end):
    """TNS over a [C,T,1024] f32 chunk: lpc f32 [C,T,8,20], start/end int32
    [C,T,8] per direction.  Returns the filtered spectra [C,T,1024]."""
    args = (spec, fwd_lpc, fwd_start, fwd_end, rev_lpc, rev_start, rev_end)
    if spec.device.type == "cpu":
        return tns_ref(*args)
    _build.require_cuda(spec, "tns")
    global launches
    C, T, F = spec.shape
    dev = spec.device
    ck = _build.check
    ptrs = [ck(spec, "spec", torch.float32, (C, T, FRAME), dev)]
    for d in ("fwd", "rev"):
        lpc, st, en = (args[1:4] if d == "fwd" else args[4:7])
        ptrs += [ck(lpc, f"{d}_lpc", torch.float32, (C, T, SLOTS, ORDER), dev),
                 ck(st, f"{d}_start", torch.int32, (C, T, SLOTS), dev),
                 ck(en, f"{d}_end", torch.int32, (C, T, SLOTS), dev)]
    out = torch.empty_like(spec)
    _build.launch("aacjax_tns", *ptrs, out.data_ptr(), C * T,
                  torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
