"""TNS (temporal noise shaping) along the spectral bins, with a CUDA kernel.

Counterpart of `aacjax/kernels/pipeline.py` `tns` / `_tns_directional_scan`
(an XLA `lax.scan` in the reference).  `tns` (the reference's signature)
and `tns_packed` (compact or f32 spectra and the native parser's packed
filter planes, as a serving chunk has them) run `csrc/tns.cu` on CUDA
tensors and their plain PyTorch versions, `tns_ref` and `tns_packed_ref`,
on CPU tensors.

All compute y[n] = x[n] - sum_i lpc_n[i] * y[n-1-i] (order <= 20, up to 8
filters per direction, taps masked to the active filter's range), forward
and on the reversed spectrum, in compensated float-float arithmetic: the
recursion state is an f32 hi + lo pair, products split exactly by mantissa
masking (TwoProd), sums by Knuth TwoSum.  That keeps high-gain order-12..20
filters at fp64-class accuracy, where a plain f32 recursion drifts ~1e-3
full scale.

The kernel does the work the filters ask for: `plan` is what its first
stage computes (one work item per non-empty filter slot, listed by order
class and length) and `model` is its step order in numpy (history from zero instead
of masked taps, only the bins of the filter, only the taps of the order
class, the product's error term by FMA).  The CPU tests hold both to the
plain version; change them with the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.kernels import _build
from aacjax_torch.kernels.pipeline import decompress_i16

FRAME = 1024
SLOTS = 8
ORDER = 20
ORDER_CLASSES = (4, 8, 12, 20)   # a work item runs the taps of its class
LEN_BUCKETS = 8                  # work lists per class, by length in steps of 128 bins
N_LISTS = len(ORDER_CLASSES) * LEN_BUCKETS

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


def tns_packed_ref(spec, spec_scale, tns_lpc, tns_range):
    """Plain PyTorch version of `tns_packed`: decompress, slice the packed
    planes, `tns_ref`."""
    x = spec if spec_scale is None else decompress_i16(spec, spec_scale)
    return tns_ref(x, tns_lpc[:, :, 0], tns_range[:, :, 0, :, 0],
                   tns_range[:, :, 0, :, 1], tns_lpc[:, :, 1],
                   tns_range[:, :, 1, :, 0], tns_range[:, :, 1, :, 1])


def _launch(x, scale, C, T, lpc_f, lpc_r, lpc_row, ranges, rng_row, rng_slot):
    """Launch csrc/tns.cu on checked tensors.  lpc_f / lpc_r and the four
    `ranges` (forward start, end, reverse start, end) are addresses; the
    strides count elements.  Output, work lists and counters are allocated
    here, on the current stream."""
    global launches
    dev = x.device
    rows = C * T
    out = torch.empty((C, T, FRAME), dtype=torch.float32, device=dev)
    items = torch.empty((N_LISTS, 2 * SLOTS * rows), dtype=torch.int32,
                        device=dev)
    counts = torch.zeros(N_LISTS, dtype=torch.int32, device=dev)
    _build.launch("aacjax_tns", x.data_ptr(),
                  0 if scale is None else scale.data_ptr(),
                  0 if scale is None else 1, lpc_f, lpc_r, lpc_row, *ranges,
                  rng_row, rng_slot, out.data_ptr(), items.data_ptr(),
                  counts.data_ptr(), rows,
                  torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


def tns(spec, fwd_lpc, fwd_start, fwd_end, rev_lpc, rev_start, rev_end):
    """TNS over a [C,T,1024] f32 chunk: lpc f32 [C,T,8,20], start/end int32
    [C,T,8] per direction (the filters of one direction disjoint).  Returns
    the filtered spectra [C,T,1024].  The kernel reads the six planes where
    they lie, through per-direction pointers and strides."""
    args = (spec, fwd_lpc, fwd_start, fwd_end, rev_lpc, rev_start, rev_end)
    if spec.device.type == "cpu":
        return tns_ref(*args)
    _build.require_cuda(spec, "tns")
    if spec.dim() != 3:
        raise ValueError(f"spec: shape {tuple(spec.shape)}, expected [C,T,1024]")
    C, T, _ = spec.shape
    dev = spec.device
    ck = _build.check
    ck(spec, "spec", torch.float32, (C, T, FRAME), dev, align=16)
    ptrs = {}
    for d in ("fwd", "rev"):
        lpc, st, en = (args[1:4] if d == "fwd" else args[4:7])
        ptrs[d] = (ck(lpc, f"{d}_lpc", torch.float32, (C, T, SLOTS, ORDER), dev),
                   ck(st, f"{d}_start", torch.int32, (C, T, SLOTS), dev),
                   ck(en, f"{d}_end", torch.int32, (C, T, SLOTS), dev))
    return _launch(spec, None, C, T, ptrs["fwd"][0], ptrs["rev"][0],
                   SLOTS * ORDER, (*ptrs["fwd"][1:], *ptrs["rev"][1:]),
                   SLOTS, 1)


def tns_packed(spec, spec_scale, tns_lpc, tns_range):
    """TNS as a serving chunk has it: spec f32 [C,T,1024] with spec_scale
    None, or compact int16 [C,T,1024] with spec_scale f32 [C,T,64] (the
    kernel decompresses, the same product as decompress_i16); tns_lpc f32
    [C,T,2,8,20] and tns_range int32 [C,T,2,8,2] as the native parser packs
    them (bank 0 forward, bank 1 reverse in flipped coordinates; (start,
    end) pairs).  Returns the filtered f32 spectra [C,T,1024]."""
    if spec.device.type == "cpu":
        return tns_packed_ref(spec, spec_scale, tns_lpc, tns_range)
    _build.require_cuda(spec, "tns_packed")
    if spec.dim() != 3:
        raise ValueError(f"spec: shape {tuple(spec.shape)}, expected [C,T,1024]")
    C, T, _ = spec.shape
    dev = spec.device
    ck = _build.check
    if spec_scale is None:
        ck(spec, "spec", torch.float32, (C, T, FRAME), dev, align=16)
    else:
        ck(spec, "spec", torch.int16, (C, T, FRAME), dev, align=8)
        ck(spec_scale, "spec_scale", torch.float32, (C, T, FRAME // 16), dev)
    lpc = ck(tns_lpc, "tns_lpc", torch.float32, (C, T, 2, SLOTS, ORDER), dev)
    rng = ck(tns_range, "tns_range", torch.int32, (C, T, 2, SLOTS, 2), dev)
    rev = 4 * SLOTS * 2              # bytes from bank 0 to bank 1
    return _launch(spec, spec_scale, C, T, lpc, lpc + 4 * SLOTS * ORDER,
                   2 * SLOTS * ORDER, (rng, rng + 4, rng + rev, rng + rev + 4),
                   2 * SLOTS * 2, 2)


# -- what the kernel computes, in numpy ---------------------------------------
def plan(tns_lpc: np.ndarray, tns_range: np.ndarray) -> dict[str, np.ndarray]:
    """The kernel's work plan for packed planes (tns_lpc [..., 2, 8, 20],
    tns_range [..., 2, 8, 2]), per (row, direction, slot): `start` and `end`
    clamped to [0, 1024], `order` (index of the last non-zero tap + 1; 0 for
    an empty range), `work` (start < end and order > 0: the slot becomes a
    work item), `cls` (index into ORDER_CLASSES) and `list` (the work list,
    cls * LEN_BUCKETS + (end - start - 1) // 128; both meaningful where
    `work`)."""
    lpc = np.asarray(tns_lpc).reshape(-1, 2, SLOTS, ORDER)
    rng = np.asarray(tns_range).reshape(-1, 2, SLOTS, 2)
    start = np.maximum(rng[..., 0], 0)
    end = np.minimum(rng[..., 1], FRAME)
    nz = lpc != 0
    order = np.where(nz.any(-1), ORDER - np.argmax(nz[..., ::-1], -1), 0)
    order = np.where(start < end, order, 0)
    cls = np.searchsorted(ORDER_CLASSES, order)
    bucket = np.maximum(end - start - 1, 0) // (FRAME // LEN_BUCKETS)
    return dict(start=start, end=end, order=order, work=order > 0, cls=cls,
                list=cls * LEN_BUCKETS + bucket)


def two_prod_split(a: np.ndarray, b: np.ndarray):
    """a * b = p + e by mantissa masking (f32 numpy): the reference's form."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mask = np.uint32(0xFFFFF000)
    p = a * b
    ah = (a.view(np.uint32) & mask).view(np.float32)
    al = a - ah
    bh = (b.view(np.uint32) & mask).view(np.float32)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def two_prod_fma(a: np.ndarray, b: np.ndarray):
    """a * b = p + e with e = fma(a, b, -p), the kernel's form.  The FMA is
    exact in float64 (a product of two f32 has 48 bits) up to its one
    rounding to f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    p = a * b
    e = a.astype(np.float64) * b.astype(np.float64) - p.astype(np.float64)
    return p, e.astype(np.float32)


def _two_sum_np(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def model(spec, spec_scale, tns_lpc, tns_range, work=None) -> np.ndarray:
    """The kernel's step order in numpy, on `tns_packed`'s arguments as
    arrays: the pass-through of every bin, then each work item of `work`
    (default `plan(tns_lpc, tns_range)`) on its own -- history from zero at
    its start, its bins only, the taps of its order class, products by
    `two_prod_fma` -- writing the bins it owns (a forward item none that a
    reverse range covers).  Items of one class run in lock step here; the
    result does not depend on their order."""
    spec = np.asarray(spec)
    C, T, F = spec.shape
    if spec_scale is None:
        x = spec.astype(np.float32).reshape(C * T, F)
    else:
        sc = np.asarray(spec_scale, np.float32)
        x = (spec.astype(np.float32).reshape(C, T, sc.shape[-1], -1)
             * sc[..., None]).reshape(C * T, F)
    w = plan(tns_lpc, tns_range) if work is None else work
    lpc = np.asarray(tns_lpc, np.float32).reshape(-1, 2, SLOTS, ORDER)
    rng = np.asarray(tns_range).reshape(-1, 2, SLOTS, 2)
    bins = np.arange(F)
    rev_lo, rev_hi = F - rng[:, 1, :, 1], F - rng[:, 1, :, 0]
    rev_cover = ((rev_lo[..., None] <= bins) & (bins < rev_hi[..., None])
                 & (rev_lo < rev_hi)[..., None]).any(1)          # [rows, F]
    out = x.copy()
    for k, K in enumerate(ORDER_CLASSES):
        row, d, slot = np.nonzero(w["work"] & (w["cls"] == k))
        if not len(row):
            continue
        start, end = w["start"][row, d, slot], w["end"][row, d, slot]
        c = lpc[row, d, slot, :K]
        hh = np.zeros((len(row), K), np.float32)     # hh[:, i] = y[n-1-i]
        hl = np.zeros_like(hh)
        for j in range(int((end - start).max())):
            n = np.minimum(start + j, F - 1)
            idx = np.where(d == 1, F - 1 - n, n)
            p, e = two_prod_fma(c, hh)
            e = e + c * hl
            s, err = -p[:, 0], -e[:, 0]
            for i in range(1, K):
                s, e2 = _two_sum_np(s, -p[:, i])
                err = err + e2 - e[:, i]
            y_hi, e2 = _two_sum_np(x[row, idx], s)
            y_hi, y_lo = _two_sum_np(y_hi, err + e2)
            hh = np.concatenate([y_hi[:, None], hh[:, :-1]], axis=1)
            hl = np.concatenate([y_lo[:, None], hl[:, :-1]], axis=1)
            live = (start + j < end) & ((d == 1) | ~rev_cover[row, idx])
            out[row[live], idx[live]] = y_hi[live]
    return out.reshape(C, T, F)
