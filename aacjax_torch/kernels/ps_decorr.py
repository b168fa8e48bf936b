"""The Parametric Stereo decorrelator's recurrences, with a CUDA kernel.

Counterpart of the two sequential recurrences inside
`aacjax/kernels/ps_batch.py` `_decorrelate` (XLA on the TPU: `lax.scan` in
its `seq` form, Hillis-Steele doubling and Toeplitz products in its
defaults, which are TPU workarounds and are not ported).  `decorrelate`
runs `csrc/ps_decorr.cu` on CUDA tensors and its plain PyTorch version,
`decorrelate_ref` (a Python loop over the slots), on CPU tensors.

  * The transient detector, per (row, parameter band) over the S slots of
    the chunk: a decaying peak max(0.766 peak, x) and two smoothers of
    coefficient 0.25, giving the gain psm / (1.5 pdf) where 1.5 pdf > psm,
    else 1.
  * The 3-link allpass cascade, per (row, allpass band): link m (delay
    3 + m) reads register 2 - m of its 5-deep line, n = ld q_m - a_m c,
    pushes c + a_m n and passes n on.

Every operation is one f32 operation in the same order in both versions,
so the kernel equals the plain version bit for bit.  Layouts are
slot-major inside a row: pw and tg [B, S, npar], the allpass input and
output [B, S, nap]; the states keep the reference's shapes.
"""
from __future__ import annotations

import torch

from aacjax_torch.kernels import _build

C_PEAK = 0.76592833836465
LINKS, DEPTH = 3, 5

launches = 0    # kernel launches since the last reset


def decorrelate_ref(pw, xr, xi, peak, psmooth, pdiff, ap_r, ap_i, qf_r, qf_i,
                    ag):
    """Plain PyTorch version.  pw f32 [B,S,npar] per-parameter-band power;
    xr / xi f32 [B,S,nap] the allpass input; peak / psmooth / pdiff
    [B,npar] and ap_r / ap_i [B,nap,3,5] the carried state; qf_r / qf_i /
    ag [nap,3] the links' constants.  Returns (tg [B,S,npar], peak,
    psmooth, pdiff, yr, yi [B,S,nap], ap_r, ap_i); no argument is
    changed."""
    dev = pw.device
    c_peak = torch.tensor(C_PEAK, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    S = pw.shape[1]
    tg = torch.empty_like(pw)
    for s in range(S):
        x = pw[:, s]
        peak = torch.maximum(c_peak * peak, x)
        psmooth = psmooth + 0.25 * (x - psmooth)
        pdiff = pdiff + 0.25 * (peak - x - pdiff)
        denom = 1.5 * pdiff
        tg[:, s] = torch.where(denom > psmooth,
                               psmooth / torch.where(denom > 0, denom, one),
                               one)
    regs_r = [ap_r[:, :, m].clone() for m in range(LINKS)]   # [B,nap,5] each
    regs_i = [ap_i[:, :, m].clone() for m in range(LINKS)]
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    for s in range(S):
        cr, ci = xr[:, s], xi[:, s]
        for m in range(LINKS):
            ld_r, ld_i = regs_r[m][..., 2 - m], regs_i[m][..., 2 - m]
            nr = ld_r * qf_r[:, m] - ld_i * qf_i[:, m] - ag[:, m] * cr
            ni = ld_r * qf_i[:, m] + ld_i * qf_r[:, m] - ag[:, m] * ci
            regs_r[m] = torch.cat([regs_r[m][..., 1:],
                                   (cr + ag[:, m] * nr)[..., None]], dim=-1)
            regs_i[m] = torch.cat([regs_i[m][..., 1:],
                                   (ci + ag[:, m] * ni)[..., None]], dim=-1)
            cr, ci = nr, ni
        yr[:, s] = cr
        yi[:, s] = ci
    return (tg, peak, psmooth, pdiff, yr, yi, torch.stack(regs_r, dim=2),
            torch.stack(regs_i, dim=2))


def decorrelate(pw, xr, xi, peak, psmooth, pdiff, ap_r, ap_i, qf_r, qf_i, ag):
    """The recurrences of one chunk (arguments and results as
    decorrelate_ref's): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    args = (pw, xr, xi, peak, psmooth, pdiff, ap_r, ap_i, qf_r, qf_i, ag)
    if pw.device.type == "cpu":
        return decorrelate_ref(*args)
    _build.require_cuda(pw, "decorrelate")
    global launches
    if pw.dim() != 3 or xr.dim() != 3:
        raise ValueError(f"pw {tuple(pw.shape)}, xr {tuple(xr.shape)}: "
                         "expected [B,S,npar] and [B,S,nap]")
    B, S, npar = pw.shape
    nap = xr.shape[2]
    dev = pw.device
    ck = _build.check
    f32 = torch.float32
    ptrs = [ck(pw, "pw", f32, (B, S, npar), dev)]
    for name, a in (("peak", peak), ("psmooth", psmooth), ("pdiff", pdiff)):
        ptrs.append(ck(a, name, f32, (B, npar), dev))
    for name, a in (("xr", xr), ("xi", xi)):
        ptrs.append(ck(a, name, f32, (B, S, nap), dev))
    for name, a in (("ap_r", ap_r), ("ap_i", ap_i)):
        ptrs.append(ck(a, name, f32, (B, nap, LINKS, DEPTH), dev))
    for name, a in (("qf_r", qf_r), ("qf_i", qf_i), ("ag", ag)):
        ptrs.append(ck(a, name, f32, (nap, LINKS), dev))
    outs = (torch.empty_like(pw), torch.empty_like(peak),
            torch.empty_like(psmooth), torch.empty_like(pdiff),
            torch.empty_like(xr), torch.empty_like(xi),
            torch.empty_like(ap_r), torch.empty_like(ap_i))
    _build.launch("aacjax_ps_decorr", *ptrs, *(o.data_ptr() for o in outs),
                  B, S, npar, nap, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return outs
