"""The Parametric Stereo decorrelator of one chunk, with a CUDA kernel.

Counterpart of the whole of `aacjax/kernels/ps_batch.py` `_decorrelate`
(XLA on the TPU: `lax.scan` in its `seq` form, Hillis-Steele doubling and
Toeplitz products in its defaults, which are TPU workarounds and are not
ported).  `decorrelate_chunk` runs `csrc/ps_decorr.cu` on CUDA tensors
(one launch a chunk) and its plain PyTorch version, `decorrelate_chunk_ref`,
on CPU tensors.  Per row of the batch, over the chunk's S = 32 T slots of
the hybrid planes s [B, S, nb] (complex as re, im):

  * the power per parameter band p and slot, the sum of |s|^2 over the
    hybrid bands k with k_to_i[k] = p in ascending k (the padded member
    table `members` [npar, M], pad index nb);
  * the transient detector over the slots, per (row, p): a decaying peak
    max(0.766 peak, x) and two smoothers of coefficient 0.25, giving the
    gain psm / (1.5 pdf) where 1.5 pdf > psm, else 1 (`decorrelate_ref`);
  * the [14 history | S] delay line: bands k < nap take s two slots back,
    rotated by phi[k], into the 3-link allpass cascade (link m, delay 3 + m,
    reads register 2 - m of its 5-deep line, n = ld q_m - a_m c, pushes
    c + a_m n and passes n on); bands nap <= k < sdb are s 14 slots back,
    bands k >= sdb s one slot back;
  * d[s, k] = source[s, k] * gain[s, k_to_i[k]];
  * the new state: the last 14 slots of s band-major, the allpass lines, the
    detector's three values.

Every operation is one f32 operation in the same order in the plain
version, the kernel and `model` (the kernel's tile schedule in numpy), so
the three agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.kernels import _build

C_PEAK = 0.76592833836465
LINKS, DEPTH = 3, 5
HIST = 14           # the delay line's history slots
SLOTS = 32          # the kernel's tile: one QMF frame
STAGES = 3          # the kernel's ring of tiles in shared memory
MAX_NB = 96         # the kernel's widest band layout
STATE_KEYS = ("delay_r", "delay_i", "ap_r", "ap_i", "peak", "psmooth",
              "pdiff")
CONST_KEYS = ("phi_r", "phi_i", "qf_r", "qf_i", "ag", "k_to_i32", "members")

launches = 0    # kernel launches since the last reset


def member_table(k_to_i: np.ndarray, npar: int) -> np.ndarray:
    """The hybrid bands of each parameter band in ascending order, padded
    with nb (the index of a zero column) to the longest group:
    int32 [npar, M]."""
    nb = len(k_to_i)
    groups = [np.flatnonzero(k_to_i == p) for p in range(npar)]
    if min(len(g) for g in groups) == 0:
        raise ValueError("a parameter band has no hybrid band")
    out = np.full((npar, max(len(g) for g in groups)), nb, np.int32)
    for p, g in enumerate(groups):
        out[p, :len(g)] = g
    return out


def decorrelate_ref(pw, xr, xi, peak, psmooth, pdiff, ap_r, ap_i, qf_r, qf_i,
                    ag):
    """The two recurrences, a Python loop over the slots.  pw f32 [B,S,npar]
    per-parameter-band power; xr / xi f32 [B,S,nap] the allpass input;
    peak / psmooth / pdiff [B,npar] and ap_r / ap_i [B,nap,3,5] the carried
    state; qf_r / qf_i / ag [nap,3] the links' constants.  Returns (tg
    [B,S,npar], peak, psmooth, pdiff, yr, yi [B,S,nap], ap_r, ap_i); no
    argument is changed."""
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


def band_power(s_r, s_i, members):
    """The power per parameter band, [B,S,npar]: |s|^2 summed over each
    band's members in ascending order (members [npar, M], pad nb)."""
    e = s_r * s_r + s_i * s_i
    e = torch.cat([e, torch.zeros_like(e[..., :1])], dim=-1)  # the pad column
    idx = members.long()
    pw = e[..., idx[:, 0]]
    for j in range(1, idx.shape[1]):
        pw = pw + e[..., idx[:, j]]
    return pw


def decorrelate_chunk_ref(s_r, s_i, state: dict, c: dict, sdb: int):
    """Plain PyTorch version.  s_r / s_i f32 [B,S,nb]; state the
    decorrelator state (STATE_KEYS: delay_r / delay_i [B,nb,14], ap_r /
    ap_i [B,nap,3,5], peak / psmooth / pdiff [B,npar]); c the mode's
    constants (CONST_KEYS: phi_r / phi_i [nap], qf_r / qf_i / ag [nap,3],
    k_to_i32 [nb], members [npar,M]); sdb the first band delayed by one
    slot.  Returns (d_r, d_i [B,S,nb], the new state); no argument is
    changed."""
    nap = c["phi_r"].shape[0]
    S = s_r.shape[1]
    pw = band_power(s_r, s_i, c["members"])
    # the [14 history | S] line along the slots
    line_r = torch.cat([state["delay_r"].transpose(1, 2), s_r], dim=1)
    line_i = torch.cat([state["delay_i"].transpose(1, 2), s_i], dim=1)
    # allpass bands: the input is s two slots back, rotated by phi
    xin_r = line_r[:, HIST - 2: HIST - 2 + S, :nap]
    xin_i = line_i[:, HIST - 2: HIST - 2 + S, :nap]
    xr = xin_r * c["phi_r"] - xin_i * c["phi_i"]               # [B,S,nap]
    xi = xin_r * c["phi_i"] + xin_i * c["phi_r"]
    tg, peak, psm, pdf, yr, yi, ap_r, ap_i = decorrelate_ref(
        pw, xr, xi, state["peak"], state["psmooth"], state["pdiff"],
        state["ap_r"], state["ap_i"], c["qf_r"], c["qf_i"], c["ag"])
    # the other bands: a plain delay of 14 slots below sdb, of 1 above
    d_r = torch.cat([yr, line_r[:, :S, nap:sdb],
                     line_r[:, HIST - 1: HIST - 1 + S, sdb:]], dim=2)
    d_i = torch.cat([yi, line_i[:, :S, nap:sdb],
                     line_i[:, HIST - 1: HIST - 1 + S, sdb:]], dim=2)
    tg_k = tg[..., c["k_to_i32"].long()]                       # [B,S,nb]
    new_state = dict(
        delay_r=line_r[:, -HIST:].transpose(1, 2).contiguous(),
        delay_i=line_i[:, -HIST:].transpose(1, 2).contiguous(),
        ap_r=ap_r, ap_i=ap_i, peak=peak, psmooth=psm, pdiff=pdf)
    return d_r * tg_k, d_i * tg_k, new_state


def model(s_r, s_i, state: dict, c: dict, sdb: int):
    """The kernel's schedule in numpy float32, all rows at once (a block a
    row): a ring of STAGES tiles of 32 slots, tiles 0..STAGES-2 loaded at
    the start and tile t + STAGES - 1 into the stage of tile t - 1 once
    tile t is done; the delay state in slots 18..31 of the stage before
    tile 0.  Per tile: the allpass walk; the powers from the power plan
    (the members of p = 0, 1, ... in order, the first one added to 0, a
    band's sum stored at its last member) with a lane per slot; the
    detector's recurrences, keeping psm and 1.5 pdf per slot; the gains;
    d written over the stage of tile t - 1, its rows 0..15 first, and
    copied out from there.  The new delay state comes from the last tile.
    Arguments as decorrelate_chunk_ref's, as numpy arrays; returns the same
    as numpy."""
    f32 = np.float32
    s = [np.asarray(a, f32) for a in (s_r, s_i)]
    B, S, nb = s[0].shape
    members = np.asarray(c["members"])
    kmap = np.asarray(c["k_to_i32"]).astype(np.int64)
    ph_r, ph_i = (np.asarray(c[k], f32) for k in ("phi_r", "phi_i"))
    q_r, q_i, ag = (np.asarray(c[k], f32) for k in ("qf_r", "qf_i", "ag"))
    nap, npar = len(ph_r), len(members)
    plan = []
    for p in range(npar):
        row = [int(k) for k in members[p] if k < nb]
        plan += [(k, p, j == 0, j == len(row) - 1) for j, k in enumerate(row)]
    ntiles = S // SLOTS
    ring = np.zeros((STAGES, 2, B, SLOTS, nb), f32)
    for p in range(2):
        ring[STAGES - 1, p, :, SLOTS - HIST:] = np.asarray(
            state[("delay_r", "delay_i")[p]], f32).transpose(0, 2, 1)

    def load(t):
        for p in range(2):
            ring[t % STAGES, p] = s[p][:, t * SLOTS:(t + 1) * SLOTS]
    for t in range(min(STAGES - 1, ntiles)):
        load(t)
    peak, psm, pdf = (np.array(state[k], f32)
                      for k in ("peak", "psmooth", "pdiff"))
    lines = [np.array(state[k], f32) for k in ("ap_r", "ap_i")]
    d = [np.empty((B, S, nb), f32) for _ in range(2)]
    band = np.arange(nb)
    lag = np.where(band < sdb, HIST, 1)
    with np.errstate(all="ignore"):
        for t in range(ntiles):
            cur, prev = ring[t % STAGES], ring[(t + STAGES - 1) % STAGES]
            # 1a. the allpass, a thread per band: s two slots back, rotated
            y = np.empty((2, B, nap, SLOTS), f32)
            for j in range(SLOTS):
                src = cur[:, :, j - 2] if j >= 2 else prev[:, :, SLOTS - 2 + j]
                xr, xi = src[0, :, :nap], src[1, :, :nap]
                cr = xr * ph_r - xi * ph_i
                ci = xr * ph_i + xi * ph_r
                for m in range(LINKS):
                    ld_r, ld_i = lines[0][:, :, m, 2 - m], lines[1][:, :, m, 2 - m]
                    nr = (ld_r * q_r[:, m] - ld_i * q_i[:, m]) - ag[:, m] * cr
                    ni = (ld_r * q_i[:, m] + ld_i * q_r[:, m]) - ag[:, m] * ci
                    for p, (v, n) in enumerate(((cr, nr), (ci, ni))):
                        lines[p][:, :, m, :-1] = lines[p][:, :, m, 1:].copy()
                        lines[p][:, :, m, -1] = v + ag[:, m] * n
                    cr, ci = nr, ni
                y[0, :, :, j], y[1, :, :, j] = cr, ci
            # 1b. the powers from the plan, a lane per slot
            pw = np.empty((B, npar, SLOTS), f32)
            acc = np.zeros((B, SLOTS), f32)
            for k, p, first, last in plan:
                e = cur[0, :, :, k] * cur[0, :, :, k] + \
                    cur[1, :, :, k] * cur[1, :, :, k]
                acc = (np.zeros_like(acc) if first else acc) + e
                if last:
                    pw[:, p] = acc
            # 1c. the detector's recurrences, a thread per band
            psm_s = np.empty((B, npar, SLOTS), f32)
            den_s = np.empty((B, npar, SLOTS), f32)
            for j in range(SLOTS):
                x = pw[:, :, j]
                peak = np.maximum(f32(C_PEAK) * peak, x)
                psm = psm + f32(0.25) * (x - psm)
                pdf = pdf + f32(0.25) * ((peak - x) - pdf)
                psm_s[:, :, j], den_s[:, :, j] = psm, f32(1.5) * pdf
            # 2a. the gains of the tile
            g = np.where(den_s > psm_s, psm_s / np.where(den_s > 0, den_s,
                                                         f32(1.0)), f32(1.0))
            # 2b. d into the stage of tile t - 1, rows 0..15 first (that
            # stage's rows 18..31 are read for d's slots 0..13), then
            # 16..31; the rows leave for d_r, d_i from there
            for rows in (range(0, SLOTS // 2), range(SLOTS // 2, SLOTS)):
                for j in rows:
                    at = j - lag
                    out = []
                    for p in range(2):
                        delayed = np.where(
                            at >= 0, cur[p][:, np.maximum(at, 0), band],
                            prev[p][:, np.minimum(at, -1) + SLOTS, band])
                        src = np.concatenate([y[p][:, :, j],
                                              delayed[:, nap:]], 1)
                        out.append(src * g[:, kmap, j])
                    for p in range(2):
                        prev[p][:, j] = out[p]
            for p in range(2):
                d[p][:, t * SLOTS:(t + 1) * SLOTS] = prev[p]
            # 3. the stage of tile t - 1 takes tile t + STAGES - 1
            if t + STAGES - 1 < ntiles:
                load(t + STAGES - 1)
    last = ring[(ntiles - 1) % STAGES]
    new_state = dict(
        delay_r=last[0, :, SLOTS - HIST:].transpose(0, 2, 1).copy(),
        delay_i=last[1, :, SLOTS - HIST:].transpose(0, 2, 1).copy(),
        ap_r=lines[0], ap_i=lines[1], peak=peak, psmooth=psm, pdiff=pdf)
    return d[0], d[1], new_state


def decorrelate_chunk(s_r, s_i, state: dict, c: dict, sdb: int):
    """One chunk's decorrelation (arguments and results as
    decorrelate_chunk_ref's): one launch of the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if s_r.device.type == "cpu":
        return decorrelate_chunk_ref(s_r, s_i, state, c, sdb)
    _build.require_cuda(s_r, "decorrelate_chunk")
    global launches
    if s_r.dim() != 3:
        raise ValueError(f"s_r {tuple(s_r.shape)}: expected [B,S,nb]")
    B, S, nb = s_r.shape
    if S % SLOTS:
        raise ValueError(f"S = {S}: the kernel takes whole frames of "
                         f"{SLOTS} slots")
    nap = c["phi_r"].shape[0]
    npar, M = c["members"].shape
    if not (0 < nap <= sdb <= nb <= MAX_NB and npar > 0
            and -(-npar // 32) + -(-nap // 32) <= 4):
        raise ValueError(f"nb {nb}, npar {npar}, nap {nap}, sdb {sdb}: not "
                         "a band layout the kernel takes")
    dev = s_r.device
    ck = _build.check
    f32, i32 = torch.float32, torch.int32
    shapes = dict(delay_r=(B, nb, HIST), delay_i=(B, nb, HIST),
                  ap_r=(B, nap, LINKS, DEPTH), ap_i=(B, nap, LINKS, DEPTH),
                  peak=(B, npar), psmooth=(B, npar), pdiff=(B, npar),
                  phi_r=(nap,), phi_i=(nap,), qf_r=(nap, LINKS),
                  qf_i=(nap, LINKS), ag=(nap, LINKS), k_to_i32=(nb,),
                  members=(npar, M))
    # the tiles move in and out as bulk copies: 16-byte alignment
    ptrs = [ck(s_r, "s_r", f32, (B, S, nb), dev, 16),
            ck(s_i, "s_i", f32, (B, S, nb), dev, 16)]
    ptrs += [ck(state[k], k, f32, shapes[k], dev) for k in STATE_KEYS]
    ptrs += [ck(c[k], k, i32 if k in ("k_to_i32", "members") else f32,
                shapes[k], dev) for k in CONST_KEYS]
    d_r, d_i = torch.empty_like(s_r), torch.empty_like(s_i)
    new_state = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    launches += _build.launch(
        "aacjax_ps_decorrelate", dev, *ptrs, d_r.data_ptr(), d_i.data_ptr(),
        *(new_state[k].data_ptr() for k in STATE_KEYS),
        B, S, nb, npar, nap, sdb, M,
        torch.cuda.current_stream(dev).cuda_stream)
    return d_r, d_i, new_state
