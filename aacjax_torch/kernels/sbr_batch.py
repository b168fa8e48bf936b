"""Batched SBR reconstruction on tensors.

Counterpart of `aacjax/kernels/sbr_batch.py`.  One call applies SBR to a
whole [B, T] chunk of channel-frames: QMF analysis (kernels/qmf.py),
covariance-LPC inverse filtering (three lag dot products and a 2x2 complex
solve per subband line), the patch, envelope gains with limiter and boost,
noise and sinusoid assembly, the VAR-class overhang carry, and QMF
synthesis.  The reference computes it as plain XLA, with no Pallas kernel
and no scan, so it ports as PyTorch, in the GPU's form where the TPU's was
a workaround:

  * the patch-source selection is a gather by each slot's `src_band` plane
    (the reference: a one-hot [32, 64] product per slot);
  * the noise rows are one gather from the 512-entry table at
    (noise_base + k + 1 - kx) & 511 (the reference: a 64-way one-hot
    product into a Hankel slab plus an 8-way select);
  * the per-slot expansion of envelope gains is a gather by `env_id`;
  * the envelope and limiter-band sums stay small batched products over
    indicator planes.

The selections return the same values as the reference's, exactly; the
products and sums reorder float additions.

The host packs every grid-dependent quantity densely (host/sbr_pack.py) and
keeps the sequential cross-frame state; the device carries only the QMF,
X_low and overhang FIFOs between chunks.  The header's statics are per-slot
data (cfg planes), so one batch may mix SBR headers.
"""
from __future__ import annotations

import functools
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from aacjax_torch.kernels import _build, qmf
from aacjax_torch.runtime import graphs

MAX_ENV = 5
BANDS = 64
SLOTS = 32      # QMF output slots per frame
YSLOTS = 38     # adjusted slots (32 + up to 6 VAR-class overhang)
HIST = 8        # carried X_low slots
ADJ = 2         # envelope/output window offset (see host.sbr_decode)
MAX_LIM = 16


@dataclass(frozen=True)
class SBRStaticConfig:
    """Header- and table-derived configuration of one slot.  plane_row()
    renders it into the slot's rows of the dense cfg planes that sbr_apply
    reads, so a batch may mix headers."""
    kx: int
    m: int
    src_band: tuple       # [64] patch source subband per target (0 pad)
    patched: tuple        # [64] 1 where the subband is HF-generated
    lim_ind: tuple        # [MAX_LIM * 64] flattened limiter indicators
    limgain: float
    n_lim: int

    @classmethod
    def from_tables(cls, t, limgain: float) -> "SBRStaticConfig":
        src = np.zeros(BANDS, np.int64)
        pat = np.zeros(BANDS, np.int64)
        g = 0
        for i in range(t.num_patches):
            for x in range(t.patch_num_subbands[i]):
                k = t.kx + g
                src[k] = t.patch_start_subband[i] + x
                pat[k] = 1
                g += 1
        lim = np.zeros((MAX_LIM, BANDS), np.float32)
        f_lim = np.asarray(t.f_lim)
        for b in range(min(t.n_lim, MAX_LIM)):
            lim[b, int(f_lim[b]): int(f_lim[b + 1])] = 1.0
        return cls(kx=int(t.kx), m=int(t.m),
                   src_band=tuple(int(v) for v in src),
                   patched=tuple(int(v) for v in pat),
                   lim_ind=tuple(float(v) for v in lim.reshape(-1)),
                   limgain=float(limgain), n_lim=int(t.n_lim))

    def plane_row(self) -> dict:
        """This config rendered as one slot's rows of the cfg planes."""
        kvec = np.arange(BANDS)
        lim = np.array(self.lim_ind, np.float32).reshape(MAX_LIM, BANDS)
        return dict(
            kx=np.int32(self.kx),
            src_band=np.array(self.src_band, np.int32),
            patched=np.array(self.patched, np.float32),
            in_range=((kvec >= self.kx) & (kvec < self.kx + self.m))
            .astype(np.float32),
            lim=lim,
            in_lim=lim.sum(axis=0),
            limgain=np.float32(self.limgain),
        )


def cfg_planes_zeros(B: int) -> dict:
    """Zeroed per-slot config planes (host numpy).  A zero row is a valid
    don't-care for slots with no SBR payload: has_sbr=0 masks the HF path
    out and the low band passes through on the (kvec < 32) branch."""
    return dict(
        kx=np.full(B, 32, np.int32),
        src_band=np.zeros((B, BANDS), np.int32),
        patched=np.zeros((B, BANDS), np.float32),
        in_range=np.zeros((B, BANDS), np.float32),
        lim=np.zeros((B, MAX_LIM, BANDS), np.float32),
        in_lim=np.zeros((B, BANDS), np.float32),
        limgain=np.ones(B, np.float32),
    )


def set_cfg_row(planes: dict, s: int, cfg: SBRStaticConfig) -> None:
    for k, v in cfg.plane_row().items():
        planes[k][s] = v


def broadcast_cfg(cfg: SBRStaticConfig, B: int) -> dict:
    """One config broadcast to all B slots."""
    planes = cfg_planes_zeros(B)
    row = cfg.plane_row()
    for k in planes:
        planes[k][:] = row[k]
    return planes


@_build.per_device
def _noise_table(device: torch.device) -> torch.Tensor:
    d = np.load(pathlib.Path(__file__).parent.parent / "host"
                / "sbr_tables.npz")
    return torch.from_numpy(d["noise_table"].astype(np.float32)).to(device)


def sbr_state_init(B: int, device: str | torch.device) -> dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return dict(
        x_hist=z(B, qmf.ANA_HIST),
        v_hist=z(B, qmf.SYN_HIST, 128),
        xlow_r=z(B, HIST, 32),
        xlow_i=z(B, HIST, 32),
        # the previous chunk's final-frame adjusted overhang (Y carry)
        ytail_r=z(B, YSLOTS - SLOTS, BANDS),
        ytail_i=z(B, YSLOTS - SLOTS, BANDS),
    )


def _lpc_batch(wr, wi):
    """Covariance LPC per [B,T,32] subband line over the 40-slot window.
    wr/wi [B,T,40,32].  Returns (a0r, a0i, a1r, a1i) each [B,T,32]."""
    def cdots(ar, ai, br, bi):
        """sum a * conj(b) over the slot axis -> (re, im)."""
        return ((ar * br + ai * bi).sum(dim=2),
                (ai * br - ar * bi).sum(dim=2))

    a_r, a_i = wr[:, :, 2:40], wi[:, :, 2:40]
    b1r, b1i = wr[:, :, 1:39], wi[:, :, 1:39]
    b2r, b2i = wr[:, :, 0:38], wi[:, :, 0:38]
    p01r, p01i = cdots(a_r, a_i, b1r, b1i)
    p02r, p02i = cdots(a_r, a_i, b2r, b2i)
    p12r, p12i = cdots(b1r, b1i, b2r, b2i)
    p11 = (b1r * b1r + b1i * b1i).sum(dim=2)
    p22 = (b2r * b2r + b2i * b2i).sum(dim=2)

    d = p11 * p22 - (p12r * p12r + p12i * p12i) / 1.000001
    ok_d = d != 0
    safe_d = torch.where(ok_d, d, torch.ones_like(d))
    # a1 = (p01 * p12 - p02 * p11) / d        (plain complex product)
    a1r = torch.where(ok_d, (p01r * p12r - p01i * p12i - p02r * p11) / safe_d,
                      0.0)
    a1i = torch.where(ok_d, (p01r * p12i + p01i * p12r - p02i * p11) / safe_d,
                      0.0)
    # a0 = -(p01 + a1 * conj(p12)) / p11
    ok_p = p11 != 0
    safe_p11 = torch.where(ok_p, p11, torch.ones_like(p11))
    a0r = torch.where(ok_p, -(p01r + a1r * p12r + a1i * p12i) / safe_p11, 0.0)
    a0i = torch.where(ok_p, -(p01i + a1i * p12r - a1r * p12i) / safe_p11, 0.0)
    bad = ((a0r * a0r + a0i * a0i >= 16.0)
           | (a1r * a1r + a1i * a1i >= 16.0))
    return tuple(torch.where(bad, 0.0, a) for a in (a0r, a0i, a1r, a1i))


def expand_compact_dense(dense: dict) -> dict:
    """Inverse of sbr_pack.compact_dense (energies from their 1/1024-log2
    grid, the flag bits unpacked).  A non-compact dense dict passes
    through."""
    if "eq_l2" not in dense:
        return dense
    l2 = dense["eq_l2"]
    off = dense["eq_off"][:, :, :, None, None]
    mag = torch.where(l2 == -32768, 0.0,
                      torch.exp2(l2.to(torch.float32) * (1.0 / 1024.0) + off))
    sbits = dense["sbits"]
    dtbits = dense["dtbits"]
    f32, i32 = torch.float32, torch.int32
    return dict(
        e_orig=mag[:, :, 0], q_map=mag[:, :, 1],
        s_idx=(sbits & 1).to(f32), s_map=((sbits >> 1) & 1).to(f32),
        delta=(dtbits & 1).to(f32), transient=((dtbits >> 1) & 1).to(f32),
        covered=dense["covered"].to(f32), has_sbr=dense["has_sbr"].to(f32),
        env_id=dense["env_id"].to(i32), sine_idx=dense["sine_idx"].to(i32),
        noise_base=dense["noise_base"].to(i32),
        bw=dense["bw"], i_temp=dense["i_temp"])


def sbr_apply(core_pcm: torch.Tensor, dense: dict, state: dict, cfg: dict,
              out_int16: bool = False, emit_x: bool = False):
    """core_pcm [B, T, F] (1/32768-scale floats) -> pcm [B, T, 2F] plus the
    new state dict.  dense: the host-packed planes (host/sbr_pack.py, exact
    or compact) as tensors on core_pcm's device; cfg: the per-slot config
    planes (cfg_planes_zeros / set_cfg_row / broadcast_cfg) as tensors.
    The input state is not modified.

    out_int16 delivers int16 samples, else f32 in the 1/32768 scale.  With
    emit_x, returns (Xr, Xi [B, T*32, 64], the low-band line re / im
    [B, 8+T*32, 5], new_state) before synthesis, for the Parametric Stereo
    stage (the new state then lacks v_hist)."""
    dense = expand_compact_dense(dense)
    dev = core_pcm.device
    B, T, F = core_pcm.shape
    S = T * SLOTS
    YS = YSLOTS
    kx = cfg["kx"].long()                                    # [B]
    kvec = torch.arange(BANDS, device=dev)
    patched = cfg["patched"][:, None, None, :]               # [B,1,1,64]
    # the whole SBR range [kx, kx+m): the patch may cover fewer than m
    # subbands, and the spec still fills the unpatched tail with envelope
    # noise and sinusoids
    in_range = cfg["in_range"][:, None, None, :]             # [B,1,1,64]

    # --- analysis (full-scale PCM units) ------------------------------------
    xr, xi, x_hist = qmf.analysis(core_pcm.reshape(B, T * F) * 32768.0,
                                  state["x_hist"])
    xall_r = torch.cat([state["xlow_r"], xr], dim=1)         # [B, 8+S, 32]
    xall_i = torch.cat([state["xlow_i"], xi], dim=1)
    new_state = dict(x_hist=x_hist, xlow_r=xall_r[:, -HIST:],
                     xlow_i=xall_i[:, -HIST:])

    # per-frame 40-slot windows: rows 32t + d of xall, d in [0, 40)
    wr = xall_r.unfold(1, SLOTS + HIST, SLOTS).transpose(2, 3)  # [B,T,40,32]
    wi = xall_i.unfold(1, SLOTS + HIST, SLOTS).transpose(2, 3)

    # --- HF generation ------------------------------------------------------
    src = cfg["src_band"].long()                             # [B, 64]

    def sel(x):
        """x[..., src_band] per slot: [B,T,(40,)32] -> [B,T,(40,)64]."""
        idx = src.view(B, *([1] * (x.dim() - 2)), BANDS)
        return torch.gather(x, -1, idx.expand(*x.shape[:-1], BANDS))

    a0r, a0i, a1r, a1i = _lpc_batch(wr, wi)                  # [B,T,32]
    sr, si = sel(wr), sel(wi)                                # [B,T,40,64]
    bw = dense["bw"]
    bw2 = bw * bw
    a0r_k, a0i_k = (sel(a0r) * bw)[:, :, None], (sel(a0i) * bw)[:, :, None]
    a1r_k, a1i_k = (sel(a1r) * bw2)[:, :, None], (sel(a1i) * bw2)[:, :, None]
    cur_r, cur_i = sr[:, :, ADJ: ADJ + YS], si[:, :, ADJ: ADJ + YS]
    l1r, l1i = sr[:, :, ADJ - 1: ADJ - 1 + YS], si[:, :, ADJ - 1: ADJ - 1 + YS]
    l2r, l2i = sr[:, :, ADJ - 2: ADJ - 2 + YS], si[:, :, ADJ - 2: ADJ - 2 + YS]
    xh_r = (cur_r + l1r * a0r_k - l1i * a0i_k + l2r * a1r_k - l2i * a1i_k
            ) * patched                                      # [B,T,38,64]
    xh_i = (cur_i + l1r * a0i_k + l1i * a0r_k + l2r * a1i_k + l2i * a1r_k
            ) * patched

    # --- envelope energies --------------------------------------------------
    env_id = dense["env_id"].long()                          # [B,T,38]
    covered = dense["covered"]                               # [B,T,38]
    oh = ((env_id[..., None] == torch.arange(MAX_ENV, device=dev))
          .to(torch.float32) * covered[..., None])           # [B,T,38,5]
    counts = oh.sum(dim=2)                                   # [B,T,5]
    xh2 = xh_r * xh_r + xh_i * xh_i
    e_curr = (torch.matmul(oh.transpose(2, 3), xh2)
              / torch.clamp(counts, min=1.0)[..., None])     # [B,T,5,64]

    # --- gains (host.sbr_decode's formulas, over envelopes) -----------------
    e_orig, q_map = dense["e_orig"], dense["q_map"]
    s_idx, s_map = dense["s_idx"], dense["s_map"]
    delta = dense["delta"][..., None]                        # [B,T,5,1]
    q_m = torch.sqrt(e_orig * q_map / (1.0 + q_map))
    s_m = s_idx * torch.sqrt(e_orig / (1.0 + q_map))
    gain = torch.where(
        s_map != 0.0,
        torch.sqrt(e_orig * q_map / ((1.0 + e_curr) * (1.0 + q_map))),
        torch.sqrt(e_orig / ((1.0 + e_curr) * (1.0 + q_map * delta)))) + 1e-12

    # limiter and boost per limiter band (disjoint bands: one shot); the
    # indicator rows are per slot, so each slot limits over its own grid
    lim = cfg["lim"][:, None]                                # [B,1,16,64]
    lim_t = lim.transpose(2, 3)                              # [B,1,64,16]
    eps = 1e-12
    sum_o = torch.matmul(e_orig, lim_t)                      # [B,T,5,16]
    sum_c = torch.matmul(e_curr, lim_t)
    limgain = cfg["limgain"][:, None, None, None]            # [B,1,1,1]
    gmax_l = torch.clamp(limgain * torch.sqrt((eps + sum_o) / (eps + sum_c)),
                         max=1e5)
    in_lim = cfg["in_lim"][:, None, None, :]                 # [B,1,1,64]
    gmax = torch.matmul(gmax_l, lim) + (1.0 - in_lim) * 1e5
    q_m = torch.minimum(q_m, q_m * gmax / gain)
    gain = torch.minimum(gain, gmax)
    sum_b = torch.matmul(
        e_curr * gain * gain + s_m * s_m
        + delta * (s_m == 0.0).to(torch.float32) * q_m * q_m, lim_t)
    boost_l = torch.clamp(torch.sqrt((eps + sum_o) / (eps + sum_b)),
                          max=1.584893192)
    boost = torch.matmul(boost_l, lim) + (1.0 - in_lim)
    gain = gain * boost
    q_m = q_m * boost
    s_m = s_m * boost

    # --- per-slot expansion and assembly ------------------------------------
    eidx = env_id.clamp(0, MAX_ENV - 1)[..., None].expand(B, T, YS, BANDS)
    cov = covered[..., None]                                 # [B,T,38,1]
    g_slot = torch.gather(gain, 2, eidx) * cov               # [B,T,38,64]
    q_slot = torch.gather(q_m, 2, eidx) * cov
    s_slot = torch.gather(s_m, 2, eidx) * cov
    tr_slot = torch.gather(dense["transient"], 2,
                           env_id.clamp(0, MAX_ENV - 1))[..., None] * cov

    y_r = xh_r * g_slot
    y_i = xh_i * g_slot

    # noise: row (b, t, slot) reads 64 consecutive table entries from
    # (noise_base + 1 - kx) mod 512
    ntab = _noise_table(dev)                                 # [512, 2]
    nstart = (dense["noise_base"].long() + (1 - kx)[:, None, None]) & 0x1FF
    noise = ntab[(nstart[..., None] + kvec) & 0x1FF]         # [B,T,38,64,2]
    n_on = ((s_slot == 0.0).to(torch.float32) * (1.0 - tr_slot)
            * cov * in_range)
    y_r = y_r + n_on * q_slot * noise[..., 0]
    y_i = y_i + n_on * q_slot * noise[..., 1]

    # sinusoids: phase rotation (re, +im, -re, -im), the imaginary phases
    # signed per band
    phase = dense["sine_idx"][..., None]                     # [B,T,38,1]
    sign_k = torch.where((kvec & 1) == 1, -1.0, 1.0)
    y_r = (y_r + torch.where(phase == 0, s_slot, 0.0)
           - torch.where(phase == 2, s_slot, 0.0))
    y_i = (y_i + torch.where(phase == 1, s_slot * sign_k, 0.0)
           - torch.where(phase == 3, s_slot * sign_k, 0.0))

    # --- final X and synthesis ----------------------------------------------
    # VAR-class Y carry: a frame's first i_temp slots take the previous
    # frame's adjusted overhang (slots 32..37 of y)
    tail_r = torch.cat([state["ytail_r"][:, None], y_r[:, :-1, SLOTS:YS]],
                       dim=1)                                # [B,T,6,64]
    tail_i = torch.cat([state["ytail_i"][:, None], y_i[:, :-1, SLOTS:YS]],
                       dim=1)
    carry = (torch.arange(YS - SLOTS, device=dev)[None, None, :, None]
             < dense["i_temp"][..., None, None])             # [B,T,6,1]
    yo_r = torch.cat([torch.where(carry, tail_r, y_r[:, :, :YS - SLOTS]),
                      y_r[:, :, YS - SLOTS:SLOTS]], dim=2)   # [B,T,32,64]
    yo_i = torch.cat([torch.where(carry, tail_i, y_i[:, :, :YS - SLOTS]),
                      y_i[:, :, YS - SLOTS:SLOTS]], dim=2)
    new_state["ytail_r"] = y_r[:, -1, SLOTS:YS]
    new_state["ytail_i"] = y_i[:, -1, SLOTS:YS]

    has = dense["has_sbr"][..., None, None]                  # [B,T,1,1]
    kx_mask = (kvec[None, :] < kx[:, None]).to(torch.float32)[:, None, None]
    low_mask = torch.where(has != 0.0, kx_mask,
                           (kvec < 32).to(torch.float32))    # [B,T,1,64]
    hf_mask = in_range * has
    zpad = (0, BANDS - 32)
    Xr = (torch.nn.functional.pad(wr[:, :, ADJ: ADJ + SLOTS], zpad) * low_mask
          + yo_r * hf_mask)
    Xi = (torch.nn.functional.pad(wi[:, :, ADJ: ADJ + SLOTS], zpad) * low_mask
          + yo_i * hf_mask)

    if emit_x:
        return (Xr.reshape(B, S, BANDS), Xi.reshape(B, S, BANDS),
                xall_r[:, :, :5], xall_i[:, :, :5], new_state)

    pcm, v_hist = qmf.synthesis(Xr.reshape(B, S, BANDS),
                                Xi.reshape(B, S, BANDS), state["v_hist"])
    new_state["v_hist"] = v_hist
    pcm = pcm.reshape(B, T, 2 * F)
    if out_int16:
        # already in sample units before the 1/32768 normalisation
        return (torch.clamp(torch.round(pcm), -32768.0, 32767.0)
                .to(torch.int16), new_state)
    return pcm * (1.0 / 32768.0), new_state


@functools.lru_cache(maxsize=None)
def jitted_sbr_apply(out_int16: bool = False) -> graphs.Program:
    """sbr_apply compiled as the reference's `jitted_sbr_apply(out_int16)`:
    fn(core_pcm, dense, state, cfg) -> (pcm, new state), one program for
    every header (the cfg planes are an argument, not a key).  The
    reference donates the state; here it goes in and the new state comes
    out as new tensors."""
    return graphs.Program(
        "sbr_apply",
        lambda core_pcm, dense, state, cfg: sbr_apply(core_pcm, dense, state,
                                                      cfg, out_int16),
        (out_int16,))
