"""Batched Parametric Stereo (HE-AAC v2) on tensors.

Counterpart of `aacjax/kernels/ps_batch.py`.  One call turns a [B, T] chunk
of mono SBR-adjusted QMF planes into stereo: the hybrid filterbank's 13-tap
complex filters over the continuous low-band line, the transient detector
and the 3-link allpass decorrelator over the chunk's S = 32 T slots
(`kernels/ps_decorr.py`, one CUDA kernel for the whole decorrelation: the
band powers, the only long recurrences of the HE+PS program, the delay
lines and the gains), the mixing matrices from the host-packed knots
(`host/ps_pack.py`) interpolated per slot, the hybrid synthesis and two QMF
synthesis banks run on the L-stacked-on-R [2B, ...] batch.

The reference computes all of it as XLA.  Its TPU workarounds are not
ported: the HA and phase LUT rows, the per-slot knot selection, the
parameter-to-hybrid band expansions and the imaginary-tail rows are
gathers here (the reference: one-hot products and masked sums, which
select the same values exactly); the decorrelator's recurrences run as
their sequential form in the kernel (the reference: Toeplitz products or
log-depth doubling, which reassociate), and its band powers as sums in
ascending band order (the reference: an indicator product).

Chunk boundaries are exact: the hybrid FIR reads the continuous low-band
line (four rows carried in `hist4`, the SBR stage's eight history rows and
its lookahead), and the delay, allpass and transient states carry between
chunks.  The numerics follow `host/ps_decode.py`, the per-channel float64
path that matches libavcodec.

`jitted_sbr_ps_apply(out_int16, is34)` and `jitted_sbr_ps_apply_dual(
out_int16)` are the SBR + PS programs as the reference jits them: one CUDA
graph per key on the card (runtime/graphs.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from aacjax_torch.host import ps as P
from aacjax_torch.host.ps_decode import _make_filter, _tables
from aacjax_torch.kernels import _build, ps_decorr, qmf
from aacjax_torch.runtime import graphs

SLOTS = 32
MAX_DELAY = 14

# per band mode (20-band, 34-band): hybrid channels, parameter bands,
# allpass bands, the short-delay boundary and the decay cutoff
_NB = (71, 91)
_NPAR = (20, 34)
_NAP = (30, 50)
_SDB = (42, 62)
_DECAY_CUTOFF = (10, 32)
# the 34-band mode's filter set per low QMF band, and both modes' groups of
# hybrid channels that the synthesis sums back into QMF bands
_FSET_34 = (0, 1, 2, 2, 2)
_GROUPS = {False: ((0, 6), (6, 8), (8, 10)),
           True: ((0, 12), (12, 20), (20, 24), (24, 28), (28, 32))}


def _full13(f: np.ndarray) -> np.ndarray:
    """7-tap conjugate-symmetric prototype -> full 13-tap complex filter."""
    full = np.zeros((f.shape[0], 13), np.complex128)
    full[:, :6] = f[:, :6]
    full[:, 6] = f[:, 6].real
    full[:, 7:] = np.conj(f[:, 5::-1])
    return full


@functools.lru_cache(maxsize=None)
def consts_np(is34: bool = False) -> dict:
    """The mode's constants as numpy (f32 values of the reference's
    _consts): 13-tap filters, the 20-band mode's real 2-band split, the
    band maps, the LUTs, the allpass phasors and coefficients."""
    t = _tables()
    pt = P.tables()
    nb, nap = _NB[is34], _NAP[is34]
    out = {}
    if is34:
        fs = [_full13(_make_filter(pt["g0_q12"].astype(np.float64), 12)),
              _full13(_make_filter(pt["g1_q8"].astype(np.float64), 8)),
              _full13(_make_filter(pt["g2_q4"].astype(np.float64), 4))]
    else:
        fs = [_full13(_make_filter(pt["g0_q8"].astype(np.float64), 8))]
        g1 = np.array([0.0, 0.01899487526049, 0.0, -0.07293139167538,
                       0.0, 0.30596630545168, 0.5])
        g2 = np.zeros(13)
        g2[:7] = g1
        g2[7:] = g1[5::-1]
        out["g1_13"] = g2.astype(np.float32)
    out["filt13_r"] = [f.real.astype(np.float32) for f in fs]
    out["filt13_i"] = [f.imag.astype(np.float32) for f in fs]
    out["k_to_i"] = t[f"k_to_i_{34 if is34 else 20}"].astype(np.int64)[:nb]
    out["HA"] = t["HA"].astype(np.float32)                      # [46, 8, 4]
    out["pd_r"] = t["pd_smooth"].real.astype(np.float32)        # [512]
    out["pd_i"] = t["pd_smooth"].imag.astype(np.float32)
    for k in ("phi", "qf"):
        src = t[f"{'phi_fract' if k == 'phi' else 'q_fract'}_{int(is34)}"]
        out[f"{k}_r"] = src.real.astype(np.float32)
        out[f"{k}_i"] = src.imag.astype(np.float32)
    a = np.array([0.65143905753106, 0.56471812200776, 0.48954165955695])
    gds = np.clip(1.0 - 0.05 * (np.arange(nap) - _DECAY_CUTOFF[is34]),
                  0.0, 1.0)
    out["ag"] = (a[None, :] * gds[:, None]).astype(np.float32)  # [nap, 3]
    cm = np.zeros(nb, bool)                 # the negative-centre channels
    cm[slice(9, 14) if is34 else slice(0, 2)] = True
    out["conj_mask"] = cm
    return out


@_build.per_device
def _consts(is34: bool, device: torch.device) -> dict:
    """consts_np on `device`: the complex filters of each low QMF band as
    one real [26, 2q] matrix (the window's re | im rows against the
    filter's re | im columns), the rest as tensors."""
    c = consts_np(is34)
    out = {}
    mats = []
    for fr, fi in zip(c["filt13_r"], c["filt13_i"]):
        # [wr | wi] @ [[fr^T, fi^T], [-fi^T, fr^T]] = [re | im] of w * f
        mats.append(np.block([[fr.T, fi.T], [-fi.T, fr.T]]))
    out["fir"] = [torch.from_numpy(np.ascontiguousarray(m)).to(device)
                  for m in mats]
    for k in ("g1_13", "HA", "pd_r", "pd_i", "phi_r", "phi_i", "qf_r", "qf_i",
              "ag"):
        if k in c:
            out[k] = torch.from_numpy(np.ascontiguousarray(c[k])).to(device)
    out["k_to_i"] = torch.from_numpy(c["k_to_i"]).to(device)
    out["conj_mask"] = torch.from_numpy(c["conj_mask"]).to(device)
    # the decorrelator kernel's band maps (int32)
    out["k_to_i32"] = out["k_to_i"].to(torch.int32)
    out["members"] = torch.from_numpy(
        ps_decorr.member_table(c["k_to_i"], _NPAR[is34])).to(device)
    return out


def ps_state_init(B: int, is34: bool, device: str | torch.device) -> dict:
    """The zeroed PS state of B rows in one band mode (the reference's names
    and shapes)."""
    nb, nap, npar = _NB[is34], _NAP[is34], _NPAR[is34]

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return dict(
        hist4_r=z(B, 4, 5), hist4_i=z(B, 4, 5),
        delay_r=z(B, nb, MAX_DELAY), delay_i=z(B, nb, MAX_DELAY),
        ap_r=z(B, nap, 3, 5), ap_i=z(B, nap, 3, 5),
        peak=z(B, npar), psmooth=z(B, npar), pdiff=z(B, npar),
        v_l=z(B, qmf.SYN_HIST, 128), v_r=z(B, qmf.SYN_HIST, 128))


def _hybrid_analysis(Xr, Xi, lo_r, lo_i, c, is34: bool):
    """Xr / Xi [B,S,64] (HF and low bands per slot); lo_r / lo_i [B,S+12,5]
    the continuous low-band line with 6 slots of history and 6 of
    lookahead.  Returns s [B,S,nb] complex as (re, im)."""
    S = Xr.shape[1]

    def fir(qb, fset):
        # the 13-tap window of slot s is rows s..s+12 of the band's line
        w = torch.cat([lo_r[:, :, qb].unfold(1, 13, 1),
                       lo_i[:, :, qb].unfold(1, 13, 1)], dim=-1)  # [B,S,26]
        out = torch.matmul(w, c["fir"][fset])                    # [B,S,2q]
        q = out.shape[-1] // 2
        return out[..., :q], out[..., q:]

    if is34:
        parts = [fir(qb, fs) for qb, fs in enumerate(_FSET_34)]
        return (torch.cat([p[0] for p in parts] + [Xr[:, :, 5:]], dim=-1),
                torch.cat([p[1] for p in parts] + [Xi[:, :, 5:]], dim=-1))
    sub_r, sub_i = fir(0, 0)
    # fold: singles 6, 7, 0, 1, then the pairs 2 + 5 and 3 + 4
    def fold(sub):
        return torch.stack([sub[..., 6], sub[..., 7], sub[..., 0],
                            sub[..., 1], sub[..., 2] + sub[..., 5],
                            sub[..., 3] + sub[..., 4]], dim=-1)
    outs_r, outs_i = [fold(sub_r)], [fold(sub_i)]
    g1 = c["g1_13"]
    for qb, rev in ((1, True), (2, False)):
        pair = []
        for lo in (lo_r, lo_i):
            w = lo[:, :, qb].unfold(1, 13, 1)                     # [B,S,13]
            mid = torch.matmul(w, g1)
            # g1 is symmetric: mid holds the centre tap plus the rest
            ctr = w[..., 6] * g1[6]
            op = mid - ctr
            plus, minus = ctr + op, ctr - op
            pair.append(torch.stack([minus, plus] if rev else [plus, minus],
                                    dim=-1))
        outs_r.append(pair[0])
        outs_i.append(pair[1])
    return (torch.cat(outs_r + [Xr[:, :, 3:]], dim=-1),
            torch.cat(outs_i + [Xi[:, :, 3:]], dim=-1))            # [B,S,71]


def _decorrelate(s_r, s_i, state: dict, c, is34: bool):
    """Transient-attenuated allpass decorrelation of s [B,S,nb] -> d
    [B,S,nb] (re, im) and the new decorrelator state: one launch of the
    decorrelator kernel on the card (`kernels/ps_decorr.py`)."""
    return ps_decorr.decorrelate_chunk(s_r, s_i, state, c, _SDB[is34])


def _mixing_h(dense: dict, c, is34: bool):
    """The host-packed knots -> per-slot H [B,T,32,npar,4] (re, im) and the
    imneg track (the interpolation of the negated imaginary start, for the
    negative-centre channels).

    Knot 0 (the carry from the previous frame) arrives as explicit H values
    (ps_h0_r / ps_h0_i); envelope knots are LUT rows, with the imaginary
    part at and past the IPD cut replaced by the chunk-constant tail row
    that ps_hslot picks from ps_himag (0 = none)."""
    npar = _NPAR[is34]
    cut = 17 if is34 else 11
    dev = c["HA"].device
    ha = dense["ps_ha"][..., :npar].long()                    # [B,T,6,npar]
    ic = dense["ps_icc"][..., :npar].long()
    base = c["HA"].reshape(-1, 4)[ha.clamp(min=0) * c["HA"].shape[1] + ic]
    base = torch.where((ha >= 0)[..., None], base, 0.0)       # [B,T,6,npar,4]
    opd, ipd = dense["ps_opd"].long(), dense["ps_ipd"].long() # [B,T,6,17]
    o_r, o_i = c["pd_r"][opd], c["pd_i"][opd]
    i_r, i_i = c["pd_r"][ipd], c["pd_i"][ipd]
    adj_r = o_r * i_r + o_i * i_i                             # opd * conj(ipd)
    adj_i = o_i * i_r - o_r * i_i
    rot_r = torch.stack([o_r, adj_r, o_r, adj_r], dim=-1)     # [B,T,6,17,4]
    rot_i = torch.stack([o_i, adj_i, o_i, adj_i], dim=-1)
    pad = rot_r.shape[:3] + (npar - 17, 4)
    rot_r = torch.cat([rot_r, torch.ones(pad, device=dev)], dim=3)
    rot_i = torch.cat([rot_i, torch.zeros(pad, device=dev)], dim=3)
    K_r = base * rot_r
    K_i = base * rot_i
    # the imaginary tail: row ps_hslot - 1 of the slot's ps_himag
    B = ha.shape[0]
    himag = torch.cat([torch.zeros((B, 1, npar, 4), device=dev),
                       dense["ps_himag"][:, :, :npar]], dim=1)  # [B,5,npar,4]
    hs = dense["ps_hslot"].long()                             # [B,T,6]
    tail = himag[torch.arange(B, device=dev)[:, None, None], hs]
    past_cut = (torch.arange(npar, device=dev) >= cut)[:, None]
    K_i = torch.where(past_cut, tail, K_i)
    # knot 0: the explicit carry values
    K_r = torch.cat([dense["ps_h0_r"][:, :, None, :npar], K_r[:, :, 1:]],
                    dim=2)
    K_i = torch.cat([dense["ps_h0_i"][:, :, None, :npar], K_i[:, :, 1:]],
                    dim=2)

    def knot_sel(K, idx):
        """K [B,T,6,npar,4] at knot idx [B,T,32] -> [B,T,32,npar,4]."""
        i = idx.long()[..., None, None].expand(*idx.shape, *K.shape[3:])
        return torch.gather(K, 2, i)

    lo_r, lo_i = knot_sel(K_r, dense["ps_knot_lo"]), knot_sel(
        K_i, dense["ps_knot_lo"])
    hi_r, hi_i = knot_sel(K_r, dense["ps_knot_hi"]), knot_sel(
        K_i, dense["ps_knot_hi"])
    al = dense["ps_alpha"][..., None, None]                   # [B,T,32,1,1]
    h_r = (1.0 - al) * lo_r + al * hi_r
    h_i = (1.0 - al) * lo_i + al * hi_i
    h_imneg = -(1.0 - al) * lo_i + al * hi_i
    return h_r, h_i, h_imneg


def ps_apply(Xr, Xi, xall_lo_r, xall_lo_i, dense: dict, state: dict,
             is34: bool = False):
    """Mono SBR planes -> stereo PCM.  Xr / Xi [B,S,64] (32768 scale);
    xall_lo_r / _i [B,8+S,5] the SBR stage's continuous low-band line (8
    history rows, then S; its last 6 rows are this chunk's lookahead);
    dense the ps_pack planes as tensors.  Returns (pcm_l, pcm_r [B, S*64]
    in the 32768 scale, new state); the input state is not modified."""
    c = _consts(is34, Xr.device)
    B, S, _ = Xr.shape
    nb = _NB[is34]
    # X slot n lives at xall row n + 2 and the FIR needs slots n-6..n+6:
    # four carried rows in front make row r of `lo` slot r - 6
    lo_r = torch.cat([state["hist4_r"], xall_lo_r], dim=1)
    lo_i = torch.cat([state["hist4_i"], xall_lo_i], dim=1)
    s_r, s_i = _hybrid_analysis(Xr, Xi, lo_r, lo_i, c, is34)
    d_r, d_i, dec_state = _decorrelate(s_r, s_i, state, c, is34)
    h_r, h_i, h_imneg = _mixing_h(dense, c, is34)
    # parameter band -> hybrid channel; the negative-centre channels take
    # the imneg track (a select, exact)
    k = c["k_to_i"]
    hk_r = h_r[..., k, :].reshape(B, S, nb, 4)
    hk_i = torch.where(c["conj_mask"][:, None], h_imneg[..., k, :],
                       h_i[..., k, :]).reshape(B, S, nb, 4)

    def mix(j_direct, j_decorr):
        """s * H[j_direct] + d * H[j_decorr] (complex)."""
        hd_r, hd_i = hk_r[..., j_direct], hk_i[..., j_direct]
        hx_r, hx_i = hk_r[..., j_decorr], hk_i[..., j_decorr]
        return (s_r * hd_r - s_i * hd_i + (d_r * hx_r - d_i * hx_i),
                s_r * hd_i + s_i * hd_r + (d_r * hx_i + d_i * hx_r))

    # the rest runs on the L-stacked-on-R [2B, ...] batch (row-local)
    (l_r, l_i), (r_r, r_i) = mix(0, 2), mix(1, 3)
    ch_r = torch.cat([l_r, r_r], dim=0)                        # [2B,S,nb]
    ch_i = torch.cat([l_i, r_i], dim=0)
    groups = _GROUPS[is34]
    top = groups[-1][1]

    def hybrid_synthesis(ch):
        sums = [ch[..., a:b].sum(dim=-1, keepdim=True) for a, b in groups]
        return torch.cat(sums + [ch[..., top:]], dim=-1)          # [2B,S,64]

    has = (dense["ps_has"] != 0.0).repeat_interleave(SLOTS, dim=1)  # [B,S]
    has2 = torch.cat([has, has], dim=0)[..., None]
    Xo_r = torch.where(has2, hybrid_synthesis(ch_r), torch.cat([Xr, Xr]))
    Xo_i = torch.where(has2, hybrid_synthesis(ch_i), torch.cat([Xi, Xi]))
    pcm, v = qmf.synthesis(Xo_r, Xo_i,
                           torch.cat([state["v_l"], state["v_r"]], dim=0))
    new_state = dict(state)
    new_state.update(dec_state)
    new_state["hist4_r"] = xall_lo_r[:, S - 4:S]
    new_state["hist4_i"] = xall_lo_i[:, S - 4:S]
    new_state["v_l"], new_state["v_r"] = v[:B], v[B:]
    return pcm[:B], pcm[B:], new_state


def _route(pcm_l, pcm_r, ps_dense: dict, B: int, T: int, F: int,
           out_int16: bool):
    """Output slot c emits channel role out_role[c] (0 L, 1 R) of source
    slot out_src[c]; int16 samples or the 1/32768 scale."""
    src = ps_dense["out_src"].long()
    role = ps_dense["out_role"][:, None]
    out = torch.where(role != 0, pcm_r[src], pcm_l[src]).reshape(B, T, 2 * F)
    if out_int16:
        return torch.clamp(torch.round(out), -32768.0, 32767.0).to(
            torch.int16)
    return out * (1.0 / 32768.0)


def _contiguous(state: dict) -> dict:
    # the state outlives the chunk's large intermediates
    return {k: v.contiguous() for k, v in state.items()}


def sbr_ps_apply(core_pcm, dense, ps_dense, state, ps_state, cfg,
                 out_int16: bool = False, is34: bool = False):
    """Core PCM [B,T,F] -> SBR -> PS -> stereo PCM routed to the output
    slots (ps_dense out_src / out_role).  Returns (pcm [B,T,2F], new SBR
    state, new PS state); the PS stage owns the synthesis, so the SBR
    state's v_hist passes through."""
    from aacjax_torch.kernels.sbr_batch import sbr_apply
    B, T, F = core_pcm.shape
    Xr, Xi, lo_r, lo_i, new_state = sbr_apply(core_pcm, dense, state, cfg,
                                              emit_x=True)
    new_state["v_hist"] = state["v_hist"]
    pcm_l, pcm_r, new_ps = ps_apply(Xr, Xi, lo_r, lo_i, ps_dense, ps_state,
                                    is34)
    return (_route(pcm_l, pcm_r, ps_dense, B, T, F, out_int16), new_state,
            _contiguous(new_ps))


def sbr_ps_apply_dual(core_pcm, dense, ps_dense, state, ps_state20,
                      ps_state34, cfg, out_int16: bool = False):
    """A batch that mixes 20- and 34-band slots: the SBR stage runs once,
    both band modes' PS run over the whole batch, each with its own state,
    and the per-slot mask ps_dense['slot_is34'] picks which one a slot
    emits.  A slot's rows in the other mode's state are don't-care values
    that are never read (a mode switch re-seeds through the float64
    replay).  Returns (pcm, new SBR state, new 20-band and 34-band PS
    states)."""
    from aacjax_torch.kernels.sbr_batch import sbr_apply
    B, T, F = core_pcm.shape
    Xr, Xi, lo_r, lo_i, new_state = sbr_apply(core_pcm, dense, state, cfg,
                                              emit_x=True)
    new_state["v_hist"] = state["v_hist"]
    l20, r20, nps20 = ps_apply(Xr, Xi, lo_r, lo_i, ps_dense, ps_state20, False)
    l34, r34, nps34 = ps_apply(Xr, Xi, lo_r, lo_i, ps_dense, ps_state34, True)
    m34 = (ps_dense["slot_is34"] != 0.0)[:, None]
    pcm_l = torch.where(m34, l34, l20)
    pcm_r = torch.where(m34, r34, r20)
    return (_route(pcm_l, pcm_r, ps_dense, B, T, F, out_int16), new_state,
            _contiguous(nps20), _contiguous(nps34))


@functools.lru_cache(maxsize=None)
def jitted_sbr_ps_apply(out_int16: bool = False,
                        is34: bool = False) -> graphs.Program:
    """sbr_ps_apply compiled as the reference's
    `jitted_sbr_ps_apply(out_int16, is34)`: fn(core_pcm, dense, ps_dense,
    state, ps_state, cfg) -> (pcm, new SBR state, new PS state), one CUDA
    graph per key on the card, the decorrelator kernel's launch inside it.
    The reference also keys on its env-selected scan and LUT forms, which
    the port does not have (one form each)."""
    return graphs.Program(
        "sbr_ps_apply",
        lambda core_pcm, dense, ps_dense, state, ps_state, cfg: sbr_ps_apply(
            core_pcm, dense, ps_dense, state, ps_state, cfg, out_int16, is34),
        (out_int16, is34))


@functools.lru_cache(maxsize=None)
def jitted_sbr_ps_apply_dual(out_int16: bool = False) -> graphs.Program:
    """sbr_ps_apply_dual compiled as the reference's
    `jitted_sbr_ps_apply_dual(out_int16)`: fn(core_pcm, dense, ps_dense,
    state, ps20, ps34, cfg) -> (pcm, new SBR state, new 20-band and 34-band
    PS states)."""
    return graphs.Program(
        "sbr_ps_apply_dual",
        lambda core_pcm, dense, ps_dense, state, ps20, ps34, cfg:
        sbr_ps_apply_dual(core_pcm, dense, ps_dense, state, ps20, ps34, cfg,
                          out_int16), (out_int16,))
