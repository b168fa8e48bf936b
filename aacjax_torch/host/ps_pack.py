"""Host-side dense packing for the batched device Parametric Stereo
stage (kernels/ps_batch.py).

The device receives LUT *indices*, not mixing values: per frame and
knot, the HA-table row (iid+offset), the ICC column, and the 9-bit
smoothed-phase indices — a few hundred bytes per channel-frame instead
of tens of kilobytes of complex matrices.  Knot 0 is the carry (the
previous frame's final envelope), so the device needs no cross-frame H
state; the host tracks it here (PSPackState), exactly like the numpy
reference path tracks PSProc.h_prev and the phase histories.

Semantics are shared with the reference path through
ps_decode.resolve_frame_indices (parameter-band maps, phase-history
smoothing, the ipdopd-off reset); equality of the two paths is enforced
in tests/test_ps_batch.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from aacjax_torch.host.ps_decode import (NR_PAR_BANDS, _tables as _ps_tables,
                                   resolve_frame_indices)

SLOTS = 32
MAX_KNOTS = 6           # carry + up to 5 envelopes (incl. the fixup one)


@dataclass
class PSPackState:
    """Per-slot host-side sequential PS state for the batched path."""
    # previous frame's final H matrices (knot 0 of the next frame) as
    # VALUES — an exact mirror of PSProc.h_prev.  Explicit values (not
    # LUT indices) make every cross-frame carry expressible on device:
    # IPD/OPD-off spans (real carry), off->on resumes (stored imag),
    # and post-band-flip remapped carries (re-adoption)
    h_prev: np.ndarray = field(
        default_factory=lambda: np.zeros((34, 4), np.complex128))
    ipd_hist: np.ndarray = field(default_factory=lambda: np.zeros(17, np.int64))
    opd_hist: np.ndarray = field(default_factory=lambda: np.zeros(17, np.int64))
    ps_prev: object = None          # last PSData (replayed when absent)
    is34_prev: bool | None = None
    # shadow of PSProc.h_slot_imag (per-envelope-slot imaginary H): the
    # device reads its rows as the chunk-constant imaginary tail for
    # bands >= the IPD cut (nonzero only after a band-scheme switch,
    # libavcodec's never-rewritten stale values), and a slot that turns
    # sticky seeds the numpy fallback from the same shadow
    h_slot_imag: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 34, 4)))


@dataclass
class PSDense:
    """Dense per-[B, T] arrays for the device PS stage."""
    ha_idx: np.ndarray      # [B,T,6,34] i32  HA row per knot/band (-1 = 0)
    icc_idx: np.ndarray     # [B,T,6,34] i32
    opd_pd: np.ndarray      # [B,T,6,17] i32  9-bit phase idx (0=identity)
    ipd_pd: np.ndarray      # [B,T,6,17] i32
    h0_r: np.ndarray        # [B,T,34,4] f32  knot-0 carry H (values)
    h0_i: np.ndarray        # [B,T,34,4] f32
    hslot: np.ndarray       # [B,T,6] i8  imag-tail row per knot (0 = none)
    knot_lo: np.ndarray     # [B,T,32] i32  interpolation knots per slot
    knot_hi: np.ndarray     # [B,T,32] i32
    alpha: np.ndarray       # [B,T,32] f32
    ipd_on: np.ndarray      # [B,T] f32  1 = complex H this frame
    has_ps: np.ndarray      # [B,T] f32  1 = PS processing (else L=R=mono)


def alloc_ps_dense(B: int, T: int) -> PSDense:
    return PSDense(
        ha_idx=np.full((B, T, MAX_KNOTS, 34), -1, np.int32),
        icc_idx=np.zeros((B, T, MAX_KNOTS, 34), np.int32),
        opd_pd=np.zeros((B, T, MAX_KNOTS, 17), np.int32),
        ipd_pd=np.zeros((B, T, MAX_KNOTS, 17), np.int32),
        h0_r=np.zeros((B, T, 34, 4), np.float32),
        h0_i=np.zeros((B, T, 34, 4), np.float32),
        hslot=np.zeros((B, T, MAX_KNOTS), np.int8),
        knot_lo=np.zeros((B, T, SLOTS), np.int32),
        knot_hi=np.zeros((B, T, SLOTS), np.int32),
        alpha=np.zeros((B, T, SLOTS), np.float32),
        ipd_on=np.zeros((B, T), np.float32),
        has_ps=np.zeros((B, T), np.float32),
    )


def himag_plane(pack_states: list, B: int) -> np.ndarray:
    """Per-slot chunk-constant imaginary-tail plane [B, 4, 34, 4] f32 —
    rows 1..4 of each slot's h_slot_imag shadow.  The device only reads
    columns at/past the IPD cut, which are never rewritten in-mode, so
    a chunk-start snapshot is exact for the whole chunk."""
    out = np.zeros((B, 4, 34, 4), np.float32)
    for s, st in enumerate(pack_states):
        if st is not None and st.ps_prev is not None:
            out[s] = st.h_slot_imag[1:5]
    return out


def dense_to_dict(d: PSDense, himag: np.ndarray, out_src: np.ndarray,
                  out_role: np.ndarray) -> dict:
    """The device-facing ps_dense dict for kernels.ps_batch."""
    return dict(
        ps_ha=d.ha_idx, ps_icc=d.icc_idx,
        ps_opd=d.opd_pd, ps_ipd=d.ipd_pd,
        ps_h0_r=d.h0_r, ps_h0_i=d.h0_i,
        ps_hslot=d.hslot, ps_himag=himag,
        ps_knot_lo=d.knot_lo, ps_knot_hi=d.knot_hi,
        ps_alpha=d.alpha, ps_has=d.has_ps,
        out_src=out_src, out_role=out_role)


def pack_ps_frame(dense: PSDense, slot: int, t: int, st: PSPackState,
                  ps) -> bool:
    """Pack one frame's PS parameters for `slot` in the frame's OWN band
    mode (the dense planes are 34-padded and mode-agnostic; the device
    program selects the slot's mode by its per-slot mask, so 20- and
    34-band slots mix freely in one batch).  ps may be None (frame
    without ps_data: the previous frame's parameters replay, matching
    apply_ps).  Returns False only when the frame needs the numpy
    fallback: a band-scheme SWITCH with carried state."""
    if ps is None:
        ps = st.ps_prev
    if ps is None:
        return True              # no parameters yet: kernel emits L=R=mono
    if st.is34_prev is not None and st.is34_prev != bool(ps.is34):
        # band-scheme switch: the carried H must be REMAPPED between
        # parameter-band schemes (apply_ps, mirroring libavcodec's
        # map_val_34_to_20/_20_to_34) — remapped VALUES cannot be
        # expressed as HA-LUT indices, so the slot goes sticky and the
        # warm-seeded numpy path owns the flip (even when the flip
        # lands exactly on a chunk boundary)
        return False
    st.is34_prev = bool(ps.is34)
    st.ps_prev = ps
    npar = NR_PAR_BANDS[ps.is34]
    cut = 17 if ps.is34 else 11

    ha, ic, opd_pd, ipd_pd, ipdopd = resolve_frame_indices(
        ps, st.ipd_hist, st.opd_hist)
    num_env = ps.num_env

    dense.has_ps[slot, t] = 1.0
    dense.ipd_on[slot, t] = 1.0 if ipdopd else 0.0
    # knot 0 = carry, shipped as explicit H values (apply_ps's prev_h:
    # the full stored matrices when ipdopd is on this frame — including
    # an off->on resume's stored imaginary components — and their real
    # part only on real frames)
    prev_h = st.h_prev if ipdopd else st.h_prev.real.astype(np.complex128)
    dense.h0_r[slot, t] = prev_h.real
    dense.h0_i[slot, t] = prev_h.imag
    for e in range(num_env):
        dense.ha_idx[slot, t, e + 1, :npar] = ha[e]
        dense.icc_idx[slot, t, e + 1, :npar] = ic[e]
        dense.opd_pd[slot, t, e + 1, :] = opd_pd[e]
        dense.ipd_pd[slot, t, e + 1, :] = ipd_pd[e]
        if ipdopd:
            # per-envelope imaginary tail row (bands >= cut)
            dense.hslot[slot, t, e + 1] = min(e + 1, 4)

    # per-slot interpolation weights between knots
    borders = ps.border_position
    for e in range(num_env):
        start = int(borders[e])
        stop = min(int(borders[e + 1]), SLOTS - 1)
        width = 1.0 / max(stop - start, 1)
        for n in range(start + 1, stop + 1):
            dense.knot_lo[slot, t, n] = e
            dense.knot_hi[slot, t, n] = e + 1
            dense.alpha[slot, t, n] = (n - start) * width
    # slots at/before the first border (start = -1 covers slot 0 already;
    # defensive for odd grids) and after the last hold the nearest knot
    first = int(borders[0])
    for n in range(0, first + 1):
        dense.knot_lo[slot, t, n] = 0
        dense.knot_hi[slot, t, n] = 0
        dense.alpha[slot, t, n] = 0.0
    last = min(int(borders[num_env]), SLOTS - 1)
    for n in range(last + 1, SLOTS):
        dense.knot_lo[slot, t, n] = num_env
        dense.knot_hi[slot, t, n] = num_env
        dense.alpha[slot, t, n] = 1.0

    # shadow the per-envelope-slot imaginary H exactly like apply_ps
    # (written only below the IPD cut, only on ipdopd frames)
    t_ = _ps_tables()
    if ipdopd:
        for e in range(num_env):
            base = t_["HA"][ha[e, :cut], ic[e, :cut]].astype(np.complex128)
            o = t_["pd_smooth"][opd_pd[e, :cut]]
            adj = o * np.conj(t_["pd_smooth"][ipd_pd[e, :cut]])
            sl = st.h_slot_imag[min(e + 1, 4)]
            sl[:cut, 0] = (base[:, 0] * o).imag
            sl[:cut, 1] = (base[:, 1] * adj).imag
            sl[:cut, 2] = (base[:, 2] * o).imag
            sl[:cut, 3] = (base[:, 3] * adj).imag

    # carry for the next frame: mirror apply_ps's h_prev update — the
    # final envelope's H target (phases + stored imag tail), or, on a
    # frame with no envelopes, the unchanged carry; real frames swap in
    # the stored per-slot imaginary row (ffmpeg's unconditional
    # env-slot-0 copy)
    new_h = np.zeros((34, 4), np.complex128)
    if num_env:
        e = num_env - 1
        ht = t_["HA"][ha[e], ic[e]].astype(np.complex128)     # [npar, 4]
        if ipdopd:
            o = t_["pd_smooth"][opd_pd[e, :cut]]
            adj = o * np.conj(t_["pd_smooth"][ipd_pd[e, :cut]])
            ht[:cut, 0] *= o
            ht[:cut, 1] *= adj
            ht[:cut, 2] *= o
            ht[:cut, 3] *= adj
            ht[cut:npar] = (ht[cut:npar].real
                            + 1j * st.h_slot_imag[min(e + 1, 4),
                                                  cut:npar])
        new_h[:npar] = ht
    else:
        new_h[:] = prev_h
    if not ipdopd:
        new_h = new_h.real + 1j * st.h_slot_imag[min(num_env, 4)]
    st.h_prev = new_h
    return True
