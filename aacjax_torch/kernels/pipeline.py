"""The batched device decode step, for native-parsed and python-packed chunks.

Counterpart of `aacjax/kernels/pipeline.py`.  Two entry points over a dense
[C, T, F] chunk (C channel slots across all streams, T frames, F the frame
length: 1024, 960, 512 or 480):

`decode_spec_step` takes what the native parser produces: it has already
fused dequantization, PNS, M/S and intensity into final spectra, so the
device runs Main-profile prediction, TNS, the coupling entries that must
follow TNS, the filterbank (IMDCT or the ELD low-delay synthesis), the
cross-frame overlap-add, time-domain coupling, concealment and the PCM pack.

`decode_step` takes what `runtime/pack.py` packs from python-parsed frames
(quantized values, per-bin scales, stereo pairs and coupling lists) and runs
every spectral tool on the device: dequantization, M/S, prediction,
intensity, coupling before and after TNS, TNS, the filterbank, coupling on
the PCM.

Both route a chunk as the reference routes it.  With `flags.use_pallas` the
hand-written kernels run: the fused tail where `tail.supported` holds (on
compact int16 spectra directly when there is no TNS), else the synthesis
kernel plus `overlap_add` at F == 1024, for any C*T; the TNS kernel and the
predictor kernel ahead of either.  Frame lengths 960, 512 and 480 and the
ELD synthesis take the plain `filterbank` / `eld_synthesis` (matrix products
through `torch.matmul`) on the card too: that is the reference's own
routing, whose tail and synthesis kernels take only F == 1024, not a
fallback.  With `use_pallas=False` every stage runs as plain PyTorch (the
reference's XLA route).  On CPU tensors each kernel wrapper runs its plain
version.

`jitted_decode_step` and `jitted_decode_spec_step` are the two steps as the
reference's jitted programs: on the card each is a CUDA graph, captured
once per flags, argument shapes and device and replayed on every later call
(runtime/graphs.py); on CPU tensors the eager step runs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from aacjax_torch import tables
from aacjax_torch.kernels import _build, imdct
from aacjax_torch.kernels import windows as W
from aacjax_torch.runtime import graphs

FRAME = 1024
SHORT = FRAME // 8
TNS_SLOTS = 8
TNS_ORDER = 20
PRED_BINS = 672


@dataclass(frozen=True)
class PipelineFlags:
    """Per-chunk specialisation flags, with the reference's fields."""
    has_stereo: bool = True
    has_tns: bool = False
    has_cce: bool = False     # decode_step's coupling lists
    out_int16: bool = False   # deliver int16 PCM samples (halves the D2H)
    use_pallas: bool = False  # hand-written kernels; False = plain PyTorch
    has_cce_post: bool = False   # AFTER_TNS entries (decode_spec_step)
    has_cce_time: bool = False   # AFTER_IMDCT entries (decode_spec_step)
    spec_i16: bool = False    # block-scaled int16 spectra + [C,T,64] scales
    spec_qsf: bool = False    # raw quantized int16 + a scalefactor per 4 bins
    has_pred: bool = False    # Main-profile backward prediction
    has_short: bool = True    # any EIGHT_SHORT frame in the chunk
    eld: bool = False         # AAC-ELD low-delay filterbank


@_build.per_device
def consts(device: torch.device, frame_len: int = FRAME
           ) -> dict[str, torch.Tensor]:
    """Constant tables on `device` for frames of `frame_len` samples: the
    IMDCT matrices of the plain versions and the window tables, from the
    same numpy functions (kernels/windows.py, a copy of the reference's)
    the reference embeds; and, at 1024, the FFT twiddle table of the
    kernels (kernels/imdct.py, computed in float64, stored as float32
    [imdct.TW_SIZE, 2])."""
    F = frame_len
    tabs = dict(m_long=W.imdct_long_matrix(F), m_short=W.imdct_short_matrix(F),
                f_table=W.first_half_windows(F),
                s_table=W.second_half_windows(F),
                rise=W.short_rise(F), fall=W.short_fall(F))
    if F == FRAME:
        tabs["twiddles"] = imdct.twiddles()
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in tabs.items()}


@_build.per_device
def _qsf_luts(device: torch.device):
    """Dequantization tables of the q/sf transfer, equal to the native
    parser's (float64 pow, then the f32 cast): iq_lut[i] = i^(4/3) for
    i < 8192, sf_lut[s] = 2^((s-100)/4) for s < 256."""
    iq = np.power(np.arange(8192, dtype=np.float64),
                  4.0 / 3.0).astype(np.float32)
    sf = np.power(2.0, (np.arange(256, dtype=np.float64) - 100.0)
                  / 4.0).astype(np.float32)
    return torch.from_numpy(iq).to(device), torch.from_numpy(sf).to(device)


@_build.per_device
def _eld_matrix(device: torch.device, frame_len: int) -> torch.Tensor:
    m = tables.eld_synthesis_matrix(frame_len).astype(np.float32)
    return torch.from_numpy(m).to(device)


def unpack_spec_batch(batch: dict) -> dict:
    """Slice the native parser's packed buffers: meta [C,T,6] int32 into
    contiguous int32 [C,T] planes (f_idx, s_idx, shape_idx,
    prev_shape_idx, is_short, valid) and last_valid [C] (the last valid
    frame per channel, -1 for none); cce_post_idx / cce_time_idx [Q,3] into
    cce_*_src, cce_*_dst, cce_*_t; pred_meta [C,T,3] into pred_mode,
    pred_reset, pred_nbins (pred_used_u8 becomes pred_used and stays
    uint8).  The TNS planes stay packed.  A batch without `meta` (the
    python packer's per-field format) passes through."""
    if "meta" not in batch:
        return batch
    out = dict(batch)
    m = out.pop("meta")
    T = m.shape[1]
    planes = m.permute(2, 0, 1).contiguous()
    for i, k in enumerate(("f_idx", "s_idx", "shape_idx", "prev_shape_idx",
                           "is_short", "valid")):
        out[k] = planes[i]
    t = torch.arange(T, dtype=torch.int32, device=m.device)
    out["last_valid"] = torch.where(planes[5] != 0, t, -1).amax(dim=1).to(
        torch.int32)
    for key in ("post", "time"):
        if f"cce_{key}_idx" in out:
            idx = out.pop(f"cce_{key}_idx").long()
            out[f"cce_{key}_src"] = idx[:, 0]
            out[f"cce_{key}_dst"] = idx[:, 1]
            out[f"cce_{key}_t"] = idx[:, 2]
    if "pred_meta" in out:
        pm = out.pop("pred_meta").permute(2, 0, 1).contiguous()
        out["pred_mode"], out["pred_reset"], out["pred_nbins"] = pm
        out["pred_used"] = out.pop("pred_used_u8")
    return out


def decompress_i16(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Block-scaled int16 -> f32: scale [C,T,F/16] applies per 16-bin block."""
    C, T, F = q.shape
    nb = scale.shape[-1]
    return (q.to(torch.float32).reshape(C, T, nb, F // nb)
            * scale[..., None]).reshape(C, T, F)


def dequant_qsf(q: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """Raw quantized coefficients -> f32 spectra through two table gathers:
    sign(q) * iq_lut[|q|] * sf_lut[sf].  q int16 [C,T,F], |q| <= 8191; sf
    uint8 [C,T,F/4], one scalefactor gain index per 4 bins.  The values are
    those of the native parser's f32 spectra, bit for bit."""
    iq_lut, sf_lut = _qsf_luts(q.device)
    qi = q.to(torch.int32)
    m = iq_lut[qi.abs().long()]
    m = torch.where(qi < 0, -m, m)
    gain = sf_lut[sf.long()]
    C, T, F = q.shape
    return (m.reshape(C, T, F // 4, 4) * gain[..., None]).reshape(C, T, F)


# -- the python packer's spectral tools ---------------------------------------
def dequantize(quant, scale, noise):
    """spec = iq * scale + noise; iq = sign(q) |q|^(4/3) comes from the
    packer as the f32 of a float64 pow, the native parser's rounding."""
    return quant * scale + noise


def _set_rows(spec, rows, values):
    out = spec.clone()
    out[rows] = values
    return out


def stereo(spec, pair_l, pair_r, ms_mask, is_scale):
    """M/S butterfly and intensity stereo on channel pairs.  spec [C,T,F];
    pair_l / pair_r [P] channel indices; ms_mask [P,T,F] nonzero where M/S
    applies; is_scale [P,T,F] nonzero where intensity applies, its value the
    signed scale."""
    pl, pr = pair_l.long(), pair_r.long()
    l, r = spec[pl], spec[pr]
    m = ms_mask != 0
    l2 = torch.where(m, l + r, l)
    r2 = torch.where(m, l - r, r)
    r3 = torch.where(is_scale != 0, l2 * is_scale, r2)
    return _set_rows(_set_rows(spec, pl, l2), pr, r3)


def stereo_ms(spec, pair_l, pair_r, ms_mask):
    """M/S butterflies only (the Main-profile predictor sits between M/S
    and intensity)."""
    pl, pr = pair_l.long(), pair_r.long()
    l, r = spec[pl], spec[pr]
    m = ms_mask != 0
    return _set_rows(_set_rows(spec, pl, torch.where(m, l + r, l)), pr,
                     torch.where(m, l - r, r))


def stereo_is(spec, pair_l, pair_r, is_scale):
    """Intensity stereo only (reads the post-M/S, post-prediction left)."""
    pl, pr = pair_l.long(), pair_r.long()
    l2, r2 = spec[pl], spec[pr]
    return _set_rows(spec, pr, torch.where(is_scale != 0, l2 * is_scale, r2))


def couple_spectral(spec, src, dst, gain):
    """Dependent coupling: spec[dst] += gain * spec[src], reading the
    spectra as they were before any entry.  src / dst [Q]; gain [Q,T,F]
    (zero-padded entries do nothing).  Entries onto one dst accumulate; on
    CUDA through atomic adds, so in an unspecified order."""
    return spec.index_add(0, dst.long(), gain * spec[src.long()])


def couple_time(pcm, src, dst, gain):
    """Independent coupling on time samples after the filterbank:
    pcm[dst] += gain * pcm[src]; gain [Q,T,1], one scalar per frame."""
    return pcm.index_add(0, dst.long(), gain * pcm[src.long()])


def _couple_entries(x, src, dst, tt, gain):
    """x[dst, t] += gain * x[src, t] per entry (src, dst, t).  The gather
    reads x as it was before any entry; entries onto one (dst, t)
    accumulate, on CUDA through atomic adds and so in an unspecified
    order."""
    return x.index_put((dst, tt), gain * x[src, tt], accumulate=True)


# -- filterbanks ----------------------------------------------------------------
def filterbank(spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short,
               has_short: bool = True):
    """IMDCT + windowing of every frame: (first, second) halves [C,T,F].
    first is the frame's own contribution, second the overlap carried into
    the next frame.  Index planes are integer [C,T]; is_short is nonzero
    for EIGHT_SHORT frames.  F is 1024, 960, 512 or 480; the short window
    has F/8 samples."""
    C, T, F = spec.shape
    S = F // 8
    c = consts(spec.device, F)
    long_out = torch.matmul(spec, c["m_long"])                  # [C,T,2F]
    first = long_out[..., :F] * c["f_table"][f_idx.long()]
    second = long_out[..., F:] * c["s_table"][s_idx.long()]
    if not has_short:
        return first, second
    blocks = torch.matmul(spec.reshape(C, T, 8, S), c["m_short"])
    rise_cur = c["rise"][shape_idx.long()]                      # [C,T,S]
    rise_prev = c["rise"][prev_shape_idx.long()]
    fall_cur = c["fall"][shape_idx.long()]
    # block 0's rising half uses the previous frame's window shape
    rises = torch.cat([rise_prev[:, :, None],
                       rise_cur[:, :, None].expand(C, T, 7, S)], dim=2)
    a = blocks[..., :S] * rises
    b = blocks[..., S:] * fall_cur[:, :, None]
    # sub-window w covers [mid + S*w, mid + S*w + 2S): segment s is
    # rising-half[s] + falling-half[s-1]
    segs = torch.cat([a[:, :, :1], a[:, :, 1:] + b[:, :, :7], b[:, :, 7:]],
                     dim=2)
    t_short = torch.zeros((C, T, 2 * F), dtype=spec.dtype, device=spec.device)
    t_short[..., W.mid(F):W.mid(F) + 9 * S] = segs.reshape(C, T, 9 * S)
    sel = (is_short != 0)[..., None]
    return (torch.where(sel, t_short[..., :F], first),
            torch.where(sel, t_short[..., F:], second))


def overlap_add(first, second, overlap_in, last_valid):
    """pcm[t] = first[t] + second[t-1], frame 0 reading overlap_in.  The
    new overlap is second[last_valid]; a channel with last_valid < 0 (no
    frames this chunk) keeps overlap_in."""
    prev = torch.cat([overlap_in[:, None], second[:, :-1]], dim=1)
    lv = last_valid.long()
    carried = second[torch.arange(second.shape[0], device=second.device),
                     lv.clamp(min=0)]
    new_overlap = torch.where((lv >= 0)[:, None], carried, overlap_in)
    return first + prev, new_overlap


def eld_synthesis(spec, overlap_in, last_valid):
    """AAC-ELD low-delay filterbank: y = spec @ M maps a frame's N
    coefficients to 4N output samples (the window folded into M,
    tables.eld_synthesis_matrix); frames accumulate at a stride of N, so
        pcm[t] = y0[t] + y1[t-1] + y2[t-2] + y3[t-3]
    with a [C, 3N] carry across chunks (the three pending segments), taken
    after each channel's last valid frame; a channel with last_valid < 0
    keeps its carry.  The product is a library call (torch.matmul), as it
    is a plain matrix product outside any kernel in the reference."""
    C, T, N = spec.shape
    y = torch.matmul(spec, _eld_matrix(spec.device, N))         # [C,T,4N]
    y0, y1 = y[..., :N], y[..., N:2 * N]
    y2, y3 = y[..., 2 * N:3 * N], y[..., 3 * N:]
    ova = overlap_in[:, None, :N]
    ovb = overlap_in[:, None, N:2 * N]
    ovc = overlap_in[:, None, 2 * N:]
    z = torch.zeros_like(ova)
    pcm = y0 + torch.cat([ova, y1[:, :-1]], dim=1)
    if T >= 2:
        pcm = pcm + torch.cat([z, ovb, y2[:, :-2]], dim=1)
    if T >= 3:
        pcm = pcm + torch.cat([z, z, ovc, y3[:, :-3]], dim=1)
    ci = torch.arange(C, device=spec.device)
    lv = last_valid.long().clamp(min=0)
    y2x = torch.cat([ovb, y2], dim=1)          # [t] = y2[t-1]
    y3x1 = torch.cat([ovc, y3], dim=1)         # [t] = y3[t-1]
    y3x2 = torch.cat([z, ovc, y3], dim=1)      # [t] = y3[t-2]
    new_a = y1[ci, lv] + y2x[ci, lv] + y3x2[ci, lv]
    new_b = y2[ci, lv] + y3x1[ci, lv]
    new_c = y3[ci, lv]
    keep = (last_valid >= 0)[:, None]
    new_overlap = torch.where(keep, torch.cat([new_a, new_b, new_c], dim=1),
                              overlap_in)
    return pcm, new_overlap


def conceal_and_pack(pcm, valid, out_int16: bool):
    """Invalid frames deliver silence; then the PCM pack."""
    return pack_pcm(pcm * (valid != 0)[..., None].to(pcm.dtype), out_int16)


def pack_pcm(pcm, out_int16: bool):
    """int16 samples (round half to even, clip) or the reference's 1/32768
    float scale."""
    if out_int16:
        return torch.clamp(torch.round(pcm), -32768.0, 32767.0).to(torch.int16)
    return pcm * (1.0 / 32768.0)


def _synthesize(spec, b, overlap_in, flags: PipelineFlags):
    """The filterbank and the cross-frame overlap-add of a chunk that does
    not take the fused tail: (pcm, new overlap), before concealment."""
    from aacjax_torch.kernels import synth
    C, T, F = spec.shape
    if flags.eld:
        return eld_synthesis(spec, overlap_in, b["last_valid"])
    idx = (b["f_idx"], b["s_idx"], b["shape_idx"], b["prev_shape_idx"],
           b["is_short"])
    if flags.use_pallas and F == FRAME:
        # any C*T: the Pallas kernel's B % 8 rule is a TPU tiling limit,
        # and the CUDA kernel takes any row count
        first, second = synth.synthesis(
            spec.reshape(C * T, F), *(a.reshape(C * T) for a in idx))
        first, second = first.reshape(C, T, F), second.reshape(C, T, F)
    else:
        # 960, 512 and 480 have no kernel in the reference either: its
        # tail and synthesis kernels take F == 1024 only
        first, second = filterbank(spec, *idx, has_short=flags.has_short)
    return overlap_add(first, second, overlap_in, b["last_valid"])


# -- the two steps ----------------------------------------------------------------
# Each step is front -> prediction (Main profile) -> back.  The steps run the
# three in order; a frame-sharded chunk (runtime/mesh.py) runs the fronts and
# backs shard by shard and hands the predictor state from shard to shard.
def step_front(batch: dict, flags: PipelineFlags) -> torch.Tensor:
    """decode_step up to the predictor: dequantization and stereo (M/S
    only when the predictor follows)."""
    spec = dequantize(batch["quant"], batch["scale"], batch["noise"])
    if flags.has_pred:
        # Main profile: the backward predictor sits between M/S and
        # intensity
        return stereo_ms(spec, batch["pair_l"], batch["pair_r"],
                         batch["ms_mask"])
    if flags.has_stereo:
        return stereo(spec, batch["pair_l"], batch["pair_r"],
                      batch["ms_mask"], batch["is_scale"])
    return spec


def predict(spec, b: dict, pred_state, flags: PipelineFlags,
            inplace: bool = False):
    """The Main-profile predictor over the chunk's frames in order: the
    kernel with flags.use_pallas (updating spec in place when `inplace`),
    else its plain version.  Returns (spec, new state)."""
    from aacjax_torch.kernels import pred
    args = (spec, b["pred_mode"], b["pred_reset"], b["pred_nbins"],
            b["pred_used"], pred_state)
    if flags.use_pallas:
        return pred.apply_prediction(*args, inplace=inplace)
    return pred.apply_prediction_ref(*args)


def step_back(spec, batch: dict, overlap_in: torch.Tensor,
              flags: PipelineFlags):
    """decode_step after the predictor: intensity (Main profile), coupling
    before and after TNS, TNS, the filterbank, coupling on the PCM and the
    pack.  Returns (pcm, new overlap)."""
    from aacjax_torch.kernels import tns
    tns_fn = tns.tns if flags.use_pallas else tns.tns_ref
    if flags.has_pred:
        spec = stereo_is(spec, batch["pair_l"], batch["pair_r"],
                         batch["is_scale"])
    if flags.has_cce:
        spec = couple_spectral(spec, batch["cce_src_pre"],
                               batch["cce_dst_pre"], batch["cce_gain_pre"])
    if flags.has_tns:
        spec = tns_fn(spec, batch["tns_fwd_lpc"], batch["tns_fwd_start"],
                      batch["tns_fwd_end"], batch["tns_rev_lpc"],
                      batch["tns_rev_start"], batch["tns_rev_end"])
    if flags.has_cce:
        spec = couple_spectral(spec, batch["cce_src_post"],
                               batch["cce_dst_post"], batch["cce_gain_post"])
    pcm, new_overlap = _synthesize(spec, batch, overlap_in, flags)
    if flags.has_cce:
        pcm = couple_time(pcm, batch["cce_src_time"], batch["cce_dst_time"],
                          batch["cce_gain_time"])
    return pack_pcm(pcm, flags.out_int16), new_overlap


def decode_step(batch: dict, overlap_in: torch.Tensor, flags: PipelineFlags,
                pred_state: torch.Tensor | None = None):
    """Decode one chunk packed by `runtime.pack.pack_frames` (tensors on one
    device; index planes int32).  Returns (pcm [C,T,F] in the 1/32768 float
    scale or int16, new overlap), plus the new predictor state when
    flags.has_pred."""
    spec = step_front(batch, flags)
    if flags.has_pred:
        spec, pred_state = predict(spec, batch, pred_state, flags)
    out = step_back(spec, batch, overlap_in, flags)
    return (*out, pred_state) if flags.has_pred else out


def spec_front(b: dict, flags: PipelineFlags):
    """decode_spec_step up to the predictor, on an unpacked batch: the f32
    spectra, or None where the TNS kernel reads the compact int16 spectra
    as they arrive."""
    if flags.spec_qsf:
        return dequant_qsf(b["spec_q"], b["spec_sf"])
    if flags.spec_i16 and not _packed_tns(flags):
        return decompress_i16(b["spec_i16"], b["spec_scale"])
    if not flags.spec_i16:
        return b["spec"]
    return None


def _packed_tns(flags: PipelineFlags) -> bool:
    return flags.has_tns and flags.spec_i16 and not flags.has_pred


def spec_back(spec, b: dict, overlap_in: torch.Tensor, flags: PipelineFlags):
    """decode_spec_step after the predictor, on an unpacked batch: TNS,
    coupling after TNS, the fused tail or the filterbank and overlap-add,
    coupling on the PCM, concealment and the pack.  Returns (pcm, new
    overlap)."""
    from aacjax_torch.kernels import tail, tns
    spec_arr = spec if spec is not None else b["spec_i16"]
    C, T, F = spec_arr.shape
    if flags.has_tns:
        tns_fn = tns.tns_packed if flags.use_pallas else tns.tns_packed_ref
        # the TNS kernel reads compact spectra as they arrive
        spec = (tns_fn(b["spec_i16"], b["spec_scale"], b["tns_lpc"],
                       b["tns_range"]) if _packed_tns(flags)
                else tns_fn(spec, None, b["tns_lpc"], b["tns_range"]))
    if flags.has_cce_post:
        # AFTER_TNS dependent coupling onto TNS'd targets
        spec = _couple_entries(spec, b["cce_post_src"], b["cce_post_dst"],
                               b["cce_post_t"], b["cce_post_gain"])
    if flags.use_pallas and tail.supported(flags, C, T, F):
        return tail.decode_tail(
            spec, None, b["f_idx"], b["s_idx"], b["shape_idx"],
            b["prev_shape_idx"], b["is_short"], b["valid"], b["last_valid"],
            overlap_in, out_int16=flags.out_int16, has_short=flags.has_short)
    pcm, new_overlap = _synthesize(spec, b, overlap_in, flags)
    if flags.has_cce_time:
        # AFTER_IMDCT independent coupling on time samples: the coupling
        # channel went through its own slot's filterbank
        pcm = _couple_entries(pcm, b["cce_time_src"], b["cce_time_dst"],
                              b["cce_time_t"], b["cce_time_gain"][:, None])
    return conceal_and_pack(pcm, b["valid"], flags.out_int16), new_overlap


def decode_spec_step(batch: dict, overlap_in: torch.Tensor,
                     flags: PipelineFlags,
                     pred_state: torch.Tensor | None = None):
    """Decode one native-parsed chunk.  batch holds meta [C,T,6] and the
    spectra in one of three forms (spec f32; spec_i16 + spec_scale; spec_q +
    spec_sf), plus tns_lpc / tns_range when flags.has_tns, pred_meta /
    pred_used_u8 when flags.has_pred, and cce_post_idx / cce_post_gain,
    cce_time_idx / cce_time_gain when the coupling flags are set.  Returns
    (pcm [C,T,F] int16 or f32, new overlap), plus the new predictor state
    when flags.has_pred.

    With flags.use_pallas the step consumes its batch: the predictor kernel
    updates batch['spec'] in place.  The plain route leaves it untouched."""
    from aacjax_torch.kernels import tail

    b = unpack_spec_batch(batch)
    spec_arr = (b["spec_q"] if flags.spec_qsf else b["spec_i16"]
                if flags.spec_i16 else b["spec"])
    C, T, F = spec_arr.shape
    if (flags.use_pallas and tail.supported(flags, C, T, F)
            and flags.spec_i16 and not flags.has_tns):
        # fully fused: the kernel decompresses the int16 spectra itself
        return tail.decode_tail(
            b["spec_i16"], b["spec_scale"], b["f_idx"], b["s_idx"],
            b["shape_idx"], b["prev_shape_idx"], b["is_short"], b["valid"],
            b["last_valid"], overlap_in, out_int16=flags.out_int16,
            has_short=flags.has_short)
    spec = spec_front(b, flags)
    if flags.has_pred:
        # the native parser fuses M/S (which precedes prediction) on the
        # host and delegates intensity and coupling content (which must
        # follow it), so the stage runs first here
        spec, pred_state = predict(spec, b, pred_state, flags, inplace=True)
    out = spec_back(spec, b, overlap_in, flags)
    return (*out, pred_state) if flags.has_pred else out


# -- the compiled steps -----------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jitted_decode_step(flags: PipelineFlags) -> graphs.Program:
    """decode_step compiled as the reference's `jitted_decode_step(flags)`:
    fn(batch, overlap[, pred_state]) -> decode_step's results, a CUDA graph
    per key on the card, the eager step on CPU tensors.  The reference
    donates the overlap and the predictor state; here they go in and their
    successors come out as new tensors (runtime/graphs.py says why)."""
    return graphs.Program(
        "decode_step",
        lambda batch, overlap, *pred: decode_step(batch, overlap, flags,
                                                  *pred), (flags,))


@functools.lru_cache(maxsize=None)
def jitted_decode_spec_step(flags: PipelineFlags) -> graphs.Program:
    """decode_spec_step compiled as the reference's
    `jitted_decode_spec_step(flags)`: fn(batch, overlap[, pred_state]), as
    jitted_decode_step.  The graph's predictor kernel updates its own copy
    of batch['spec'], never the caller's."""
    return graphs.Program(
        "decode_spec_step",
        lambda batch, overlap, *pred: decode_spec_step(batch, overlap, flags,
                                                       *pred), (flags,))
