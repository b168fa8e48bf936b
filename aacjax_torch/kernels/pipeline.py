"""The batched device decode step for native-parsed AAC-LC chunks.

Counterpart of `aacjax/kernels/pipeline.py` for the serving path: the
native parser has already fused dequantization, PNS, M/S and intensity
into final spectra, so the device runs TNS, the IMDCT filterbank, the
cross-frame overlap-add, concealment and the PCM pack over a dense
[C, T, 1024] chunk (C channel slots across all streams, T frames).

`decode_spec_step` routes a chunk as the reference routes it: the fused
tail kernel where `tail.supported` holds (taking compact int16 spectra
directly when there is no TNS), else the synthesis kernel plus
`overlap_add`, for any C*T.  The TNS kernel runs ahead of either whenever
the chunk carries TNS.  With `use_pallas=False` every stage runs as plain
PyTorch (the reference's XLA route).  On CPU tensors each kernel wrapper
runs its plain version.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from aacjax_torch.kernels import imdct
from aacjax_torch.kernels import windows as W

FRAME = 1024
SHORT = FRAME // 8


@dataclass(frozen=True)
class PipelineFlags:
    """Per-chunk specialisation flags, with the reference's fields.  The
    port runs the native LC subset: has_pred, has_cce_post, has_cce_time,
    spec_qsf and eld raise NotImplementedError in decode_spec_step."""
    has_stereo: bool = True
    has_tns: bool = False
    has_cce: bool = False
    out_int16: bool = False   # deliver int16 PCM samples (halves the D2H)
    use_pallas: bool = False  # hand-written kernels; False = plain PyTorch
    has_cce_post: bool = False
    has_cce_time: bool = False
    spec_i16: bool = False    # block-scaled int16 spectra + [C,T,64] scales
    spec_qsf: bool = False
    has_pred: bool = False
    has_short: bool = True    # any EIGHT_SHORT frame in the chunk
    eld: bool = False


# flag -> the ROADMAP item that ports it
_NOT_PORTED = {
    "has_pred": "Queue 1 item 6 (Main-profile prediction)",
    "has_cce_post": "Queue 1 item 6 (AFTER_TNS coupling)",
    "has_cce_time": "Queue 1 item 6 (AFTER_IMDCT coupling)",
    "spec_qsf": "Queue 1 item 6 (dequant_qsf)",
    "eld": "Queue 1 item 6 (eld_synthesis)",
}


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> dict[str, torch.Tensor]:
    """Constant tables on `device`: the IMDCT matrices of the plain
    versions and the window tables, from the same numpy functions
    (kernels/windows.py, a copy of the reference's) the reference embeds;
    and the FFT twiddle table of the kernels (kernels/imdct.py, computed
    in float64, stored as float32 [imdct.TW_SIZE, 2])."""
    tabs = dict(m_long=W.imdct_long_matrix(), m_short=W.imdct_short_matrix(),
                f_table=W.first_half_windows(), s_table=W.second_half_windows(),
                rise=W.short_rise(), fall=W.short_fall(),
                twiddles=imdct.twiddles())
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in tabs.items()}


def unpack_spec_batch(batch: dict) -> dict:
    """Slice the native parser's packed buffers: meta [C,T,6] int32 into
    contiguous int32 [C,T] planes (f_idx, s_idx, shape_idx,
    prev_shape_idx, is_short, valid), last_valid [C] (the last valid frame
    per channel, -1 for none), and the TNS planes per direction."""
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
    if "tns_lpc" in out:
        tl, tr = out.pop("tns_lpc"), out.pop("tns_range")
        for d, name in enumerate(("fwd", "rev")):
            out[f"tns_{name}_lpc"] = tl[:, :, d].contiguous()
            out[f"tns_{name}_start"] = tr[:, :, d, :, 0].contiguous()
            out[f"tns_{name}_end"] = tr[:, :, d, :, 1].contiguous()
    return out


def decompress_i16(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Block-scaled int16 -> f32: scale [C,T,64] applies per 16-bin block."""
    C, T, F = q.shape
    nb = scale.shape[-1]
    return (q.to(torch.float32).reshape(C, T, nb, F // nb)
            * scale[..., None]).reshape(C, T, F)


def filterbank(spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short,
               has_short: bool = True):
    """IMDCT + windowing of every frame: (first, second) halves [C,T,1024].
    first is the frame's own contribution, second the overlap carried into
    the next frame.  Index planes are integer [C,T]; is_short is nonzero
    for EIGHT_SHORT frames."""
    C, T, F = spec.shape
    c = consts(spec.device)
    long_out = torch.matmul(spec, c["m_long"])                  # [C,T,2F]
    first = long_out[..., :F] * c["f_table"][f_idx.long()]
    second = long_out[..., F:] * c["s_table"][s_idx.long()]
    if not has_short:
        return first, second
    blocks = torch.matmul(spec.reshape(C, T, 8, SHORT), c["m_short"])
    rise_cur = c["rise"][shape_idx.long()]                      # [C,T,S]
    rise_prev = c["rise"][prev_shape_idx.long()]
    fall_cur = c["fall"][shape_idx.long()]
    # block 0's rising half uses the previous frame's window shape
    rises = torch.cat([rise_prev[:, :, None],
                       rise_cur[:, :, None].expand(C, T, 7, SHORT)], dim=2)
    a = blocks[..., :SHORT] * rises
    b = blocks[..., SHORT:] * fall_cur[:, :, None]
    # sub-window w covers [MID + S*w, MID + S*w + 2S): segment s is
    # rising-half[s] + falling-half[s-1]
    segs = torch.cat([a[:, :, :1], a[:, :, 1:] + b[:, :, :7], b[:, :, 7:]],
                     dim=2)
    t_short = torch.zeros((C, T, 2 * F), dtype=spec.dtype, device=spec.device)
    t_short[..., W.MID:W.MID + 9 * SHORT] = segs.reshape(C, T, 9 * SHORT)
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


def conceal_and_pack(pcm, valid, out_int16: bool):
    """Invalid frames deliver silence; then int16 samples (round half to
    even, clip) or the reference's 1/32768 float scale."""
    pcm = pcm * (valid != 0)[..., None].to(pcm.dtype)
    if out_int16:
        return torch.clamp(torch.round(pcm), -32768.0, 32767.0).to(torch.int16)
    return pcm * (1.0 / 32768.0)


def decode_spec_step(batch: dict, overlap_in: torch.Tensor,
                     flags: PipelineFlags):
    """Decode one native-parsed chunk.  batch holds meta [C,T,6] and
    either spec f32 or spec_i16 + spec_scale, plus tns_lpc/tns_range when
    flags.has_tns.  Returns (pcm [C,T,1024] int16 or f32, new overlap)."""
    from aacjax_torch.kernels import synth, tail, tns

    for name, item in _NOT_PORTED.items():
        if getattr(flags, name):
            raise NotImplementedError(
                f"decode_spec_step: {name} is not ported yet (ROADMAP {item})")
    b = unpack_spec_batch(batch)
    C, T, F = (b["spec_i16"] if flags.spec_i16 else b["spec"]).shape
    if F != FRAME:
        raise NotImplementedError(
            f"frame length {F}: only 1024 is ported (ROADMAP Queue 1 item 6)")
    idx = (b["f_idx"], b["s_idx"], b["shape_idx"], b["prev_shape_idx"],
           b["is_short"])
    use_tail = flags.use_pallas and tail.supported(flags, C, T, F)
    if use_tail and flags.spec_i16 and not flags.has_tns:
        # fully fused: the kernel decompresses the int16 spectra itself
        return tail.decode_tail(
            b["spec_i16"], b["spec_scale"], *idx, b["valid"], b["last_valid"],
            overlap_in, out_int16=flags.out_int16, has_short=flags.has_short)
    spec = (decompress_i16(b["spec_i16"], b["spec_scale"]) if flags.spec_i16
            else b["spec"])
    if flags.has_tns:
        tns_fn = tns.tns if flags.use_pallas else tns.tns_ref
        spec = tns_fn(spec, b["tns_fwd_lpc"], b["tns_fwd_start"],
                      b["tns_fwd_end"], b["tns_rev_lpc"], b["tns_rev_start"],
                      b["tns_rev_end"])
    if use_tail:
        return tail.decode_tail(
            spec, None, *idx, b["valid"], b["last_valid"], overlap_in,
            out_int16=flags.out_int16, has_short=flags.has_short)
    if flags.use_pallas:
        # any C*T: the Pallas kernel's B % 8 rule is a TPU tiling limit,
        # and the CUDA kernel takes any row count
        first, second = synth.synthesis(
            spec.reshape(C * T, F), *(a.reshape(C * T) for a in idx))
        first, second = first.reshape(C, T, F), second.reshape(C, T, F)
    else:
        first, second = filterbank(spec, *idx, has_short=flags.has_short)
    pcm, new_overlap = overlap_add(first, second, overlap_in, b["last_valid"])
    return conceal_and_pack(pcm, b["valid"], flags.out_int16), new_overlap
