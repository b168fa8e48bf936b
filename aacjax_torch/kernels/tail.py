"""The fused decode tail: CUDA counterpart of `aacjax/kernels/pallas_tail.py`.

`decode_tail` runs `csrc/filterbank.cu` (entry `aacjax_tail`) on CUDA
tensors and `decode_tail_ref`, its plain PyTorch version, on CPU tensors.
One launch takes a [C, T, 1024] chunk through decompression (int16 input),
the long and short IMDCT, windowing, the intra- and cross-frame
overlap-add, concealment, the int16 or float pack and the overlap carry.
The kernel computes the IMDCT by FFT (kernels/imdct.py); the plain version
keeps the reference's dense product.
"""
from __future__ import annotations

import torch

from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P

FRAME = P.FRAME
MAX_T = 64      # the reference's gate (its kernel's VMEM footprint)
TILE_C = 8      # the reference's channel tile; kept as the gate

launches = 0    # kernel launches since the last reset


def supported(flags: P.PipelineFlags, C: int, T: int, F: int) -> bool:
    """The reference's gate (pallas_tail.supported): F == 1024, C % 8 == 0,
    T <= 64, and no ELD, prediction or CCE entry lists."""
    return (F == FRAME and C % TILE_C == 0 and T <= MAX_T and not flags.eld
            and not flags.has_pred and not flags.has_cce_post
            and not flags.has_cce_time)


def decode_tail_ref(spec, spec_scale, f_idx, s_idx, shape_idx,
                    prev_shape_idx, is_short, valid, last_valid, overlap_in,
                    *, out_int16: bool, has_short: bool):
    """Plain PyTorch version of the fused tail (same arguments)."""
    if spec_scale is not None:
        spec = P.decompress_i16(spec, spec_scale)
    first, second = P.filterbank(spec, f_idx, s_idx, shape_idx,
                                 prev_shape_idx, is_short, has_short)
    pcm, new_overlap = P.overlap_add(first, second, overlap_in, last_valid)
    return P.conceal_and_pack(pcm, valid, out_int16), new_overlap


def decode_tail(spec, spec_scale, f_idx, s_idx, shape_idx, prev_shape_idx,
                is_short, valid, last_valid, overlap_in, *,
                out_int16: bool, has_short: bool):
    """Fused decode tail over a [C, T, 1024] chunk.

    spec: f32 [C,T,1024], or int16 with spec_scale f32 [C,T,64] (per
    16-bin block).  f_idx, s_idx, shape_idx, prev_shape_idx, is_short,
    valid: int32 [C,T] (is_short/valid nonzero = true); last_valid int32
    [C]; overlap_in f32 [C,1024].  Returns (pcm [C,T,1024] int16 or f32,
    new_overlap f32 [C,1024])."""
    args = (spec, spec_scale, f_idx, s_idx, shape_idx, prev_shape_idx,
            is_short, valid, last_valid, overlap_in)
    if spec.device.type == "cpu":
        return decode_tail_ref(*args, out_int16=out_int16,
                               has_short=has_short)
    _build.require_cuda(spec, "decode_tail")
    global launches
    C, T, F = spec.shape
    if F != FRAME or not 1 <= T <= MAX_T:
        raise ValueError(f"decode_tail: needs F == 1024 and T <= 64, got "
                         f"{tuple(spec.shape)}")
    dev = spec.device
    i16 = spec_scale is not None
    ck = _build.check
    ptrs = [ck(spec, "spec", torch.int16 if i16 else torch.float32,
               (C, T, F), dev, align=8),
            ck(spec_scale, "spec_scale", torch.float32, (C, T, F // 16), dev)
            if i16 else None, int(i16)]
    for name, a in zip(("f_idx", "s_idx", "shape_idx", "prev_shape_idx",
                        "is_short", "valid"), args[2:8]):
        ptrs.append(ck(a, name, torch.int32, (C, T), dev))
    ptrs += [ck(last_valid, "last_valid", torch.int32, (C,), dev),
             ck(overlap_in, "overlap_in", torch.float32, (C, F), dev,
                align=16)]
    c = P.consts(dev)
    ptrs += [c[k].data_ptr() for k in ("twiddles", "f_table", "s_table",
                                       "rise", "fall")]
    pcm = torch.empty((C, T, F), dtype=torch.int16 if out_int16
                      else torch.float32, device=dev)
    new_overlap = torch.empty((C, F), dtype=torch.float32, device=dev)
    launches += _build.launch("aacjax_tail", dev, *ptrs, pcm.data_ptr(),
                              new_overlap.data_ptr(), int(out_int16),
                              int(has_short), C, T,
                              torch.cuda.current_stream(dev).cuda_stream)
    return pcm, new_overlap
