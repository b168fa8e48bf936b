"""The synthesis filterbank: CUDA counterpart of `aacjax/kernels/pallas_synth.py`.

`synthesis` runs `csrc/filterbank.cu` (entry `aacjax_synth`, the same
device code as the fused tail, the FFT IMDCT of kernels/imdct.py, with an
epilogue that stops before the cross-frame overlap-add) on CUDA tensors
and `synthesis_ref`, its plain PyTorch version (the reference's dense
product), on CPU tensors.
"""
from __future__ import annotations

import torch

from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P

FRAME = P.FRAME

launches = 0    # kernel launches since the last reset


def synthesis_ref(spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short):
    """Plain PyTorch version: windowed IMDCT halves of every row."""
    first, second = P.filterbank(
        spec[:, None], f_idx[:, None], s_idx[:, None], shape_idx[:, None],
        prev_shape_idx[:, None], is_short[:, None], has_short=True)
    return first[:, 0], second[:, 0]


def synthesis(spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short):
    """Synthesis over a flat batch: spec f32 [B,1024]; index planes int32
    [B] (is_short nonzero = EIGHT_SHORT).  Returns (first, second), f32
    [B,1024] each: the frame's own windowed half and the overlap it carries
    into the next frame."""
    args = (spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short)
    if spec.device.type == "cpu":
        return synthesis_ref(*args)
    _build.require_cuda(spec, "synthesis")
    global launches
    B = spec.shape[0]
    dev = spec.device
    ptrs = [_build.check(spec, "spec", torch.float32, (B, FRAME), dev,
                         align=16)]
    for name, a in zip(("f_idx", "s_idx", "shape_idx", "prev_shape_idx",
                        "is_short"), args[1:]):
        ptrs.append(_build.check(a, name, torch.int32, (B,), dev))
    c = P.consts(dev)
    ptrs += [c[k].data_ptr() for k in ("twiddles", "f_table", "s_table",
                                       "rise", "fall")]
    first = torch.empty((B, FRAME), dtype=torch.float32, device=dev)
    second = torch.empty((B, FRAME), dtype=torch.float32, device=dev)
    launches += _build.launch("aacjax_synth", dev, *ptrs, first.data_ptr(),
                              second.data_ptr(), B,
                              torch.cuda.current_stream(dev).cuda_stream)
    return first, second
