"""aacjax_torch — the decoder of `aacjax` but for Parametric Stereo, in
PyTorch for CUDA.

AAC-LC, Main, LTP, ER-LC, LD and ELD streams, mono through 7.1 with coupling
channels, and HE-AAC v1 (SBR), through `decode_adts`, `decode_loas`,
`BatchDecoder` (with `step_he_raw` and `decode_he_pipelined` for HE-AAC)
and the streaming `AACDecoder`; HE-AAC v2 (Parametric Stereo) is not ported
yet.

The device side runs hand-written CUDA kernels for Hopper (sm_90a): the
fused decode tail, the synthesis filterbank, the TNS recurrence and the
Main-profile predictor (`aacjax_torch.kernels`); the SBR program and its
QMF banks are PyTorch, as the reference's are plain XLA.  The host side
(ADTS, ASC, the bitstream syntax, the SBR parser and packer, the ctypes
binding to the native C++ parser, the constant tables) is the port's own
copy of `aacjax`'s host modules (`aacjax_torch.host`,
`aacjax_torch.tables`): the port imports nothing of `aacjax` and no JAX.

Every entry point takes an explicit `device`; the default is "cuda" and it
raises where CUDA is absent.  Matrix products run in full fp32: TF32 is
switched off here, matching the reference's Precision.HIGHEST.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from aacjax_torch.api import (AACDecoder, decode_adts, decode_loas,  # noqa: E402
                              probe, to_canonical_order)
from aacjax_torch.runtime.batch import BatchDecoder  # noqa: E402

__all__ = ["AACDecoder", "BatchDecoder", "decode_adts", "decode_loas",
           "probe", "to_canonical_order"]
