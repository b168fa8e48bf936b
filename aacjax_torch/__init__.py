"""aacjax_torch — the AAC-LC serving path of `aacjax`, in PyTorch for CUDA.

The device side runs hand-written CUDA kernels for Hopper (sm_90a): the
fused decode tail, the synthesis filterbank and the TNS recurrence
(`aacjax_torch.kernels`).  The host side (ADTS, ASC, the bitstream syntax,
the ctypes binding to the native C++ parser, the constant tables) is the
port's own copy of `aacjax`'s host modules (`aacjax_torch.host`,
`aacjax_torch.tables`): the port imports nothing of `aacjax` and no JAX.

Every entry point takes an explicit `device`; the default is "cuda" and it
raises where CUDA is absent.  Matrix products run in full fp32: TF32 is
switched off here, matching the reference's Precision.HIGHEST.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from aacjax_torch.api import decode_adts  # noqa: E402
from aacjax_torch.runtime.batch import BatchDecoder  # noqa: E402

__all__ = ["BatchDecoder", "decode_adts"]
