"""aacjax_torch — `aacjax` in PyTorch for CUDA: the decoder, the encoders
and the user surfaces.

Decodes AAC-LC, Main, LTP, ER-LC, LD and ELD streams, mono through 7.1 with
coupling channels, HE-AAC v1 (SBR) and HE-AAC v2 (SBR + Parametric Stereo),
from ADTS, LOAS/LATM and MP4/M4A: `decode_adts`, `decode_loas`,
`decode_m4a`, `BatchDecoder` (with `step_he_raw` and `decode_he_pipelined`
for HE-AAC), the streaming `AACDecoder`, the random-access `AACFile` and
the Aurora-style facade (`aacjax_torch.aurora`).  Encodes with the
per-stream `AACEncoder` / `HEAACEncoder` (host code) and the batched
`BatchEncoder`, whose analysis and quantization run on the device.  A
command line: `python -m aacjax_torch.cli`; examples under
`aacjax_torch/examples/`.

The decoder's device side runs five hand-written CUDA kernels for Hopper
(sm_90a, `aacjax_torch.kernels`): the fused decode tail, the synthesis
filterbank, the TNS recurrence, the Main-profile predictor and the PS
decorrelator.  The SBR and PS programs, the QMF banks and the batched
encoder's analysis are PyTorch, as the reference's are plain XLA.  The host
side (containers, the bitstream syntax, the SBR/PS parsers and packers, the
ctypes bindings to the native C++ parser and writer, the per-stream
encoders, the constant tables) is the port's own copy of `aacjax`'s host
modules: the port imports nothing of `aacjax` and no JAX.

Every entry point that touches a device takes an explicit `device`; the
default is "cuda" and it raises where CUDA is absent.  Matrix products run
in full fp32: TF32 is switched off here, matching the reference's
Precision.HIGHEST, before any submodule is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from aacjax_torch.api import (AACDecoder, StreamConfig,  # noqa: E402
                              decode_adts, decode_loas, decode_m4a, probe,
                              to_canonical_order)
from aacjax_torch.encode import AACEncoder, encode_adts, encode_m4a  # noqa: E402
from aacjax_torch.encode_batch import BatchEncoder  # noqa: E402
from aacjax_torch.encode_he import HEAACEncoder, encode_he_adts  # noqa: E402
from aacjax_torch.file import AACFile  # noqa: E402
from aacjax_torch.host.asc import make_asc, parse_asc  # noqa: E402
from aacjax_torch.host.latm import probe_loas  # noqa: E402
from aacjax_torch.host.mp4 import probe as probe_m4a  # noqa: E402
from aacjax_torch.runtime.batch import BatchDecoder  # noqa: E402

__version__ = "0.1.0"

__all__ = ["AACDecoder", "AACEncoder", "AACFile", "BatchDecoder",
           "BatchEncoder", "HEAACEncoder", "StreamConfig", "decode_adts",
           "decode_loas", "decode_m4a", "encode_adts", "encode_he_adts",
           "encode_m4a", "make_asc", "parse_asc", "probe", "probe_loas",
           "probe_m4a", "to_canonical_order", "__version__"]
