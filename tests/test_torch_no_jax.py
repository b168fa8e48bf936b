"""The port runs where JAX is absent (as on the machine with the GPU), its
kernel modules import without nvcc or triton, and a CUDA request without
CUDA raises instead of running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX_DECODE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
import aacjax_torch
import aacjax
assert not hasattr(aacjax, "decode_adts"), "aacjax/__init__.py ran"
from aacjax.host import native
from aacjax.host.asc import make_asc, parse_asc
from aacjax.testing.encoder import encode_pcm
assert native.available()
cfg = parse_asc(make_asc(2, 4, 2))
n = 1024 * 6
t = np.arange(n) / 44100.0
x = 8000 * np.sin(2 * np.pi * 440 * t)
pcm = np.stack([x, 0.8 * x], axis=1)
out, rate = aacjax_torch.decode_adts(encode_pcm(pcm, cfg, target_sf=120),
                                     device="cpu")
dec = out[1024:1024 + n] * 32768.0
err = dec[2048:n - 2048] - pcm[2048:n - 2048]
snr = 10 * np.log10(np.sum(pcm[2048:n - 2048] ** 2) / np.sum(err ** 2))
assert rate == 44100 and snr > 60.0, snr
print("ok", round(snr, 1))
"""


def test_decodes_with_jax_unimportable():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_DECODE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_no_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = sorted((REPO / "aacjax_torch").rglob("*.py"))
    assert files
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []


def test_kernel_modules_import_without_toolchain():
    """Importing the kernel modules builds nothing and needs no triton."""
    code = ("import sys, aacjax_torch.kernels.tail, aacjax_torch.kernels.synth,"
            " aacjax_torch.kernels.tns\n"
            "from aacjax_torch.kernels import _build\n"
            "assert _build.lib.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')")
    env = dict(os.environ, PATH="/nonexistent")   # no nvcc, no make
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_cuda_request_without_cuda_raises(monkeypatch):
    from aacjax.host.asc import make_asc, parse_asc
    import aacjax_torch
    from aacjax_torch.testing import tns_short_adts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_asc(make_asc(2, 4, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aacjax_torch.BatchDecoder([cfg])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aacjax_torch.decode_adts(tns_short_adts(2))
