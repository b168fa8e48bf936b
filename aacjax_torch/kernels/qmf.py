"""SBR QMF filterbanks (ISO/IEC 14496-3 4.6.18.4) on tensors.

Counterpart of `aacjax/kernels/qmf.py`, which computes both banks as plain
XLA (no Pallas kernel, no scan); they port as PyTorch:

  * 32-band complex analysis of the core-rate signal: each slot's 320-sample
    window folded five ways into 64 samples (strided views of the history
    plus input), then one product with the [64, 64] cos | sin matrix.
  * 64-band complex synthesis to the 2x rate: one [128 -> 128] product per
    slot for the v-vectors, then the 640-tap window as a 10-tap FIR over the
    slot axis, ten shifted slices of [reversed history; v] weighted by the
    prototype.  The reference's banded-Toeplitz form of the FIR is a TPU
    workaround (~17 GFLOP at B = 1024, S = 256 where the slices read
    ~0.7 GB) and is not ported; the two forms agree to float reassociation
    (~1e-7 relative).

The numpy constants (`prototype`, `_analysis_consts`,
`_analysis_device_consts`, `_synthesis_consts`) are the reference's own,
value for value: the per-channel float64 reference `host/sbr_decode.py`
reads them.  The cross-chunk state (the analysis bank's 288-sample history,
the synthesis bank's 9 v-vectors) lives on the device between chunks, like
the core decoder's overlap.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from aacjax_torch.kernels import _build

_SBR_NPZ = pathlib.Path(__file__).parent.parent / "host" / "sbr_tables.npz"

ANA_BANDS = 32      # analysis bands (core rate)
SYN_BANDS = 64      # synthesis bands (2x rate)
ANA_TAPS = 320      # downsampled prototype length
SYN_TAPS = 640
ANA_HIST = ANA_TAPS - ANA_BANDS   # 288 samples carried between chunks
SYN_HIST = 9        # v-vectors carried between chunks


@functools.lru_cache(maxsize=None)
def prototype() -> np.ndarray:
    """[640] float64 QMF prototype filter c(n)."""
    return np.load(_SBR_NPZ)["qmf_window_us"].astype(np.float64)


@functools.lru_cache(maxsize=None)
def _analysis_consts():
    c = prototype()
    # the downsampled prototype c(2n), x2 for the 2x band upsampling: the
    # analysis(32) -> synthesis(64) chain then has unit passthrough gain
    win_ds = 2.0 * c[::2]                       # [320]
    n = np.arange(64, dtype=np.float64)
    k = np.arange(ANA_BANDS, dtype=np.float64)
    # X[k] = sum_n u(n) exp(j pi/64 (k+0.5)(2n-0.5)), the phase convention
    # paired with the synthesis bank's 2n+257 (libavcodec's)
    ang = np.pi / 64.0 * (k[:, None] + 0.5) * (2.0 * n[None, :] - 0.5)
    m = np.exp(1j * ang)                        # [32, 64]
    return (win_ds.astype(np.float32),
            m.real.astype(np.float32).T,        # [64, 32]
            m.imag.astype(np.float32).T)


@functools.lru_cache(maxsize=None)
def _analysis_device_consts():
    """_analysis_consts laid out for 64-sample blocks in ascending time
    order: the newest-first reversal the filterbank wants is folded into
    the window rows and the matrices' rows."""
    win_ds, mr, mi = _analysis_consts()
    win_flip = np.stack([win_ds[64 * f:64 * (f + 1)][::-1]
                         for f in range(5)])    # [5, 64]
    return (np.ascontiguousarray(win_flip),
            np.ascontiguousarray(mr[::-1]),     # [64, 32], rows flipped
            np.ascontiguousarray(mi[::-1]))


@functools.lru_cache(maxsize=None)
def _synthesis_consts():
    c = prototype()
    n = np.arange(128, dtype=np.float64)
    k = np.arange(SYN_BANDS, dtype=np.float64)
    # v(n) = 1/64 Re{ sum_k X[k] exp(j pi/128 (k+0.5)(2n+257)) }
    ang = np.pi / 128.0 * (k[None, :] + 0.5) * (2.0 * n[:, None] + 257.0)
    m = np.exp(1j * ang) / 64.0                 # [128, 64]
    # the windowed 640 taps pick alternating half-blocks of the
    # 1280-sample v FIFO: g(128i + n) = v(256i + n),
    # g(128i + 64 + n) = v(256i + 192 + n), n < 64
    gsel = np.zeros(SYN_TAPS, np.int64)
    for i in range(5):
        gsel[128 * i:128 * i + 64] = 256 * i + np.arange(64)
        gsel[128 * i + 64:128 * i + 128] = 256 * i + 192 + np.arange(64)
    # out(n) = sum_{j<10} w(64j + n), w = g * c: tap (j, n) reads v-vector
    # (slot - q // 128) at row q % 128, q = gsel[64j + n], weight c[64j + n]
    taps_j = np.zeros((10, 64), np.int64)   # which past slot (0..9)
    taps_r = np.zeros((10, 64), np.int64)   # which v row (0..127)
    taps_w = np.zeros((10, 64), np.float64)
    for j in range(10):
        for nn in range(64):
            q = gsel[64 * j + nn]
            taps_j[j, nn] = q // 128
            taps_r[j, nn] = q % 128
            taps_w[j, nn] = c[64 * j + nn]
    return (m.real.astype(np.float32), m.imag.astype(np.float32),
            taps_j, taps_r, taps_w.astype(np.float32))


@_build.per_device
def _device_consts(device: torch.device) -> dict[str, torch.Tensor]:
    """The banks' constants on `device`: the analysis window rows [5, 64]
    and cos | sin matrix [64, 64]; the synthesis matrix [128, 128] that maps
    [Xr | Xi] to v, and the FIR weights [10, 64]."""
    win_flip, mr, mi = _analysis_device_consts()
    smr, smi, _, _, taps_w = _synthesis_consts()
    consts = dict(win=win_flip, ana=np.concatenate([mr, mi], axis=1),
                  syn=np.concatenate([smr.T, -smi.T], axis=0), w=taps_w)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in consts.items()}


def analysis(x: torch.Tensor, hist: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """32-band complex QMF analysis.

    x [B, N] core-rate samples (N % 32 == 0); hist [B, 288] carried samples
    (the previous chunk's tail).  Returns (X_re, X_im) [B, S, 32] with
    S = N // 32 slots, plus the new history."""
    c = _device_consts(x.device)
    B, N = x.shape
    S = N // ANA_BANDS
    buf = torch.cat([hist, x], dim=1)                   # [B, 288 + N]
    # slot s folds the 320 newest samples buf[32s : 32s+320]; fold f is the
    # 64-sample window buf[32(s+d) : 32(s+d)+64], d = (256 - 64f) / 32: a
    # row of the stride-32 windows below
    win = buf.unfold(1, 64, ANA_BANDS)                  # [B, S + 8, 64]
    u = None
    for f in range(5):
        d = (256 - 64 * f) // ANA_BANDS
        term = win[:, d:d + S] * c["win"][f]
        u = term if u is None else u + term
    xx = torch.matmul(u, c["ana"])                      # [B, S, 64]
    return xx[..., :ANA_BANDS], xx[..., ANA_BANDS:], buf[:, -ANA_HIST:]


def synthesis(xr: torch.Tensor, xi: torch.Tensor, vhist: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """64-band real-output QMF synthesis.

    xr/xi [B, S, 64]; vhist [B, 9, 128] carried v-vectors (previous slots,
    vhist[:, 0] the most recent).  Returns (pcm [B, S*64], new vhist)."""
    c = _device_consts(xr.device)
    B, S, _ = xr.shape
    v = torch.matmul(torch.cat([xr, xi], dim=2), c["syn"])   # [B, S, 128]
    # tap j of slot s reads vall[:, 9 + s - j, n + 64*(j&1)] (the gsel block
    # structure: taps_j[j] == j, taps_r[j] == n + 64*(j odd))
    vall = torch.cat([vhist.flip(1), v], dim=1)             # [B, 9+S, 128]
    pcm = None
    for j in range(10):
        lo = 64 * (j & 1)
        term = vall[:, 9 - j: 9 - j + S, lo:lo + 64] * c["w"][j]
        pcm = term if pcm is None else pcm + term
    return pcm.reshape(B, S * 64), vall[:, -SYN_HIST:].flip(1)


def analysis_init(B: int, device: str | torch.device) -> torch.Tensor:
    return torch.zeros((B, ANA_HIST), dtype=torch.float32, device=device)


def synthesis_init(B: int, device: str | torch.device) -> torch.Tensor:
    return torch.zeros((B, SYN_HIST, 128), dtype=torch.float32, device=device)
