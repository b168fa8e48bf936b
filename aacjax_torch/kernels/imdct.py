"""The IMDCT of `csrc/filterbank.cu` as an FFT: its twiddle table and a
numpy model of the kernel's passes.

The IMDCT of h bins (h = 1024 long, 128 short) is the fold of a DCT-IV
(as `aacjax_torch.tables.imdct_via_dct4`): with D = DCT-IV(X) / h,

    out[0 : h/2]     =  D[h/2 : h]
    out[h/2 : 3h/2]  = -D[h-1 .. 0]
    out[3h/2 : 2h]   = -D[0 : h/2]

and the DCT-IV of N points is one N/2-point complex FFT between two
twiddles: v[n] = (x[2n] + i x[N-1-2n]) e^(-i pi (4n+1) / 4N),
V = FFT(v), y[k] = V[k] e^(-i pi k / N), D[2k] = Re y[k] / N,
D[N-1-2k] = -Im y[k] / N.  A long frame is one 512-point FFT; an
EIGHT_SHORT frame eight 64-point FFTs, one per 128-bin sub-block.

The kernel gives each frame 64 threads (u = 0..63), each holding 8 complex
points, and runs radix-8 passes (512 = 8^3, 64 = 8^2):

  load    thread u takes v at points n = 64 r + u, r = 0..7 (long), or
          point u of sub-block r (short)
  pass 1  (long only) 8-point DFT over r -> k_a, times W512^(u k_a);
          exchange: S[k_a][m] with m = u
  pass 2  thread (k_a, m0) = (u / 8, u % 8): 8-point DFT over m1 of
          S[k_a][8 m1 + m0] -> k_c, times W64^(m0 k_c); exchange
  pass 3  thread (k_a, k_c) = (u / 8, u % 8): 8-point DFT over m0 -> k_d,
          giving V[k_a + 8 k_c + 64 k_d] (long) or, for sub-block k_a,
          V[k_c + 8 k_d] (short)
  post    y = V * post twiddle (which carries the 1/N), into D

`model_dct4` below repeats these steps in numpy complex64 with the same
float32 table, so a wrong twiddle or index map fails the CPU tests
(tests/test_torch_imdct.py) before the kernel ever runs.
"""
from __future__ import annotations

import functools

import numpy as np

from aacjax_torch.kernels import windows as W

FRAME = 1024
SHORT = FRAME // 8

# offsets (in complex entries) of the parts of the twiddle table, each laid
# out in the order the kernel's threads read it (a warp reads contiguous
# entries); the kernel's TW_* constants repeat them
TW_PRE_L = 0        # [512] e^(-i pi (4n+1) / 4096): long pre-twiddle of n
TW_PRE_S = 512      # [64]  e^(-i pi (4n+1) / 512): short pre-twiddle of n
TW_PASS1 = 576      # [7, 64] W512^(u k) at (k - 1, u), W_N = e^(-2 pi i / N)
TW_PASS2 = 1024     # [7, 8]  W64^(m0 k_c) at (k_c - 1, m0)
TW_POST_L = 1080    # [8, 64] e^(-i pi k / 1024) / 1024, long post-twiddle of
                    #         k = u // 8 + 8 (u % 8) + 64 k_d at (k_d, u)
TW_POST_S = 1592    # [64]  e^(-i pi k / 128) / 128: short post-twiddle of k
TW_SIZE = 1656


def _post_long_k() -> np.ndarray:
    """[8 (k_d), 64 (u)]: the long output index thread u holds after the
    last pass, k = k_a + 8 k_c + 64 k_d with (k_a, k_c) = (u // 8, u % 8)."""
    u = np.arange(64)
    return (u // 8 + 8 * (u % 8))[None, :] + 64 * np.arange(8)[:, None]


@functools.lru_cache(maxsize=None)
def twiddles() -> np.ndarray:
    """The kernel's twiddle table: [TW_SIZE, 2] float32 (re, im),
    computed in float64."""
    n_l, n_s = np.arange(FRAME // 2), np.arange(SHORT // 2)
    k = np.arange(1, 8)[:, None]
    parts = [np.exp(-1j * np.pi * (4 * n_l + 1) / (4 * FRAME)),
             np.exp(-1j * np.pi * (4 * n_s + 1) / (4 * SHORT)),
             np.exp(-2j * np.pi * k * np.arange(64)[None, :] / 512).ravel(),
             np.exp(-2j * np.pi * k * np.arange(8)[None, :] / 64).ravel(),
             (np.exp(-1j * np.pi * _post_long_k() / FRAME) / FRAME).ravel(),
             np.exp(-1j * np.pi * n_s / SHORT) / SHORT]
    tw = np.concatenate(parts)
    assert tw.shape == (TW_SIZE,)
    return np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)


def _table() -> np.ndarray:
    t = twiddles()
    return (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)


_R = np.float32(np.sqrt(0.5))


def _dft4(b0, b1, b2, b3):
    s0, s1, s2 = b0 + b2, b0 - b2, b1 + b3
    s3 = (b1 - b3) * np.complex64(-1j)
    return s0 + s2, s1 + s3, s0 - s2, s1 - s3


def dft8(a: np.ndarray) -> np.ndarray:
    """8-point forward DFT along the last axis, by the kernel's butterflies
    (one radix-2 stage, then two 4-point DFTs)."""
    a = a.astype(np.complex64)
    u = [a[..., n] + a[..., n + 4] for n in range(4)]
    d = [a[..., n] - a[..., n + 4] for n in range(4)]
    w = [d[0], d[1] * np.complex64(_R - 1j * _R), d[2] * np.complex64(-1j),
         d[3] * np.complex64(-_R - 1j * _R)]
    ev, od = _dft4(*u), _dft4(*w)
    return np.stack([ev[0], od[0], ev[1], od[1], ev[2], od[2], ev[3], od[3]],
                    axis=-1)


def model_dct4(x: np.ndarray, short: bool) -> np.ndarray:
    """D for frames x [..., 1024] float32: the scaled DCT-IV of the whole
    frame (long) or of each 128-bin sub-block (short, D[128 b + m]), by the
    kernel's passes and index maps."""
    tw = _table()
    x = np.asarray(x, np.float32)
    pairs = x.reshape(x.shape[:-1] + (FRAME // 2, 2))
    u = np.arange(64)[None, :]
    r = np.arange(8)[:, None]
    pe = 64 * r + u                                     # [r, u]
    po = 64 * r + 63 - u if short else 511 - pe
    pre = tw[TW_PRE_S + u] if short else tw[TW_PRE_L + pe]
    v = (pairs[..., pe, 0] + 1j * pairs[..., po, 1]).astype(np.complex64)
    v = v * pre                                         # [..., r, u]
    one = np.complex64(1)
    if short:
        S = v                                           # S[blk = r][m = u]
    else:
        A = dft8(np.moveaxis(v, -2, -1))                # [..., m, k_a]
        w1 = tw[TW_PASS1:TW_PASS2].reshape(7, 64)       # [k_a - 1, u]
        A = A * np.concatenate([np.full((1, 64), one), w1]).T
        S = np.moveaxis(A, -1, -2)                      # S[k_a][m]
    # pass 2: thread (k_a, m0) reads S[k_a][8 m1 + m0]
    b = S.reshape(S.shape[:-1] + (8, 8))                # [..., k_a, m1, m0]
    B = dft8(np.moveaxis(b, -2, -1))                    # [..., k_a, m0, k_c]
    w2 = tw[TW_PASS2:TW_POST_L].reshape(7, 8)           # [k_c - 1, m0]
    B = B * np.concatenate([np.full((1, 8), one), w2]).T
    # pass 3: thread (k_a, k_c) reads over m0
    C = dft8(np.moveaxis(B, -2, -1))                    # [..., k_a, k_c, k_d]
    ka_, kc_, kd_ = np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                                indexing="ij")
    D = np.empty(x.shape, np.float32)
    if short:
        k = kc_ + 8 * kd_
        y = C * tw[TW_POST_S + k]
        D[..., 128 * ka_ + 2 * k] = y.real
        D[..., 128 * ka_ + 127 - 2 * k] = -y.imag
    else:
        k = ka_ + 8 * kc_ + 64 * kd_
        u_ = 8 * ka_ + kc_                              # the thread
        y = C * tw[TW_POST_L + 64 * kd_ + u_]
        D[..., 2 * k] = y.real
        D[..., FRAME - 1 - 2 * k] = -y.imag
    return D


def fold(D: np.ndarray) -> np.ndarray:
    """IMDCT output [..., 2h] from D [..., h] (the DCT-IV fold)."""
    h = D.shape[-1]
    return np.concatenate([D[..., h // 2:], -D[..., ::-1], -D[..., :h // 2]],
                          axis=-1)


def model_imdct_long(x: np.ndarray) -> np.ndarray:
    """[..., 1024] -> [..., 2048]: equals x @ imdct_long_matrix()."""
    return fold(model_dct4(x, short=False))


def model_imdct_short(x: np.ndarray) -> np.ndarray:
    """[..., 1024] -> [..., 8, 256]: sub-block b equals
    x[..., 128 b : 128 (b + 1)] @ imdct_short_matrix()."""
    D = model_dct4(x, short=True)
    return fold(D.reshape(D.shape[:-1] + (8, SHORT)))


def _short_samples(D, pos, shape, prev):
    """Samples `pos` [P] of windowed EIGHT_SHORT frames from their short
    D [B, 1024], as the kernel's short_sample reads them: sub-window w
    covers [MID + 128 w, MID + 128 w + 256), so segment s is the rising
    half of sub-window s plus the falling half of sub-window s - 1."""
    rise, fall = W.short_rise(), W.short_fall()
    q = pos - W.MID
    inside = (q >= 0) & (q < 9 * SHORT)
    q = np.clip(q, 0, 9 * SHORT - 1)
    seg, o = q >> 7, q & 127
    lo = o < 64
    # rising half: short IMDCT sample o of sub-block seg
    ia = np.minimum(seg, 7) * SHORT + np.where(lo, 64 + o, 191 - o)
    a = np.where(lo, 1.0, -1.0).astype(np.float32) * D[:, ia]
    rshape = np.where(seg[None] == 0, prev[:, None], shape[:, None])
    a = np.where(seg <= 7, a * rise[rshape, o], 0.0)
    # falling half: sample 128 + o of sub-block seg - 1
    ib = np.maximum(seg - 1, 0) * SHORT + np.where(lo, 63 - o, o - 64)
    b = np.where(seg >= 1, -D[:, ib] * fall[shape][:, o], 0.0)
    return np.where(inside, a + b, 0.0).astype(np.float32)


def model_halves(x, f_idx, s_idx, shape_idx, prev_shape_idx, is_short):
    """(first, second) [B, 1024] of frames x [B, 1024] as the kernel's
    output stage forms them from D: the long fold read in the kernel's
    order times the F/S window rows, or the short segment algebra."""
    j = np.arange(FRAME)
    lo = j < FRAME // 2
    DL = model_dct4(x, short=False)
    first = (np.where(lo, 1.0, -1.0).astype(np.float32)
             * DL[:, np.where(lo, 512 + j, 1535 - j)])
    second = -DL[:, np.where(lo, 511 - j, j - 512)]
    first = first * W.first_half_windows()[f_idx]
    second = second * W.second_half_windows()[s_idx]
    DS = model_dct4(x, short=True)
    sel = (np.asarray(is_short) != 0)[:, None]
    first = np.where(sel, _short_samples(DS, j, shape_idx, prev_shape_idx),
                     first)
    second = np.where(sel, _short_samples(DS, FRAME + j, shape_idx,
                                          prev_shape_idx), second)
    return first.astype(np.float32), second.astype(np.float32)
