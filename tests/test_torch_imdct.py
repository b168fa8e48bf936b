"""The FFT factorisation of the IMDCT that the port's filterbank kernel
runs (csrc/filterbank.cu), through its numpy model
(aacjax_torch.kernels.imdct): the same float32 twiddle table that
`pipeline.consts` hands the kernel, the same radix-8 passes and the same
index maps.  Held to the dense products the plain versions compute
(x @ imdct_long_matrix(), x @ imdct_short_matrix()), to the reference's
O(n log n) form (aacjax.tables.imdct_via_dct4) and, with the kernel's
output stage, to the plain synthesis.

Tolerance: 5e-5 * max(1, max|ref|), the f32 PCM bound of the reference's
Pallas tail (tests/test_pallas_tail.py); the model's error is ~1e-7 of
the largest value, the dense float32 product's ~4e-7.
"""
import numpy as np
import pytest
import torch

from aacjax import tables as jax_tables
from aacjax_torch.kernels import imdct
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import synth
from aacjax_torch.kernels import windows as W
from aacjax_torch.testing import random_synth_batch


def _frames(seed, rows=6, amp=3000.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 1024)) * amp
    x[0] = 0.0                              # silence stays silence
    x[1, 700:] = 0.0                        # band-limited, as real spectra
    return x.astype(np.float32)


def _close(got, want):
    tol = 5e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, (err, tol)
    return err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_model_matches_dense_matrix(seed):
    x = _frames(seed)
    _close(imdct.model_imdct_long(x), x @ W.imdct_long_matrix())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_short_model_matches_dense_matrix(seed):
    x = _frames(10 + seed)
    want = x.reshape(-1, 8, 128) @ W.imdct_short_matrix()
    _close(imdct.model_imdct_short(x), want)


@pytest.mark.parametrize("short", [False, True])
def test_model_matches_reference_imdct_via_dct4(short):
    """Against the reference's float64 DCT-IV fold, which
    tests/test_tables.py holds to its imdct_matrix."""
    x = _frames(20 + short)
    if short:
        want = jax_tables.imdct_via_dct4(x.reshape(-1, 8, 128).astype(
            np.float64))
        got = imdct.model_imdct_short(x)
    else:
        want = jax_tables.imdct_via_dct4(x.astype(np.float64))
        got = imdct.model_imdct_long(x)
    err = _close(got, want)
    assert err <= 1e-6 * float(np.abs(want).max())


def test_dft8_is_the_dft():
    a = (np.random.default_rng(3).standard_normal((5, 8))
         + 1j * np.random.default_rng(4).standard_normal((5, 8)))
    np.testing.assert_allclose(imdct.dft8(a), np.fft.fft(a, axis=-1),
                               atol=1e-5)


def test_twiddle_table_is_what_the_kernel_gets():
    tw = imdct.twiddles()
    assert tw.shape == (imdct.TW_SIZE, 2) and tw.dtype == np.float32
    dev = P.consts(torch.device("cpu"))["twiddles"]
    assert dev.dtype == torch.float32 and dev.is_contiguous()
    np.testing.assert_array_equal(dev.numpy(), tw)
    w = tw[:, 0] + 1j * tw[:, 1]
    # pass 1: W512^(u k) at (k - 1, u); pass 2: W64^(m0 k_c) at
    # (k_c - 1, m0), so (k_c, m0) = (4, 4) holds W64^16 = -i
    np.testing.assert_allclose(w[imdct.TW_PASS1 + 64 * 6 + 63],
                               np.exp(-2j * np.pi * 441 / 512), atol=1e-7)
    np.testing.assert_allclose(w[imdct.TW_PASS2 + 8 * 3 + 4], -1j, atol=1e-7)
    np.testing.assert_allclose(np.abs(w[imdct.TW_POST_L:imdct.TW_POST_S]),
                               1 / 1024, rtol=1e-6)


@pytest.mark.parametrize("part", ["pre_long", "pass2", "post_short"])
def test_model_fails_on_a_wrong_twiddle(monkeypatch, part):
    """One conjugated entry of the table breaks the model beyond the
    tolerance: the tests above would catch such a table."""
    at = {"pre_long": imdct.TW_PRE_L + 77, "pass2": imdct.TW_PASS2 + 20,
          "post_short": imdct.TW_POST_S + 5}[part]
    bad = imdct.twiddles().copy()
    bad[at, 1] = -bad[at, 1]
    monkeypatch.setattr(imdct, "twiddles", lambda: bad)
    x = _frames(30)
    if part == "post_short":
        got = imdct.model_imdct_short(x)
        want = x.reshape(-1, 8, 128) @ W.imdct_short_matrix()
    else:
        got, want = imdct.model_imdct_long(x), x @ W.imdct_long_matrix()
    with pytest.raises(AssertionError):
        _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_output_stage_model_matches_plain_synthesis(seed):
    """The kernel's output stage (the long fold read in the kernel's
    order, the F/S window rows, the short segment algebra) on top of the
    model equals the plain synthesis on batches of all four window
    sequences and both window shapes."""
    args = random_synth_batch(seed, 24)
    first, second = imdct.model_halves(*args)
    rf, rs = synth.synthesis_ref(*(torch.from_numpy(a) for a in args))
    _close(first, rf.numpy().astype(np.float64))
    _close(second, rs.numpy().astype(np.float64))
