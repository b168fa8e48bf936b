"""The port's TNS (aacjax_torch.kernels.tns) against the reference's
compensated float-float scan (aacjax.kernels.pipeline.tns), on
numpy-seeded filters in both directions: stable order-2 filters, and
high-gain order-12 and order-20 "torture" filters whose regions touch the
first and last bins.

Tolerance: 1e-6 * max|x|.  The float-float form exists for this accuracy:
the AR feedback of a high-gain filter amplifies per-step f32 rounding, and
a plain f32 recursion drifts by ~1e-3 full scale on such filters.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aacjax.kernels import pipeline as JP
from aacjax_torch.kernels import tns
from aacjax_torch.testing import random_tns_chunk

C, T, F = 2, 4, 1024


@pytest.mark.parametrize("order,kmax", [(2, 0.7), (12, 0.95), (20, 0.9)])
def test_tns_ref_matches_reference(order, kmax):
    """Two filters per row and direction, the first region starting at bin
    0 and the second ending at bin F."""
    args = random_tns_chunk(order, C, T, kinds=[(order, kmax)])
    want = np.asarray(JP.tns(*map(jnp.asarray, args)))
    got = tns.tns_ref(*map(torch.from_numpy, args)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(args[0]).max())


def test_tns_partial_regions_pass_through():
    """Bins outside every filter region are the input, bit for bit; a row
    with no filters is untouched."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((C, T, F)).astype(np.float32)
    lpc = np.zeros((C, T, 8, 20), np.float32)
    start = np.zeros((C, T, 8), np.int32)
    end = np.zeros((C, T, 8), np.int32)
    lpc[0, 0, 0, :2] = (0.5, -0.2)
    start[0, 0, 0], end[0, 0, 0] = 100, 300
    z = torch.zeros_like(torch.from_numpy(lpc))
    zi = torch.zeros_like(torch.from_numpy(start))
    args = (torch.from_numpy(x), torch.from_numpy(lpc),
            torch.from_numpy(start), torch.from_numpy(end), z, zi, zi)
    before = tns.launches
    got = tns.tns(*args).numpy()     # CPU tensors: the plain version
    assert tns.launches == before
    np.testing.assert_array_equal(got, tns.tns_ref(*args).numpy())
    np.testing.assert_array_equal(got[0, 0, :100], x[0, 0, :100])
    np.testing.assert_array_equal(got[0, 0, 300:], x[0, 0, 300:])
    np.testing.assert_array_equal(got[1:], x[1:])
    assert not np.array_equal(got[0, 0, 100:300], x[0, 0, 100:300])
