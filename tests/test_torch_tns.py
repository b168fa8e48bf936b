"""The port's TNS (aacjax_torch.kernels.tns) against the reference's
compensated float-float scan (aacjax.kernels.pipeline.tns), on
numpy-seeded filters in both directions: stable order-2 filters, and
high-gain order-12 and order-20 "torture" filters whose regions touch the
first and last bins.

Tolerance: 1e-6 * max|x|.  The float-float form exists for this accuracy:
the AR feedback of a high-gain filter amplifies per-step f32 rounding, and
a plain f32 recursion drifts by ~1e-3 full scale on such filters.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
Here its parts that are Python are held: the packed entry's plain version,
the work plan, the FMA form of the exact product, and a numpy model of the
kernel's step order, which must equal the plain version bit for bit (the
kernel keeps the reference's summation order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aacjax.kernels import pipeline as JP
from aacjax_torch.kernels import tns
from aacjax_torch.kernels.pipeline import decompress_i16
from aacjax_torch.testing import (block_scale_i16, overlap_tns_chunk,
                                  random_tns_chunk, serving_tns_chunk)

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


def _packed_case(kind):
    """(spec_i16, spec_scale, tns_lpc, tns_range) of a small chunk: the
    serving mix, or torture filters of one order packed as the parser packs
    them."""
    if kind == "serving":
        # seed 3: rows with one, two and three filters, both directions
        return serving_tns_chunk(3, 4, 8)
    x, fl, fs, fe, rl, rs, re = random_tns_chunk(kind, C, T,
                                                 kinds=[(kind, 0.9)])
    return (*block_scale_i16(x), np.stack([fl, rl], axis=2),
            np.stack([np.stack([fs, fe], -1), np.stack([rs, re], -1)], axis=2))


def _sliced(lpc, rng):
    return (lpc[:, :, 0], rng[:, :, 0, :, 0], rng[:, :, 0, :, 1],
            lpc[:, :, 1], rng[:, :, 1, :, 0], rng[:, :, 1, :, 1])


@pytest.mark.parametrize("kind", ["serving", 2, 12, 20])
def test_tns_packed_ref_matches_sliced_and_reference(kind):
    """Compact int16 spectra + packed planes: equal to tns_ref on the
    decompressed, sliced inputs bit for bit, and within 1e-6 * max|x| of
    the reference's tns."""
    q, sc, lpc, rng = map(torch.from_numpy, _packed_case(kind))
    x = decompress_i16(q, sc)
    before = tns.launches
    got = tns.tns_packed(q, sc, lpc, rng)       # CPU tensors: plain version
    assert tns.launches == before
    assert torch.equal(got, tns.tns_ref(x, *_sliced(lpc, rng)))
    assert torch.equal(tns.tns_packed(x, None, lpc, rng), got)
    want = np.asarray(JP.tns(jnp.asarray(x.numpy()), *(
        jnp.asarray(np.ascontiguousarray(a.numpy()))
        for a in _sliced(lpc, rng))))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * float(x.abs().max()))
    if kind == "serving":
        assert not torch.equal(got, x)


def _random_slot_tables(seed, rows):
    """Packed planes with every case the plan must tell apart: empty rows,
    order-0 filters over a real range, start == end and start > end with
    real taps, ranges that end at bin 1024 or reach outside [0, 1024], a
    zero tap inside the order, and forward and reverse ranges that overlap."""
    rng = np.random.default_rng(seed)
    lpc = np.zeros((rows, 2, 8, 20), np.float32)
    ranges = np.zeros((rows, 2, 8, 2), np.int32)
    for r in range(1, rows):            # row 0 stays empty
        for d in range(2):
            for s in range(int(rng.integers(0, 9))):
                order = int(rng.integers(0, 21))
                taps = rng.uniform(-0.5, 0.5, order).astype(np.float32)
                if order > 2 and rng.random() < 0.3:
                    taps[int(rng.integers(0, order - 1))] = 0.0
                lpc[r, d, s, :order] = taps
                a, b = sorted(int(v) for v in rng.integers(-8, 1033, 2))
                kind = rng.integers(0, 5)
                if kind == 0:
                    b = a                       # start == end
                elif kind == 1:
                    b = 1024                    # ends at the last bin
                elif kind == 2:
                    a, b = b, a                 # start > end
                ranges[r, d, s] = (a, b)
    return lpc, ranges


def test_tns_work_plan_matches_brute_force():
    lpc, ranges = _random_slot_tables(17, 24)
    got = tns.plan(lpc, ranges)
    n_work = 0
    for r in range(lpc.shape[0]):
        for d in range(2):
            for s in range(8):
                start = max(int(ranges[r, d, s, 0]), 0)
                end = min(int(ranges[r, d, s, 1]), 1024)
                order = 0
                for i in range(20):
                    if lpc[r, d, s, i] != 0:
                        order = i + 1
                work = start < end and order > 0
                assert bool(got["work"][r, d, s]) == work, (r, d, s)
                if not work:
                    continue
                n_work += 1
                assert got["start"][r, d, s] == start
                assert got["end"][r, d, s] == end
                assert got["order"][r, d, s] == order
                cls = got["cls"][r, d, s]
                assert order <= tns.ORDER_CLASSES[cls]
                assert cls == 0 or order > tns.ORDER_CLASSES[cls - 1]
                assert got["list"][r, d, s] == (cls * tns.LEN_BUCKETS
                                                + (end - start - 1) // 128)
                assert 0 <= got["list"][r, d, s] < tns.N_LISTS
    assert not got["work"][0].any() and n_work > 40


def _random_f32(rng, n, lo_exp, hi_exp):
    mant = rng.uniform(1.0, 2.0, n)
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * mant * 2.0 ** rng.integers(lo_exp, hi_exp + 1, n)).astype(
        np.float32)


def test_two_prod_fma_form_equals_mask_split_form():
    """a * b = p + e: the kernel's e = fma(a, b, -p) against the plain
    version's mask-split sum, on 10^6 seeded pairs with exponents from
    2^-40 to 2^40 (products 2^-80 .. 2^81: no error term underflows).  They
    must be equal everywhere.  A second set with products around 2^-120
    counts where they part: only where the exact error term is no f32
    (below the smallest normal, 2^-126)."""
    rng = np.random.default_rng(2024)
    n = 1_000_000
    a, b = _random_f32(rng, n, -40, 40), _random_f32(rng, n, -40, 40)
    p1, e1 = tns.two_prod_split(a, b)
    p2, e2 = tns.two_prod_fma(a, b)
    assert np.array_equal(p1, p2) and np.array_equal(e1, e2)
    assert np.count_nonzero(e1) > n // 2
    # history values as the filter has them: a coefficient below 8 times a
    # spectral value up to 2^20
    a, b = _random_f32(rng, n, -12, 3), _random_f32(rng, n, -24, 20)
    assert np.array_equal(tns.two_prod_split(a, b)[1],
                          tns.two_prod_fma(a, b)[1])
    # near the bottom of the range the split form loses bits the FMA keeps
    a, b = _random_f32(rng, n, -70, -50), _random_f32(rng, n, -70, -50)
    e1, e2 = tns.two_prod_split(a, b)[1], tns.two_prod_fma(a, b)[1]
    exact = (a.astype(np.float64) * b.astype(np.float64)
             - (a * b).astype(np.float64))
    differ = e1 != e2
    assert differ.any()
    assert np.abs(exact[differ]).max() < 2.0 ** -126
    assert np.array_equal(e2.astype(np.float64)[np.abs(exact) >= 2.0 ** -126],
                          exact[np.abs(exact) >= 2.0 ** -126])


@pytest.mark.parametrize("kind", ["serving", "overlap", 12, 20])
def test_kernel_model_equals_plain_version(kind):
    """The numpy model of the kernel's steps (work items from `plan`,
    history from zero, the taps of the order class, FMA products, a forward
    item leaving the bins a reverse range covers) gives the plain version's
    bits; with one boundary of the plan moved it does not."""
    if kind == "overlap":
        q, sc, lpc, rng = overlap_tns_chunk()
    else:
        q, sc, lpc, rng = _packed_case(kind)
    want = tns.tns_packed_ref(*map(torch.from_numpy, (q, sc, lpc, rng))).numpy()
    got = tns.model(q, sc, lpc, rng)
    assert np.array_equal(got, want)
    x = decompress_i16(torch.from_numpy(q), torch.from_numpy(sc)).numpy()
    assert not np.array_equal(got, x)
    if kind == "overlap":
        assert np.array_equal(got[0, 2], x[0, 2])
        assert np.array_equal(got[0, 1, 650:700], x[0, 1, 650:700])
    work = tns.plan(lpc, rng)
    row, d, slot = (int(v[0]) for v in np.nonzero(work["work"]))
    work["start"] = work["start"].copy()
    work["start"][row, d, slot] += 1
    assert not np.array_equal(tns.model(q, sc, lpc, rng, work=work), want)
