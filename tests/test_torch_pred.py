"""The Main-profile predictor of the port against the JAX package's, on the
CPU: `aacjax_torch.kernels.pred.apply_prediction` (its plain version here)
and `aacjax.kernels.pipeline.apply_prediction` on the same numpy-seeded
inputs, and the numpy model of the CUDA kernel's loop against both.

Tolerance: none.  Spectra and state are compared as uint32 bit patterns.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aacjax.kernels import pipeline as JP
from aacjax_torch.kernels import pred


def pred_chunk(seed, C, T, F=1024, amp=300.0):
    """Random predictor inputs: every mode (0 none, 1 long, 2 short) with
    mode 1 the most frequent, reset groups 0..30 on a third of the frames,
    nbins below and at 672, `used` set per band-like run on half the bins."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((C, T, F)) * amp).astype(np.float32)
    mode = rng.choice([0, 1, 1, 1, 1, 2], size=(C, T)).astype(np.int32)
    reset = np.where(rng.random((C, T)) < 0.33,
                     rng.integers(1, 31, (C, T)), 0).astype(np.int32)
    nbins = rng.choice([672, 672, 640, 512, 100], size=(C, T)).astype(np.int32)
    used = np.repeat(rng.random((C, T, 672 // 16)) < 0.5, 16,
                     axis=-1).astype(np.uint8)
    return spec, mode, reset, nbins, used


def jax_step(spec, mode, reset, nbins, used, state):
    batch = dict(pred_mode=jnp.asarray(mode), pred_reset=jnp.asarray(reset),
                 pred_nbins=jnp.asarray(nbins),
                 pred_used=jnp.asarray(used.astype(np.float32)))
    out, st = JP.apply_prediction(jnp.asarray(spec), batch, jnp.asarray(state))
    return np.asarray(out), np.asarray(st)


def torch_step(spec, mode, reset, nbins, used, state):
    out, st = pred.apply_prediction(*(torch.from_numpy(a) for a in (
        spec, mode, reset, nbins, used, state)))
    return out.numpy(), st.numpy()


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_state_init_matches_reference():
    np.testing.assert_array_equal(pred.pred_state_init(5).numpy(),
                                  np.asarray(JP.pred_state_init(5)))


@pytest.mark.parametrize("mode", ["round", "even", "trunc"])
def test_flt16_matches_reference(mode):
    """Also where the uint32 sum wraps: negative floats near 0xFFFF8000."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 32, 200000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x = np.concatenate([x, np.array([0xFFFF8000, 0xFFFFFFFF, 0x7FFF8000,
                                     0x80000000, 0x00007FFF, 0x00018000],
                                    np.uint32).view(np.float32)])
    want = np.asarray(JP._flt16(jnp.asarray(x), mode))
    got = pred._flt16(torch.from_numpy(x), mode).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(pred._flt16_np(x, mode)), bits(want))


@pytest.mark.parametrize("C,T,seed", [(4, 6, 0), (3, 16, 1), (8, 1, 2)])
def test_prediction_matches_reference_bit_for_bit(C, T, seed):
    """Three chunks with the state carried: spectra and state equal the
    reference's bits after every chunk."""
    state_j = state_t = np.array(JP.pred_state_init(C))
    for chunk in range(3):
        args = pred_chunk(10 * seed + chunk, C, T)
        want, state_j = jax_step(*args, state_j)
        got, state_t = torch_step(*args, state_t)
        np.testing.assert_array_equal(bits(got), bits(want))
        np.testing.assert_array_equal(bits(state_t), bits(state_j))
    assert not np.array_equal(state_t, np.asarray(JP.pred_state_init(C)))
    assert np.isfinite(got).all()


def test_prediction_changes_only_used_bins_of_long_frames():
    spec, mode, reset, nbins, used = pred_chunk(7, 3, 8)
    state = pred.pred_state_init(3).numpy()
    got, _ = torch_step(spec, mode, reset, nbins, used, state)
    np.testing.assert_array_equal(got[..., 672:], spec[..., 672:])
    off = (used == 0) | (mode != 1)[..., None]
    # s + pv * 0 may turn a -0.0 into +0.0 and nothing else
    np.testing.assert_array_equal(got[..., :672][off], spec[..., :672][off])
    assert (got[..., :672] != spec[..., :672]).any()


def test_mode_zero_leaves_the_state_and_short_frames_reset_it():
    C, T = 2, 4
    spec, mode, reset, nbins, used = pred_chunk(5, C, T)
    mode[:] = 1
    reset[:] = 0
    _, st = torch_step(spec, mode, reset, nbins, used,
                       pred.pred_state_init(C).numpy())
    mode[0] = 0
    mode[1] = 2
    _, st2 = torch_step(spec, mode, reset, nbins, used, st)
    np.testing.assert_array_equal(bits(st2[0]), bits(st[0]))
    np.testing.assert_array_equal(st2[1], pred.pred_state_init(1).numpy()[0])


def test_reset_group_resets_its_bins_after_the_update():
    C, T = 1, 1
    spec, mode, reset, nbins, used = pred_chunk(6, C, T)
    mode[:], reset[:], nbins[:] = 1, 7, 672
    _, st = torch_step(spec, mode, reset, nbins, used,
                       pred.pred_state_init(C).numpy())
    hit = np.arange(672) % 30 == 6
    np.testing.assert_array_equal(st[0, hit],
                                  pred.pred_state_init(1).numpy()[0, hit])
    assert (st[0, ~hit, 0] != 0).all()


def test_used_as_float_equals_used_as_uint8():
    args = pred_chunk(8, 2, 5)
    state = pred.pred_state_init(2).numpy()
    a, sa = torch_step(*args, state)
    b, sb = torch_step(*args[:4], args[4].astype(np.float32), state)
    np.testing.assert_array_equal(bits(a), bits(b))
    np.testing.assert_array_equal(bits(sa), bits(sb))


def test_kernel_model_matches_plain_version_bit_for_bit():
    """The kernel's loop (one bin at a time, the state in scalars, the
    update skipped where the plain version selects the old value) gives the
    plain version's bits, over two chunks."""
    C, T = 2, 5
    state_m = state_t = pred.pred_state_init(C).numpy()
    for chunk in range(2):
        spec, mode, reset, nbins, used = pred_chunk(20 + chunk, C, T, F=700)
        want, state_t = torch_step(spec, mode, reset, nbins, used, state_t)
        got, state_m = pred.model(spec, mode, reset, nbins, used, state_m)
        np.testing.assert_array_equal(bits(got), bits(want))
        np.testing.assert_array_equal(bits(state_m), bits(state_t))


def test_wrapper_leaves_its_arguments_unchanged_on_cpu():
    args = [torch.from_numpy(a) for a in pred_chunk(9, 2, 3)]
    state = pred.pred_state_init(2)
    keep = [a.clone() for a in (*args, state)]
    pred.apply_prediction(*args, state, inplace=True)
    for a, k in zip((*args, state), keep):
        assert torch.equal(a, k)
