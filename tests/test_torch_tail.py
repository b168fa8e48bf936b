"""The port's fused decode tail (aacjax_torch.kernels.tail) against the JAX
reference: the Pallas kernel in interpret mode and the XLA decode step,
on the same numpy-seeded random chunks.

Tolerances are the reference's own for its Pallas tail
(tests/test_pallas_tail.py): int16 PCM within 1 LSB with fewer than 2% of
samples differing (matmul rounding can flip round() on .5 boundaries);
f32 PCM within 5e-5 * max(1, max|ref|); the carried overlap within 3e-3.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aacjax.kernels import pallas_tail as PT
from aacjax.kernels import pipeline as JP
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import tail
from aacjax_torch.testing import (TAIL_ARGS, assert_pcm_close,
                                  random_tail_chunk)

C, T = 8, 4


def _mk_batch(seed, i16, has_short=True):
    """Random ragged chunk (channel 0 with no frames: last_valid = -1) and
    its incoming overlap, as numpy arrays."""
    b = random_tail_chunk(seed, C, T, i16=i16, has_short=has_short)
    return b, b.pop("overlap")


def _torch_args(b, overlap):
    return [None if b[k] is None else torch.from_numpy(b[k])
            for k in TAIL_ARGS[:-1]] + [torch.from_numpy(overlap)]


def _jax_args(b, overlap):
    out = [None if b[k] is None else jnp.asarray(b[k]) for k in TAIL_ARGS[:-1]]
    out[6] = out[6] != 0      # is_short, valid as bool (the reference's)
    out[7] = out[7] != 0
    return out + [jnp.asarray(overlap)]


def _meta(b):
    return np.stack([b["f_idx"], b["s_idx"], b["shape_idx"],
                     b["prev_shape_idx"], b["is_short"], b["valid"]], -1)


@pytest.mark.parametrize("has_short", [True, False])
@pytest.mark.parametrize("out_int16", [True, False])
@pytest.mark.parametrize("i16", [False, True])
def test_tail_ref_matches_pallas_and_xla(i16, out_int16, has_short):
    b, overlap = _mk_batch(7 + i16 + 2 * out_int16, i16, has_short)
    pcm, ov = tail.decode_tail_ref(*_torch_args(b, overlap),
                                   out_int16=out_int16, has_short=has_short)
    want_pcm, want_ov = PT.decode_tail(*_jax_args(b, overlap),
                                       out_int16=out_int16,
                                       has_short=has_short, interpret=True)
    assert_pcm_close(pcm, want_pcm, out_int16, "vs pallas interpret")
    np.testing.assert_allclose(ov.numpy(), np.asarray(want_ov), atol=3e-3)
    np.testing.assert_array_equal(ov[0].numpy(), overlap[0])  # no frames

    batch = {"meta": jnp.asarray(_meta(b))}
    batch.update({"spec_i16": jnp.asarray(b["spec"]),
                  "spec_scale": jnp.asarray(b["spec_scale"])} if i16
                 else {"spec": jnp.asarray(b["spec"])})
    flags = JP.PipelineFlags(has_stereo=False, out_int16=out_int16,
                             spec_i16=i16, has_short=has_short)
    xla_pcm, xla_ov = JP.decode_spec_step(batch, jnp.asarray(overlap), flags)
    assert_pcm_close(pcm, xla_pcm, out_int16, "vs xla")
    np.testing.assert_allclose(ov.numpy(), np.asarray(xla_ov), atol=3e-3)


@pytest.mark.parametrize("i16", [False, True])
def test_decode_spec_step_routes_through_tail(i16):
    """The port's decode_spec_step (packed meta, tail route) equals the
    plain tail on CPU tensors and the XLA step."""
    b, overlap = _mk_batch(21 + i16, i16)
    batch = {"meta": torch.from_numpy(_meta(b))}
    batch.update({"spec_i16": torch.from_numpy(b["spec"]),
                  "spec_scale": torch.from_numpy(b["spec_scale"])} if i16
                 else {"spec": torch.from_numpy(b["spec"])})
    flags = P.PipelineFlags(has_stereo=False, out_int16=True, spec_i16=i16,
                            use_pallas=True)
    assert tail.supported(flags, C, T, 1024)
    pcm, ov = P.decode_spec_step(batch, torch.from_numpy(overlap), flags)
    want, want_ov = tail.decode_tail_ref(*_torch_args(b, overlap),
                                         out_int16=True, has_short=True)
    assert torch.equal(pcm, want) and torch.equal(ov, want_ov)


def test_supported_gate_matches_reference():
    for flags_kw in ({}, {"eld": True}, {"has_pred": True},
                     {"has_cce_post": True}, {"has_cce_time": True}):
        for shape in ((8, 4, 1024), (9, 4, 1024), (8, 64, 1024),
                      (8, 65, 1024), (8, 4, 960)):
            want = PT.supported(JP.PipelineFlags(**flags_kw), *shape)
            got = tail.supported(P.PipelineFlags(**flags_kw), *shape)
            assert got == want, (flags_kw, shape)


def test_decode_spec_step_raises_for_unported_flags():
    """No flag of the step is left unported: each of the five that used to
    raise NotImplementedError now decodes a chunk of zeros to silence (and
    a missing batch entry is a KeyError, not a refusal)."""
    from aacjax_torch.kernels import pred
    meta = torch.zeros((C, T, 6), dtype=torch.int32)
    meta[..., 5] = 1
    extra = {
        "has_pred": {"pred_meta": torch.ones((C, T, 3), dtype=torch.int32),
                     "pred_used_u8": torch.ones((C, T, 672),
                                                dtype=torch.uint8)},
        "has_cce_post": {"cce_post_idx": torch.zeros((1, 3),
                                                     dtype=torch.int32),
                         "cce_post_gain": torch.ones((1, 1024))},
        "has_cce_time": {"cce_time_idx": torch.zeros((1, 3),
                                                     dtype=torch.int32),
                         "cce_time_gain": torch.ones(1)},
        "spec_qsf": {"spec_q": torch.zeros((C, T, 1024), dtype=torch.int16),
                     "spec_sf": torch.zeros((C, T, 256), dtype=torch.uint8)},
        "eld": {},
    }
    for name, more in extra.items():
        F = 512 if name == "eld" else 1024
        batch = {"meta": meta, "spec": torch.zeros((C, T, F)), **more}
        overlap = torch.zeros((C, 3 * F if name == "eld" else F))
        state = (pred.pred_state_init(C),) if name == "has_pred" else ()
        out = P.decode_spec_step(batch, overlap,
                                 P.PipelineFlags(**{name: True}), *state)
        assert len(out) == (3 if name == "has_pred" else 2)
        assert out[0].shape == (C, T, F) and not out[0].any()
        assert out[1].shape == overlap.shape
    with pytest.raises(KeyError):
        P.decode_spec_step({"meta": meta, "spec": torch.zeros((C, T, 1024))},
                           torch.zeros((C, 1024)),
                           P.PipelineFlags(has_cce_time=True))
