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
    batch = {"meta": torch.zeros((C, T, 6), dtype=torch.int32),
             "spec": torch.zeros((C, T, 1024))}
    for name in ("has_pred", "has_cce_post", "has_cce_time", "spec_qsf",
                 "eld"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            P.decode_spec_step(batch, torch.zeros((C, 1024)),
                               P.PipelineFlags(**{name: True}))
