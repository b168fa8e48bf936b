"""The port's synthesis filterbank (aacjax_torch.kernels.synth) against the
reference's Pallas kernel in interpret mode, on numpy-seeded batches of
all four window sequences.  Tolerance: the reference's CPU bound for its
kernel (tests/test_pallas_synth.py), 2e-5 * max(1, max|ref|); through
decode_spec_step, the f32 PCM bound 5e-5 * max(1, max|ref|) and the
carried overlap within 3e-3 (tests/test_pallas_tail.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aacjax.kernels import pipeline as JP
from aacjax.kernels.pallas_synth import synthesis as jax_synthesis
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import synth
from aacjax_torch.testing import (assert_pcm_close, random_synth_batch,
                                  random_tail_chunk)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthesis_ref_matches_pallas(seed):
    args = random_synth_batch(seed, 16)
    first, second = synth.synthesis_ref(*(torch.from_numpy(a) for a in args))
    want_f, want_s = jax_synthesis(*(jnp.asarray(a) for a in args),
                                   interpret=True)
    want_f, want_s = np.asarray(want_f), np.asarray(want_s)
    scale = max(1.0, float(np.abs(want_f).max()), float(np.abs(want_s).max()))
    np.testing.assert_allclose(first.numpy(), want_f, atol=2e-5 * scale)
    np.testing.assert_allclose(second.numpy(), want_s, atol=2e-5 * scale)


@pytest.mark.parametrize("C,T", [(3, 5), (4, 64)])
def test_decode_spec_step_routes_through_synthesis(monkeypatch, C, T):
    """Where the tail's gate fails (C % 8 != 0), the kernel route takes the
    synthesis entry for any C*T (3*5 = 15 is no multiple of 8) and agrees
    with the XLA step."""
    b = random_tail_chunk(C * T, C, T, i16=False)
    overlap = b.pop("overlap")
    meta = np.stack([b[k] for k in ("f_idx", "s_idx", "shape_idx",
                                    "prev_shape_idx", "is_short", "valid")],
                    -1)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return synth.synthesis_ref(*args)

    monkeypatch.setattr(synth, "synthesis", counted)
    flags = P.PipelineFlags(has_stereo=False, use_pallas=True)
    pcm, ov = P.decode_spec_step(
        {"meta": torch.from_numpy(meta), "spec": torch.from_numpy(b["spec"])},
        torch.from_numpy(overlap), flags)
    assert calls == [(C * T, 1024)]
    want, want_ov = JP.decode_spec_step(
        {"meta": jnp.asarray(meta), "spec": jnp.asarray(b["spec"])},
        jnp.asarray(overlap), JP.PipelineFlags(has_stereo=False))
    assert_pcm_close(pcm, want, False, "vs xla")
    np.testing.assert_allclose(ov.numpy(), np.asarray(want_ov), atol=3e-3)


def test_synthesis_wrapper_runs_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in random_synth_batch(3, 8)]
    before = synth.launches
    got = synth.synthesis(*args)
    want = synth.synthesis_ref(*args)
    assert synth.launches == before     # no kernel on CPU tensors
    assert all(torch.equal(g, w) for g, w in zip(got, want))
