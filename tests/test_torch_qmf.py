"""The port's SBR QMF banks (aacjax_torch/kernels/qmf.py) against aacjax's
(aacjax/kernels/qmf.py, XLA on the CPU) on numpy-seeded inputs: analysis,
synthesis, and the analysis -> synthesis chain with its state carried over
chunks, within 1e-5 * max|ref|."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aacjax.kernels import qmf as jq
from aacjax_torch.kernels import qmf as tq

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    """Drop the compiled XLA programs when the module is done: a test
    worker keeps every program it compiled, and the HE ones are large."""
    yield
    jax.clear_caches()


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = TOL * max(1e-30, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= bound, f"{what}: max err {err} > {bound}"


@pytest.mark.parametrize("S", [1, 8, 9, 24])
def test_analysis_matches_reference(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, 32 * S)).astype(np.float32) * 1000
    h = rng.standard_normal((3, tq.ANA_HIST)).astype(np.float32) * 1000
    want = jq.analysis(jnp.asarray(x), jnp.asarray(h))
    got = tq.analysis(torch.from_numpy(x), torch.from_numpy(h))
    for name, g, w in zip(("X_re", "X_im", "history"), got, want):
        _close(g, w, f"analysis S={S} {name}")


@pytest.mark.parametrize("S", [1, 8, 9, 24])
def test_synthesis_matches_reference(S, monkeypatch):
    """The port's slice FIR against the reference's default form (the
    banded-Toeplitz products at S >= 9, the slices below).  At S == 9 the
    reference's Toeplitz branch returns an empty history (its
    v[:, S-1:S-10:-1] slice), so there the history is held to its slice
    form."""
    rng = np.random.default_rng(100 + S)
    xr = rng.standard_normal((3, S, 64)).astype(np.float32) * 300
    xi = rng.standard_normal((3, S, 64)).astype(np.float32) * 300
    vh = rng.standard_normal((3, tq.SYN_HIST, 128)).astype(np.float32) * 10
    args = [jnp.asarray(a) for a in (xr, xi, vh)]
    pcm, vhist = jq.synthesis(*args)
    if S == tq.SYN_HIST:
        assert vhist.shape[1] == 0          # the reference's empty slice
        monkeypatch.setattr(jq, "_FIR_MATMUL", False)
        _, vhist = jq.synthesis(*args)
    got_pcm, got_vhist = tq.synthesis(*(torch.from_numpy(a)
                                        for a in (xr, xi, vh)))
    _close(got_pcm, pcm, f"synthesis S={S} pcm")
    _close(got_vhist, vhist, f"synthesis S={S} history")


def _chain(mod, to, x, slots):
    """analysis(32) -> zero-pad to 64 bands -> synthesis(64) over x [B, N]
    in chunks of `slots` QMF slots, the state carried."""
    B, N = x.shape
    if mod is tq:
        ah, vh = tq.analysis_init(B, "cpu"), tq.synthesis_init(B, "cpu")
        cat = torch.cat
    else:
        ah, vh = jq.analysis_init(B), jq.synthesis_init(B)
        cat = jnp.concatenate
    outs = []
    for i in range(0, N, 32 * slots):
        xr, xi, ah = mod.analysis(to(x[:, i:i + 32 * slots]), ah)
        pad = to(np.zeros((B, xr.shape[1], 32), np.float32))
        pcm, vh = mod.synthesis(cat([xr, pad], 2), cat([xi, pad], 2), vh)
        outs.append(np.asarray(pcm))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("slots", [24, 8, 5])
def test_chain_with_chunked_state_matches_reference(slots):
    """The chain with its state carried over chunks of 24 (one shot), 8 or
    5 slots equals the reference's one-shot chain."""
    x = np.random.default_rng(3).standard_normal((2, 32 * 24)).astype(
        np.float32) * 1000
    want = _chain(jq, jnp.asarray, x, 24)
    got = _chain(tq, torch.from_numpy, x, slots)
    _close(got, want, f"chain in chunks of {slots} slots")
