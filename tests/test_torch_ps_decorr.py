"""The fused PS decorrelator's plain version and its numpy model, on the CPU.

`ps_decorr.decorrelate_chunk_ref` (what `ps_batch._decorrelate` runs on CPU
tensors, and what the CUDA kernel equals bit for bit on the card) against
the reference's `_decorrelate` (JAX through XLA on the CPU, its scan mode
patched as its own tests patch it) over three chunks with a non-zero state
carried, in both band modes at T = 1 and T = 8: within 2e-6 * max(1,
max|ref|) of the sequential `seq` form, and 2e-4 of the default Toeplitz
(`matmul`) and doubling (`assoc`) forms, which reassociate the recurrences
(their own agreement bound, test_ps_batch.py).  `ps_decorr.model`, the
kernel's tile schedule in numpy (ring of stages, history from the state,
member order of the power sums, the epilogue's indexing), equals the plain
version bit for bit.  The member-order power sum is held to the indicator
product: torch.matmul's within one ulp of the largest power, the
reference's (XLA's einsum) within the error bound of the two sums.  Shapes are small (B <= 8 rows, T <= 8 frames) so that the
test workers stay small.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aacjax.kernels import ps_batch as JPS
from aacjax_torch import testing as TI
from aacjax_torch.kernels import ps_batch as TPS
from aacjax_torch.kernels import ps_decorr

B = 5
CPU = torch.device("cpu")


def _chunks(is34, T, seed):
    """Three chunks of hybrid planes and one carried state (numpy)."""
    s_r, s_i, state = TI.ps_decorr_inputs(seed, B, 3 * 32 * T, is34)
    S = 32 * T
    return [(s_r[:, k * S:(k + 1) * S], s_i[:, k * S:(k + 1) * S])
            for k in range(3)], state


def _close(got, want, what, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"{what}: max err {err / scale:.3g} * scale"


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _run_torch(chunks, state, is34):
    c = TPS._consts(is34, CPU)
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    outs = []
    for r, i in chunks:
        d_r, d_i, st = TPS._decorrelate(torch.from_numpy(np.ascontiguousarray(
            r)), torch.from_numpy(np.ascontiguousarray(i)), st, c, is34)
        outs.append((d_r.numpy(), d_i.numpy()))
    return outs, {k: v.numpy() for k, v in st.items()}


def _run_jax(chunks, state, is34, mode):
    old = (JPS._SEQ_SCAN, JPS._SCAN_MODE)
    JPS._SCAN_MODE, JPS._SEQ_SCAN = mode, mode == "seq"
    try:
        st = {k: jnp.asarray(v) for k, v in state.items()}
        outs = []
        for r, i in chunks:
            d_r, d_i, st = JPS._decorrelate(
                jnp.asarray(r), jnp.asarray(i), st, JPS._consts(is34), B,
                r.shape[1], is34)
            outs.append((np.asarray(d_r), np.asarray(d_i)))
        return outs, {k: np.asarray(v) for k, v in st.items()}
    finally:
        JPS._SEQ_SCAN, JPS._SCAN_MODE = old


@pytest.mark.parametrize("mode,tol", [("seq", 2e-6), ("matmul", 2e-4),
                                      ("assoc", 2e-4)])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("is34", [False, True])
def test_plain_version_matches_reference_decorrelate(is34, T, mode, tol):
    chunks, state = _chunks(is34, T, 11 + T + is34)
    (outs_t, st_t), (outs_j, st_j) = (_run_torch(chunks, state, is34),
                                      _run_jax(chunks, state, is34, mode))
    for k, ((tr, ti), (jr, ji)) in enumerate(zip(outs_t, outs_j)):
        assert tr.shape == jr.shape == (B, 32 * T, TPS._NB[is34])
        _close(tr, jr, f"{mode} chunk {k} re", tol)
        _close(ti, ji, f"{mode} chunk {k} im", tol)
    for k in ps_decorr.STATE_KEYS:
        _close(st_t[k], st_j[k], f"{mode} state {k}", tol)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("is34", [False, True])
def test_model_equals_plain_version_bit_for_bit(is34, T):
    """The kernel's tile schedule in numpy, three chunks with the state
    carried, every output and state bit for bit."""
    chunks, state = _chunks(is34, T, 3 + T + is34)
    c = TPS._consts(is34, CPU)
    cn = {k: c[k].numpy() for k in ps_decorr.CONST_KEYS}
    sdb = TPS._SDB[is34]
    st_p = {k: torch.from_numpy(v) for k, v in state.items()}
    st_m = state
    for k, (r, i) in enumerate(chunks):
        r, i = np.ascontiguousarray(r), np.ascontiguousarray(i)
        want_r, want_i, st_p = ps_decorr.decorrelate_chunk_ref(
            torch.from_numpy(r), torch.from_numpy(i), st_p, c, sdb)
        got_r, got_i, st_m = ps_decorr.model(r, i, st_m, cn, sdb)
        assert np.array_equal(_bits(got_r), _bits(want_r.numpy())), k
        assert np.array_equal(_bits(got_i), _bits(want_i.numpy())), k
        for key in ps_decorr.STATE_KEYS:
            assert np.array_equal(_bits(st_m[key]),
                                  _bits(st_p[key].numpy())), (k, key)


@pytest.mark.parametrize("is34", [False, True])
def test_member_order_power_sum_against_indicator_product(is34):
    """The power per parameter band summed over the members in ascending
    order (the kernel's order) against the product with the [nb, npar]
    indicator: torch.matmul's within one ulp of the largest power, the
    reference's (XLA's einsum, another order) within the error bound of
    the two sums; the member table lists each band's
    hybrid bands in ascending order, padded with nb."""
    s_r, s_i, _ = TI.ps_decorr_inputs(21 + is34, B, 64, is34)
    c = TPS._consts(is34, CPU)
    k_to_i = TPS.consts_np(is34)["k_to_i"]
    npar, nb = TPS._NPAR[is34], TPS._NB[is34]
    members = c["members"].numpy()
    for p in range(npar):
        row = members[p][members[p] < nb]
        assert np.array_equal(row, np.flatnonzero(k_to_i == p))
        assert (members[p][len(row):] == nb).all()
    got = ps_decorr.band_power(torch.from_numpy(s_r), torch.from_numpy(s_i),
                               c["members"]).numpy()
    ind = (k_to_i[:, None] == np.arange(npar)[None, :]).astype(np.float32)
    e = s_r * s_r + s_i * s_i
    # torch.matmul: within one ulp of the largest power
    want = torch.matmul(torch.from_numpy(e), torch.from_numpy(ind)).numpy()
    ulp = np.spacing(np.float32(np.abs(got).max()))
    assert float(np.abs(got - want).max()) <= ulp
    # the reference's product sums in XLA's order: within the bound of two
    # sums of M non-negative terms, M * 2^-23 of each power
    want = np.asarray(jnp.einsum("bsk,kp->bsp", jnp.asarray(e),
                                 jnp.asarray(ind), precision="highest"))
    M = members.shape[1]
    assert (np.abs(got - want) <= M * 2.0 ** -23 * want).all()
