"""How the SBR program amplifies a last-bit difference in the HE core, in
both packages on the CPU, and the int16 bound that tests/test_torch_cuda.py
holds the card's HE and PS routes to (aacjax_torch.testing.HE_I16_ONSET /
HE_I16_STEADY).

On the card the kernel route's core (the tail kernel's FFT IMDCT) and the
plain route's (the dense IMDCT) differ by float rounding.  Here the same two
forms run on the CPU: the port's numpy model of the kernel's FFT passes
(kernels/imdct.py) and its dense filterbank; the reference's Pallas tail in
interpret mode and its XLA filterbank.  Each core goes through the SBR
program with int16 output (the port's sbr_apply and the reference's).  Two
stereo streams x 4 frames of HE-512's traffic (he_chunk), low-passed at
3.6 kHz as bench_he builds it, and the same noise unfiltered.

Measured (this file; `-s` prints the lines): the port's FFT and dense cores
differ by 4.2e-7 (low-passed) and 6.0e-7 (full-band) of full scale.
Through the port's SBR program, frames 0-1 differ by 4 LSB on 12.0% of
their samples (low-passed) and 5 LSB on 16.8% (full-band), frames 2-3 by 1
LSB on 0.15% and 0.23%.  The reference's SBR program on the same two cores:
4 LSB on 12.1% / 1 LSB on 0.18%, and 5 LSB on 16.8% / 1 LSB on 0.21%.  The
reference's own two core forms are equal here, so they show no growth
between them.  The growth is the SBR math's, not the port's: the two SBR
programs on one core agree within 1 LSB on <= 0.15% of samples.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aacjax.host import sbr as JS
from aacjax.kernels import pallas_tail as PT
from aacjax.kernels import pipeline as JP
from aacjax.kernels import sbr_batch as JB
from aacjax_torch import testing as TI
from aacjax_torch.host import native
from aacjax_torch.kernels import imdct
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import sbr_batch as TB
from aacjax_torch.runtime.batch import BatchDecoder

T = 4


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    yield
    jax.clear_caches()


def _cores(chunk, config):
    """The chunk's core PCM in the four forms, [C, T, 1024] f32 in the
    1/32768 scale, and its SBR planes and cfg planes."""
    dec = BatchDecoder([config] * len(chunk), chunk_frames=T, device="cpu")
    parsed, dense, ctx = dec._he_host_phase(chunk, compact=False)
    b = P.unpack_spec_batch(dict(parsed))
    spec = b["spec"]
    C, _, F = spec.shape
    idx = [b[k] for k in ("f_idx", "s_idx", "shape_idx", "prev_shape_idx",
                          "is_short")]
    ov = torch.zeros(C, F)
    dense_pcm, _ = P.overlap_add(*P.filterbank(spec, *idx), ov,
                                 b["last_valid"])
    halves = imdct.model_halves(spec.reshape(C * T, F).numpy(),
                                *(a.reshape(C * T).numpy() for a in idx))
    fft_pcm, _ = P.overlap_add(*(torch.from_numpy(h).reshape(C, T, F)
                                 for h in halves), ov, b["last_valid"])
    # the reference's tail tiles 8 channels: pad with silent channels
    Cp = -(-C // PT.TILE_C) * PT.TILE_C

    def pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((Cp - C,) + a.shape[1:], a.dtype)])
    jidx = [jnp.asarray(pad(a.numpy())) for a in idx]
    jspec = jnp.asarray(pad(spec.numpy()))
    lv = jnp.asarray(pad(b["last_valid"].numpy() + 1) - 1)
    jov = jnp.zeros((Cp, F), jnp.float32)
    pallas, _ = PT.decode_tail(
        jspec, None, *jidx[:4], jidx[4] != 0,
        jnp.asarray(pad(b["valid"].numpy()) != 0), lv, jov,
        out_int16=False, has_short=True, interpret=True)
    xla, _ = JP.overlap_add(*JP.filterbank(jspec, *jidx[:4], jidx[4]), jov, lv)
    cores = dict(port_dense=dense_pcm.numpy() / 32768.0,
                 port_fft=fft_pcm.numpy() / 32768.0,
                 ref_pallas=np.asarray(pallas)[:C],
                 ref_xla=np.asarray(xla)[:C] / 32768.0)
    return cores, {k: np.ascontiguousarray(v) for k, v in dense.items()}, ctx


@pytest.mark.skipif(not native.available(), reason="native parser not built")
@pytest.mark.parametrize("lowpass", [True, False],
                         ids=["low-passed", "full-band"])
def test_sbr_amplifies_core_rounding_in_both_packages(lowpass):
    config, chunk = TI.he_chunk(2, T, lowpass=lowpass)
    cores, planes, ctx = _cores(chunk, config)
    C = cores["port_dense"].shape[0]
    hdr = ctx["records"][0][0][1].header
    jcfg = {k: jnp.asarray(v) for k, v in JB.broadcast_cfg(
        JB.SBRStaticConfig.from_tables(
            JS.derive_tables(hdr, 44100),
            float(JS._consts()["limgain"][hdr.limiter_gains])), C).items()}
    tcfg = {k: torch.from_numpy(v) for k, v in ctx["cfg"].items()}
    jfn = JB.jitted_sbr_apply(True)

    def port_sbr(core):
        return TB.sbr_apply(torch.from_numpy(np.asarray(core, np.float32)),
                            {k: torch.from_numpy(v) for k, v in planes.items()},
                            TB.sbr_state_init(C, "cpu"), tcfg, True)[0].numpy()

    def ref_sbr(core):
        return np.asarray(jfn(jnp.asarray(core, jnp.float32),
                              {k: jnp.asarray(v) for k, v in planes.items()},
                              JB.sbr_state_init(C), jcfg)[0])

    core_diff = float(np.abs(cores["port_fft"] - cores["port_dense"]).max())
    assert 0 < core_diff < 2e-6
    assert np.array_equal(cores["ref_pallas"], cores["ref_xla"])
    port = TI.he_i16_stats(
        [(port_sbr(cores["port_fft"]), port_sbr(cores["port_dense"]), 0)])
    ref = TI.he_i16_stats(
        [(ref_sbr(cores["port_fft"]), ref_sbr(cores["port_dense"]), 0)])
    ref_own = TI.he_i16_stats(
        [(ref_sbr(cores["ref_pallas"]), ref_sbr(cores["ref_xla"]), 0)])
    same = TI.he_i16_stats(
        [(port_sbr(cores["port_dense"]), ref_sbr(cores["port_dense"]), 0)])
    print(f"\n{'low-passed' if lowpass else 'full-band'}: core diff "
          f"{core_diff:.3g}; max LSB / share (onset, steady): port "
          f"{port['onset'][:2]}, {port['steady'][:2]}; reference on the same "
          f"cores {ref['onset'][:2]}, {ref['steady'][:2]}; reference's own "
          f"forms {ref_own['onset'][:2]}; port vs reference on one core "
          f"{same['onset'][:2]}, {same['steady'][:2]}")
    for part, (limit, share) in (("onset", TI.HE_I16_ONSET),
                                 ("steady", TI.HE_I16_STEADY)):
        for name, st in (("port", port), ("reference", ref)):
            assert st[part][0] <= limit and st[part][1] < share, (name, part)
        # the same growth in both packages' SBR programs
        assert abs(port[part][0] - ref[part][0]) <= 1, part
        assert abs(port[part][1] - ref[part][1]) <= 0.01, part
        assert ref_own[part][0] == 0, part
        assert same[part][0] <= 1 and same[part][1] < 0.02, part
    # the amplification is real: far above the core's 0.02 LSB
    assert port["onset"][0] >= 2
