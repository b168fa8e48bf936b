"""The port's HE-AAC v2 (Parametric Stereo) path against aacjax's on the same
inputs, on the CPU (JAX through XLA, the port with device="cpu"):

  * `ps_batch` stage by stage: the constants, the hybrid analysis, the
    decorrelator (the kernel's plain version `ps_decorr.decorrelate_ref`
    against the reference's sequential forms and its default forms), the
    mixing matrices' gathers against the reference's one-hot selections,
    `ps_apply`, `sbr_ps_apply` and `sbr_ps_apply_dual` in both band modes;
  * `BatchDecoder.step_he_raw` and `decode_he_pipelined` on PS streams,
    `save_state` / `restore_state`, the sticky band-flip re-adoption and the
    mixed 20/34 batch of test_readopt, against aacjax's BatchDecoder;
  * `decode_adts`, `decode_loas` and the streaming `AACDecoder`, and
    `decode_adts` against libavcodec (> 70 dB on both channels).

Tolerances: f32 PCM and state within 2e-4 * max(1, max|ref|) (the SBR
slice's bound; the reference's default decorrelator forms agree with its
sequential ones to that bound, test_ps_batch.py); the decorrelator's plain
version within 2e-6 * max(1, max|ref|) of the reference's sequential form;
int16 within 1 LSB on < 2% of samples; the gathers exactly.  Shapes are few
and small (<= 6 frames, <= 4 slots): every new shape is a new XLA compile.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import aacjax_torch
from aacjax.host import sbr as JS
from aacjax.kernels import ps_batch as JPS
from aacjax.kernels import sbr_batch as JB
from aacjax.runtime.batch import BatchDecoder as JaxDecoder
from aacjax_torch.host import adts, native
from aacjax_torch.host import ps_pack as PP
from aacjax_torch.host.asc import parse_asc
from aacjax_torch.host.bitio import BitReader, BitWriter
from aacjax_torch.host.ps import PSContext, read_ps_data
from aacjax_torch.kernels import ps_batch as TPS
from aacjax_torch.kernels import ps_decorr
from aacjax_torch.kernels import sbr_batch as TSB
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.runtime.batch import BatchDecoder
from aacjax_torch.testing import ps_flip_stream, ps_specs, ps_stream
from aacjax_torch.testing.sbr_encoder import PSSpec, write_ps_data
from test_ps import _make_flip_stream, _snr, make_ps_stream

B, T = 3, 4
S = 32 * T


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    """Drop the compiled XLA programs when the module is done: a test
    worker keeps every program it compiled, and the PS ones are large."""
    yield
    jax.clear_caches()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (float(np.abs(got - want).max())
            / max(1.0, float(np.abs(want).max())))


def _assert_f32(got, want, what, tol=2e-4):
    err = _rel(got, want)
    assert err <= tol, f"{what}: max err {err:.3g} * max(1, max|ref|)"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- constants and the hybrid analysis -------------------------------------------
@pytest.mark.parametrize("is34", [False, True])
def test_consts_equal_reference(is34):
    want = JPS._consts(is34)
    got = TPS.consts_np(is34)
    for k, v in want.items():
        if k == "delay_off":     # the port slices the two delays statically
            continue
        if isinstance(v, list):
            assert len(got[k]) == len(v), k
            for g, w in zip(got[k], v):
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v) != 0
                                          if k == "conj_mask" else v,
                                          err_msg=k)
    st = TPS.ps_state_init(2, is34, "cpu")
    jst = JPS.ps_state_init(2, is34)
    assert sorted(st) == sorted(jst)
    for k in st:
        assert tuple(st[k].shape) == tuple(jst[k].shape), k


def _planes(rng, Bn=B, Sn=S):
    """Random X planes [B,S,64] and the continuous low-band line
    [B,8+S,5] (rows = X slots -2 .. S+5), 32768 scale."""
    Xr = rng.standard_normal((Bn, Sn, 64)).astype(np.float32) * 300
    Xi = rng.standard_normal((Bn, Sn, 64)).astype(np.float32) * 300
    lo_r = rng.standard_normal((Bn, 8 + Sn, 5)).astype(np.float32) * 300
    lo_i = rng.standard_normal((Bn, 8 + Sn, 5)).astype(np.float32) * 300
    return Xr, Xi, lo_r, lo_i


@pytest.mark.parametrize("is34", [False, True])
def test_hybrid_analysis_matches_reference(is34):
    rng = np.random.default_rng(3)
    Xr, Xi, lo_r, lo_i = _planes(rng)
    h4 = rng.standard_normal((2, B, 4, 5)).astype(np.float32) * 300
    lr, li = (np.concatenate([h, x], axis=1)
              for h, x in zip(h4, (lo_r, lo_i)))
    want = JPS._hybrid_analysis(jnp.asarray(Xr), jnp.asarray(Xi),
                                jnp.asarray(lr), jnp.asarray(li),
                                JPS._consts(is34), B, S, is34)
    got = TPS._hybrid_analysis(_t(Xr), _t(Xi), _t(lr), _t(li),
                               TPS._consts(is34, torch.device("cpu")), is34)
    for g, w, part in zip(got, want, ("re", "im")):
        assert tuple(g.shape) == (B, S, TPS._NB[is34])
        _assert_f32(g.numpy(), w, f"hybrid {part}", 2e-6)


# -- the decorrelator ------------------------------------------------------------
def _decorr_inputs(is34, seed):
    rng = np.random.default_rng(seed)
    nb = TPS._NB[is34]
    return [(rng.standard_normal((B, 64, nb)).astype(np.float32) * 100,
             rng.standard_normal((B, 64, nb)).astype(np.float32) * 100)
            for _ in range(2)]


def _jax_decorrelate(chunks, is34, mode):
    """The reference's _decorrelate in scan mode `mode` over the chunks with
    the state carried (module globals patched, as its own tests do)."""
    old = (JPS._SEQ_SCAN, JPS._SCAN_MODE)
    JPS._SCAN_MODE, JPS._SEQ_SCAN = mode, mode == "seq"
    try:
        st = {k: jnp.asarray(v) for k, v in JPS.ps_state_init(B, is34).items()}
        outs = []
        for r, i in chunks:
            d_r, d_i, st2 = JPS._decorrelate(jnp.asarray(r), jnp.asarray(i),
                                             st, JPS._consts(is34), B, 64,
                                             is34)
            st.update(st2)
            outs.append((np.asarray(d_r), np.asarray(d_i)))
        return outs, {k: np.asarray(v) for k, v in st.items()}
    finally:
        JPS._SEQ_SCAN, JPS._SCAN_MODE = old


def _torch_decorrelate(chunks, is34):
    c = TPS._consts(is34, torch.device("cpu"))
    st = TPS.ps_state_init(B, is34, "cpu")
    outs = []
    for r, i in chunks:
        d_r, d_i, st2 = TPS._decorrelate(_t(r), _t(i), st, c, is34)
        st = dict(st, **st2)
        outs.append((d_r.numpy(), d_i.numpy()))
    return outs, {k: v.numpy() for k, v in st.items()}


@pytest.mark.parametrize("is34", [False, True])
@pytest.mark.parametrize("mode,tol", [("seq", 2e-6), ("matmul", 2e-4),
                                      ("assoc", 2e-4)])
def test_decorrelator_matches_reference_forms(is34, mode, tol):
    """The plain version of the kernel (one step a slot, the reference's
    sequential form) against the reference's `seq` scan within 2e-6, and
    against its default Toeplitz (`matmul`) and doubling (`assoc`) forms
    within their own agreement bound, over two chunks with the state
    carried."""
    chunks = _decorr_inputs(is34, 7)
    (outs_j, st_j), (outs_t, st_t) = (_jax_decorrelate(chunks, is34, mode),
                                      _torch_decorrelate(chunks, is34))
    for k, ((jr, ji), (tr, ti)) in enumerate(zip(outs_j, outs_t)):
        _assert_f32(tr, jr, f"{mode} chunk {k} re", tol)
        _assert_f32(ti, ji, f"{mode} chunk {k} im", tol)
    for k in ("peak", "psmooth", "pdiff", "ap_r", "ap_i", "delay_r",
              "delay_i"):
        _assert_f32(st_t[k], st_j[k], f"{mode} state {k}", tol)


def test_decorrelate_ref_equals_its_loop_in_numpy():
    """decorrelate_ref's steps, written out for one (row, band) in numpy
    float32 scalars as a kernel thread runs them (the kernel's order of
    single roundings), equal the plain version bit for bit."""
    rng = np.random.default_rng(5)
    Bn, Sn, npar, nap = 2, 40, 3, 4
    pw = (rng.random((Bn, Sn, npar)) * 1e4).astype(np.float32)
    pw[:, ::7] = 0.0
    xr, xi = (rng.standard_normal((Bn, Sn, nap)).astype(np.float32) * 50
              for _ in range(2))
    st3 = [(rng.random((Bn, npar)) * 1e3).astype(np.float32) for _ in range(3)]
    ap = [rng.standard_normal((Bn, nap, 3, 5)).astype(np.float32)
          for _ in range(2)]
    c = TPS.consts_np(False)
    qf_r, qf_i, ag = c["qf_r"][:nap], c["qf_i"][:nap], c["ag"][:nap]
    got = ps_decorr.decorrelate_ref(*map(_t, (pw, xr, xi, *st3, *ap, qf_r,
                                              qf_i, ag)))
    f = np.float32
    for b in range(Bn):
        for p in range(npar):
            peak, psm, pdf = (f(s[b, p]) for s in st3)
            for s in range(Sn):
                x = pw[b, s, p]
                peak = max(f(f(ps_decorr.C_PEAK) * peak), x)
                psm = f(psm + f(f(0.25) * f(x - psm)))
                pdf = f(pdf + f(f(0.25) * f(f(peak - x) - pdf)))
                den = f(f(1.5) * pdf)
                g = f(psm / den) if den > psm else f(1.0)
                assert got[0][b, s, p].item() == g
            assert (got[1][b, p].item(), got[2][b, p].item(),
                    got[3][b, p].item()) == (peak, psm, pdf)
        for k in range(nap):
            rr = ap[0][b, k].copy()
            ri = ap[1][b, k].copy()
            for s in range(Sn):
                cr, ci = xr[b, s, k], xi[b, s, k]
                for m in range(3):
                    lr, li = rr[m, 2 - m], ri[m, 2 - m]
                    nr = f(f(f(lr * qf_r[k, m]) - f(li * qf_i[k, m]))
                           - f(ag[k, m] * cr))
                    ni = f(f(f(lr * qf_i[k, m]) + f(li * qf_r[k, m]))
                           - f(ag[k, m] * ci))
                    rr[m] = np.append(rr[m, 1:], f(cr + f(ag[k, m] * nr)))
                    ri[m] = np.append(ri[m, 1:], f(ci + f(ag[k, m] * ni)))
                    cr, ci = nr, ni
                assert (got[4][b, s, k].item(), got[5][b, s, k].item()) == (
                    cr, ci)
            np.testing.assert_array_equal(got[6][b, k].numpy(), rr)
            np.testing.assert_array_equal(got[7][b, k].numpy(), ri)


# -- the mixing matrices ---------------------------------------------------------
def _random_dense(rng, is34):
    npar = TPS._NPAR[is34]
    return dict(
        ps_ha=rng.integers(-1, 46 - 7, (B, T, 6, npar)).astype(np.int32),
        ps_icc=rng.integers(0, 8, (B, T, 6, npar)).astype(np.int32),
        ps_opd=rng.integers(0, 512, (B, T, 6, 17)).astype(np.int32),
        ps_ipd=rng.integers(0, 512, (B, T, 6, 17)).astype(np.int32),
        ps_h0_r=rng.standard_normal((B, T, 34, 4)).astype(np.float32),
        ps_h0_i=rng.standard_normal((B, T, 34, 4)).astype(np.float32),
        ps_hslot=rng.integers(0, 5, (B, T, 6)).astype(np.int8),
        ps_himag=rng.standard_normal((B, 4, 34, 4)).astype(np.float32),
        ps_knot_lo=rng.integers(0, 6, (B, T, 32)).astype(np.int32),
        ps_knot_hi=rng.integers(0, 6, (B, T, 32)).astype(np.int32),
        ps_alpha=rng.random((B, T, 32)).astype(np.float32))


@pytest.mark.parametrize("lut", ["split", "onehot"])
@pytest.mark.parametrize("is34", [False, True])
def test_mixing_gathers_equal_reference_selections(is34, lut):
    """The port's gathers (HA and phase rows, the imaginary tail, the knot
    per slot) select exactly what the reference's one-hot products and
    masked sums select."""
    dense = _random_dense(np.random.default_rng(13 + is34), is34)
    old = JPS._LUT_MODE
    JPS._LUT_MODE = lut
    try:
        want = JPS._mixing_h({k: jnp.asarray(v) for k, v in dense.items()},
                             JPS._consts(is34), B, T, is34)
    finally:
        JPS._LUT_MODE = old
    got = TPS._mixing_h({k: _t(v) for k, v in dense.items()},
                        TPS._consts(is34, torch.device("cpu")), is34)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- ps_apply on packed PS frames ------------------------------------------------
def _ps_data(spec, ctx):
    w = BitWriter()
    write_ps_data(w, spec)
    w.write(0, 7)
    return read_ps_data(BitReader(w.getvalue()), ctx, 0)


def _specs(rng, b, is34):
    """Per-frame PSSpec list for stream b: varied envelopes, IPD/OPD on all
    streams but stream 1 (test_ps_batch's generator)."""
    out = []
    for t in range(T):
        ne = (1, 2, 4, 2)[t % 4]
        if is34:
            kw = dict(iid_mode=2, iid_par=rng.integers(-7, 8, (ne, 34)),
                      icc_mode=2, icc_par=rng.integers(0, 8, (ne, 34)))
            nphase = 17
        else:
            iid_mode = int((b + t) % 2)
            kw = dict(iid_mode=iid_mode,
                      iid_par=rng.integers(-7, 8, (ne, (10, 20)[iid_mode])),
                      icc_mode=0, icc_par=rng.integers(0, 8, (ne, 10)))
            nphase = (5, 11)[iid_mode]
        if b != 1:
            kw["ipd_par"] = rng.integers(0, 8, (ne, nphase))
            kw["opd_par"] = rng.integers(0, 8, (ne, nphase))
        out.append(PSSpec(num_env=ne, **kw))
    return out


def packed_ps_dense(seed, is34, modes=None):
    """The ps_pack planes of B streams x T frames of random PS parameters
    (stream b in band mode modes[b], default all is34), with the himag
    plane and an identity routing (out_src = slot, out_role = 0)."""
    rng = np.random.default_rng(seed)
    modes = modes or [is34] * B
    dense = PP.alloc_ps_dense(B, T)
    states = [PP.PSPackState() for _ in range(B)]
    for b in range(B):
        ctx = PSContext()
        for t, spec in enumerate(_specs(rng, b, modes[b])):
            assert PP.pack_ps_frame(dense, b, t, states[b],
                                    _ps_data(spec, ctx))
    return PP.dense_to_dict(dense, PP.himag_plane(states, B),
                            np.arange(B, dtype=np.int32),
                            np.zeros(B, np.int32))


@pytest.mark.parametrize("is34", [False, True])
def test_ps_apply_matches_reference(is34):
    """One chunk of packed PS frames through ps_apply from a random carried
    state, both outputs and every state entry."""
    rng = np.random.default_rng(21 + is34)
    Xr, Xi, lo_r, lo_i = _planes(rng)
    dense = packed_ps_dense(4, is34)
    state = {k: (rng.standard_normal(v.shape) * 30).astype(np.float32)
             for k, v in TPS.ps_state_init(B, is34, "cpu").items()}
    jout = JPS.ps_apply(*map(jnp.asarray, (Xr, Xi, lo_r, lo_i)),
                        {k: jnp.asarray(v) for k, v in dense.items()},
                        {k: jnp.asarray(v) for k, v in state.items()},
                        B, T, is34)
    tout = TPS.ps_apply(*map(_t, (Xr, Xi, lo_r, lo_i)),
                        {k: _t(v) for k, v in dense.items()},
                        {k: _t(v) for k, v in state.items()}, is34)
    _assert_f32(tout[0].numpy(), jout[0], "pcm_l")
    _assert_f32(tout[1].numpy(), jout[1], "pcm_r")
    assert sorted(tout[2]) == sorted(jout[2])
    for k in jout[2]:
        _assert_f32(tout[2][k].numpy(), jout[2][k], f"state {k}")


# -- sbr_ps_apply and the dual program ------------------------------------------
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native parser not built")
HE_T = 3        # frames a chunk on the runtime routes


def _payloads(stream):
    return [stream[s:e] for _, s, e in adts.split_frames(stream)]


def _config(stream):
    return parse_asc(adts.synthesize_cookie(adts.split_frames(stream)[0][0]))


_SPECS = ps_specs()
PS20, PS34 = _SPECS["20-band"], _SPECS["34-band"]
PS20_2ENV, PS34_2ENV = _SPECS["20-band 2 env"], _SPECS["34-band 2 env"]


@pytest.mark.parametrize("kind", ["ps_stream", "ps_flip_stream"])
def test_stream_builders_equal_reference_tests(kind):
    """The port's PS stream builders write the bytes of the reference
    tests' own (test_ps.make_ps_stream, _make_flip_stream)."""
    if kind == "ps_stream":
        for spec in _SPECS.values():
            assert ps_stream(spec, 3, seed=2) == make_ps_stream(spec, 3, 2)
    else:
        assert ps_flip_stream([0, 2, 1]) == _make_flip_stream([0, 2, 1])


def _jax_cfg(dec):
    """The reference's cfg planes for the slots the port's decoder has
    rendered (its own plane layout, one-hot patch rows)."""
    planes = JB.cfg_planes_zeros(dec.C)
    for s, hdr in enumerate(dec._slot_sbr_hdr):
        if hdr is not None:
            lg = float(JS._consts()["limgain"][hdr.limiter_gains])
            JB.set_cfg_row(planes, s, JB.SBRStaticConfig.from_tables(
                JS.derive_tables(hdr, 44100), lg))
    return {k: jnp.asarray(v) for k, v in planes.items()}


@needs_native
@pytest.mark.parametrize("out_int16", [False, True])
@pytest.mark.parametrize("modes", [(False, False), (True, True),
                                   (False, True)])
def test_sbr_ps_apply_matches_reference(modes, out_int16):
    """One chunk of two PS streams (20-band, 34-band, or one of each
    through the dual program) from the port's host phase: the SBR + PS
    program of both packages on the same core PCM, SBR planes and PS
    planes, its PCM and both states."""
    streams = [ps_stream(PS34_2ENV if m else PS20_2ENV, n_frames=5,
                         seed=3 + i) for i, m in enumerate(modes)]
    config = _config(streams[0])
    dec = BatchDecoder([config] * 2, chunk_frames=4, cce_slots=1,
                       device="cpu")
    parsed, dense, ctx = dec._he_host_phase(
        [_payloads(s)[:4] for s in streams], compact=False)
    core = meshlib.gather(dec._device_step(parsed), dec.device)
    dual = len(ctx["ps_modes"]) == 2
    assert ctx["ps_modes"] == sorted(set(modes))
    ps = dict(ctx["ps_planes"])
    state = TSB.sbr_state_init(dec.C, "cpu")
    cfg = {k: torch.from_numpy(v) for k, v in ctx["cfg"].items()}
    jps = {k: jnp.asarray(v.numpy()) for k, v in ps.items()}
    jargs = (jnp.asarray(core.numpy()),
             {k: jnp.asarray(v.numpy()) for k, v in dense.items()}, jps,
             JB.sbr_state_init(dec.C))
    if dual:
        got = TPS.sbr_ps_apply_dual(
            core, dense, ps, state, TPS.ps_state_init(dec.C, False, "cpu"),
            TPS.ps_state_init(dec.C, True, "cpu"), cfg, out_int16)
        want = JPS.sbr_ps_apply_dual(
            *jargs, JPS.ps_state_init(dec.C, False),
            JPS.ps_state_init(dec.C, True), _jax_cfg(dec), out_int16)
    else:
        got = TPS.sbr_ps_apply(core, dense, ps, state,
                               TPS.ps_state_init(dec.C, modes[0], "cpu"),
                               cfg, out_int16, modes[0])
        want = JPS.sbr_ps_apply(*jargs, JPS.ps_state_init(dec.C, modes[0]),
                                _jax_cfg(dec), out_int16, modes[0])
    if out_int16:
        g, w = got[0].numpy().astype(np.int32), np.asarray(want[0], np.int32)
        d = np.abs(g - w)
        assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(),
                                                        (d > 0).mean())
    else:
        _assert_f32(got[0].numpy(), want[0], "pcm")
    for gs, ws in zip(got[1:], want[1:]):
        assert sorted(gs) == sorted(ws)
        for k in ws:
            _assert_f32(gs[k].numpy(), ws[k], f"state {k}")


# -- the runtime -----------------------------------------------------------------
def _run_both(streams, chunk, use_native=None):
    """Both BatchDecoders (one spare slot a stream) over the streams'
    payloads in chunks of `chunk` frames (step_he_raw), f32 PCM; yields
    (chunk index, port PCM, reference PCM, port decoder, reference
    decoder)."""
    payloads = [_payloads(s) for s in streams]
    configs = [_config(s) for s in streams]
    dec = BatchDecoder(configs, chunk_frames=chunk, cce_slots=1,
                       use_native=use_native, device="cpu")
    jdec = JaxDecoder(configs, chunk_frames=chunk, cce_slots=1,
                      use_native=use_native)
    for k in range(min(len(p) for p in payloads) // chunk):
        group = [p[k * chunk:(k + 1) * chunk] for p in payloads]
        yield k, dec.step_he_raw(group), np.asarray(jdec.step_he_raw(group)), \
            dec, jdec


@pytest.mark.parametrize("route", [
    pytest.param("native", marks=needs_native), "python"])
def test_step_he_raw_ps_matches_reference(route):
    """A 20-band stream with IPD/OPD over two chunks of 3 frames, on the
    native and the python parse routes: stereo in the stream's slot and
    its pair, equal to aacjax's."""
    stream = ps_stream(PS20, n_frames=6, seed=1)
    for k, got, want, dec, _ in _run_both(
            [stream], HE_T, use_native=route == "native"):
        assert dec._ps_pair[0] == 1 and dec._ps_slot_is34[0] is False
        _assert_f32(got, want, f"{route} chunk {k}")
        assert np.abs(got[1]).max() > 0.01      # the right channel


@needs_native
def test_decode_he_pipelined_ps_matches_step_he_raw():
    """The pipelined route of a PS stream equals step_he_raw, chunk by
    chunk, in f32 and int16."""
    stream = ps_stream(PS34, n_frames=6, seed=2)
    payloads, config = _payloads(stream), _config(stream)
    chunks = [[payloads[k:k + HE_T]] for k in (0, HE_T)]
    for out_int16 in (False, True):
        step = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                            device="cpu")
        want = [step.step_he_raw(c, out_int16=out_int16) for c in chunks]
        pipe = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                            device="cpu")
        got = list(pipe.decode_he_pipelined(iter(chunks),
                                            out_int16=out_int16,
                                            compact=True))
        assert len(got) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@needs_native
def test_save_restore_ps_state_round_trip():
    """A checkpoint of a PS batch after one chunk resumes in a fresh
    decoder as the original goes on; its PS state has aacjax's keys, names
    and shapes, and the reference's own checkpoint resumes in the port as
    the reference goes on."""
    import pickle
    stream = ps_stream(PS20, n_frames=6, seed=1)
    payloads, config = _payloads(stream), _config(stream)
    first, second = payloads[:HE_T], payloads[HE_T:2 * HE_T]
    dec = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                       device="cpu")
    dec.step_he_raw([first])
    state = pickle.loads(pickle.dumps(dec.save_state()))
    want = dec.step_he_raw([second])
    other = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                         device="cpu")
    other.restore_state(state)
    np.testing.assert_array_equal(other.step_he_raw([second]), want)

    jdec = JaxDecoder([config], chunk_frames=HE_T, cce_slots=1)
    jdec.step_he_raw([first])
    jstate = jdec.save_state()
    assert sorted(state["sbr"]) == sorted(jstate["sbr"])
    assert state["sbr"]["ps_enabled"] and state["sbr"]["ps_pair"][0] == 1
    for m in (False, True):
        got, ref = state["sbr"]["ps_dev"][m], jstate["sbr"]["ps_dev"][m]
        assert (got is None) == (ref is None)
        if got is not None:
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in ref.items()}
    port = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                        device="cpu")
    port.restore_state(jstate)
    _assert_f32(port.step_he_raw([second]),
                np.asarray(jdec.step_he_raw([second])),
                "after the reference's checkpoint")


@pytest.mark.parametrize("head,tail", [(2, 1), (1, 2), (2, 0), (0, 2)])
def test_flip_readopts_next_chunk_like_reference(head, tail):
    """test_readopt's band-scheme flip: the flipped slot replays its chunk
    on the float64 path (sticky in chunk 2 of frames 4-5 only), then
    re-adopts into the new mode's state set, as in aacjax, with equal
    PCM every chunk."""
    stream = ps_flip_stream([head] * 4 + [tail] * 2)
    sticky = []
    for k, got, want, dec, jdec in _run_both([stream], 2):
        sticky.append(dec._sbr_np_sticky[0])
        assert dec._sbr_np_sticky[0] == jdec._sbr_np_sticky[0]
        _assert_f32(got, want, f"chunk {k}")
    assert sticky == [False, False, True]
    dec._readopt_sticky()
    assert not any(dec._sbr_np_sticky) and dec._ps_np[0] is None
    assert dec._ps_slot_is34[0] == (tail == 2)
    assert dec._ps_row_seeds[tail == 2][0]["peak"].shape == (
        TPS._NPAR[tail == 2],)


def test_mixed_band_modes_one_batch_like_reference():
    """A 20-band and a 34-band stream in one batch run the dual program:
    no slot goes sticky, and the PCM equals aacjax's."""
    streams = [ps_stream(PS20_2ENV, n_frames=4, seed=1),
               ps_stream(PS34_2ENV, n_frames=4, seed=2)]
    for k, got, want, dec, _ in _run_both(streams, 2):
        assert not any(dec._sbr_np_sticky), k
        _assert_f32(got, want, f"chunk {k}")
    assert [dec._ps_slot_is34[s] for s in (0, 2)] == [False, True]
    assert all(dec._ps_dev_states[m] is not None for m in (False, True))


@needs_native
def test_reset_stream_clears_ps_state():
    """reset_stream zeroes the stream's PS rows and pair, and the recycled
    slot decodes the stream again as a fresh decoder does."""
    stream = ps_stream(PS20, n_frames=6, seed=1)
    payloads, config = _payloads(stream), _config(stream)
    dec = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                       device="cpu")
    dec.step_he_raw([payloads[:HE_T]])
    dec.reset_stream(0)
    assert dec._ps_pair == [-1, -1] and dec._ps_slot_is34[0] is None
    for d in dec._ps_dev_states.values():
        assert d is None or all(float(v.abs().max()) == 0 for v in d.values())
    fresh = BatchDecoder([config], chunk_frames=HE_T, cce_slots=1,
                         device="cpu")
    np.testing.assert_array_equal(dec.step_he_raw([payloads[:HE_T]]),
                                  fresh.step_he_raw([payloads[:HE_T]]))


def test_ps_needs_a_spare_slot():
    from aacjax_torch.runtime.pack import SlotOverflowError
    stream = ps_stream(PS20, n_frames=3, seed=1)
    dec = BatchDecoder([_config(stream)], chunk_frames=HE_T, device="cpu")
    with pytest.raises(SlotOverflowError, match="cce_slots"):
        dec.step_he_raw([_payloads(stream)[:HE_T]])


# -- the API ---------------------------------------------------------------------
HAVE_ORACLE = None


def _oracle():
    global HAVE_ORACLE
    if HAVE_ORACLE is None:
        from aacjax_torch.testing import ffmpeg_oracle
        HAVE_ORACLE = ffmpeg_oracle.available()
    return HAVE_ORACLE


@pytest.mark.parametrize("ps", [PS20, PS34], ids=["20-band", "34-band"])
def test_decode_adts_ps_matches_libavcodec(ps):
    """test_ps_batch's two oracle cases: stereo above 70 dB SNR against
    libavcodec on both channels."""
    if not _oracle():
        pytest.skip("libavcodec oracle not built")
    from aacjax_torch.testing import ffmpeg_oracle
    stream = ps_stream(ps)
    pcm, rate = aacjax_torch.decode_adts(stream, chunk_frames=4,
                                         device="cpu")
    want, wrate = ffmpeg_oracle.decode_adts(stream)
    assert rate == wrate == 44100 and pcm.shape[1] == 2
    n = min(len(want), len(pcm))
    for ch in range(2):
        assert _snr(want[4096:n - 64, ch], pcm[4096:n - 64, ch]) > 70.0


def _stream_decode(mod, data, **kw):
    dec = mod.AACDecoder(**kw)
    dec.feed(data)
    out = []
    while (c := dec.read_chunk()) is not None:
        out.append(c.reshape(-1, dec.output_channels))
    return np.concatenate(out), dec.output_sample_rate


@pytest.mark.parametrize("surface", ["decode_adts", "AACDecoder",
                                     "decode_loas"])
def test_surfaces_decode_ps_like_reference(surface):
    """decode_adts (the batched program), the streaming decoder (the
    float64 path) and decode_loas on a 34-band stream with IPD/OPD: stereo
    at 44.1 kHz equal to aacjax's on the same bytes."""
    import aacjax
    from aacjax_torch.testing import encoder as enc
    stream = ps_stream(PS34, n_frames=5, seed=4)
    if surface == "decode_adts":
        got = aacjax_torch.decode_adts(stream, chunk_frames=4, device="cpu")
        want = aacjax.decode_adts(stream, chunk_frames=4)
    elif surface == "AACDecoder":
        got = _stream_decode(aacjax_torch, stream, device="cpu")
        want = _stream_decode(aacjax, stream)
    else:
        loas = enc.loas_stream(_payloads(stream), _config(stream))
        got = aacjax_torch.decode_loas(loas, chunk_frames=4, device="cpu")
        want = aacjax.decode_loas(loas, chunk_frames=4)
    assert got[1] == want[1] == 44100 and got[0].shape[1] == 2
    _assert_f32(got[0], np.asarray(want[0]), surface)
