"""The port's compiled programs (`jitted_*`, runtime/graphs.py) on the CPU.

On CPU tensors a compiled program runs its eager function, so each
`jitted_*` of the port is held here to the reference's `jitted_*` (JAX on
the CPU, its Pallas kernels in interpret mode) over three chunks whose
state each package carries from chunk to chunk, on the same numpy inputs:
the decode steps (f32 PCM within 5e-5 * max(1, max|ref|), int16 within 1
LSB on < 2% of samples, the overlap within 3e-3 on the random chunks and
within the PCM rule on the packed frames, the predictor state bit for
bit), the SBR and SBR + PS programs (2e-4 * max(1, max|ref|), their int16
PCM in sample units too), the encoder's analysis (tests/test_torch_encode_batch.py's bounds)
and quantize (q and sf equal, fed the reference's analysis outputs).  The
key is held to what the reference's jit separates, plus shape, dtype,
strides and the indexed device.  The card's side (graph against eager,
replay after replay) is in tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from aacjax import encode_batch as JE
from aacjax.host import sbr as JS
from aacjax.kernels import pipeline as JP
from aacjax.kernels import ps_batch as JPS
from aacjax.kernels import sbr_batch as JB
from aacjax_torch import encode_batch as EB
from aacjax_torch import testing as TI
from aacjax_torch.host import adts
from aacjax_torch.host.asc import parse_asc
from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import pred
from aacjax_torch.kernels import ps_batch as PB
from aacjax_torch.kernels import sbr_batch as SB
from aacjax_torch.runtime import graphs
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.runtime.batch import BatchDecoder

CPU = torch.device("cpu")
HE_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    """Drop the compiled XLA programs when the module is done."""
    yield
    jax.clear_caches()


def _t(batch: dict) -> dict:
    return {k: meshlib.packed_tensor(k, v, CPU) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _he_close(got, want, what, tol=HE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# -- the key --------------------------------------------------------------------
def test_key_separates_what_the_reference_jit_separates():
    """Static arguments (flags, out_int16, the PS band mode, the encoder's
    configuration, w8), the program, and each tensor's shape, dtype and
    strides, non-tensor values and the device all give keys of their
    own; the same call gives the same key."""
    x = torch.zeros(4, 8)

    def key(prog, *args):
        return prog.key(args)[0]

    flags = P.PipelineFlags(use_pallas=True)
    step = P.jitted_decode_step(flags)
    assert key(step, x) == key(step, torch.ones(4, 8))
    keys = [key(step, x), key(P.jitted_decode_step(
        dataclasses.replace(flags, has_tns=True)), x),
        key(P.jitted_decode_spec_step(flags), x),
        key(step, torch.zeros(4, 9)), key(step, torch.zeros(4, 8).double()),
        key(step, torch.zeros(8, 4).t()), key(step, x, None),
        key(step, {"a": x}), key(step, {"b": x}), key(step, x, 1),
        key(step, x, 2), key(step, torch.zeros(4, 8, device="meta"))]
    keys += [key(SB.jitted_sbr_apply(i16), x) for i16 in (False, True)]
    keys += [key(PB.jitted_sbr_ps_apply(i16, is34), x)
             for i16 in (False, True) for is34 in (False, True)]
    keys += [key(PB.jitted_sbr_ps_apply_dual(i16), x)
             for i16 in (False, True)]
    cfg = (4, 400, 1024, 16, (6.0, 15.0, 30.0))
    for i in range(len(cfg)):
        alt = list(cfg)
        alt[i] = (7.0, 15.0, 30.0) if i == 4 else cfg[i] + 1
        keys.append(key(EB._jitted_analysis(*alt), x))
    keys.append(key(EB._jitted_analysis(*cfg), x))
    keys += [key(EB._jitted_quantize(w8), x) for w8 in (64, 128)]
    assert len(set(keys)) == len(keys)
    assert key(step, x)[3] == _build.indexed(CPU)


def test_key_device_is_indexed(monkeypatch):
    """A bare "cuda" keys as cuda:<current device>, so one program on two
    cards never shares a graph, and a later set_device cannot alias one."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _build.indexed(torch.device("cuda")) == torch.device("cuda", 1)
    assert _build.indexed(torch.device("cuda", 0)) == torch.device("cuda", 0)


def test_cuda_without_cuda_raises():
    """Asking the graph layer for a CUDA device where there is none raises;
    so does a decoder or an encoder asked for one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graphs.clear("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchDecoder([TI.lc_stereo_config()], chunk_frames=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EB.BatchEncoder(44100, 2, 128_000, 1)


def test_cpu_program_is_the_eager_function():
    """On CPU tensors a program calls its eager function and keeps no
    graph."""
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, {"twice": 2 * a}
    prog = graphs.Program("cpu_eager", fn)
    out = prog(torch.ones(3), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    assert torch.equal(out[1]["twice"], torch.full((3,), 2.0))
    prog(torch.ones(3), torch.ones(3))
    assert len(calls) == 2
    assert "cpu_eager" not in [e["name"] for e in graphs.entries()]


# -- the decode steps ------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tail_i16", "pred_tns"])
def test_jitted_decode_spec_step_matches_reference(kind):
    """Three native-format chunks (C = 8, T = 4) through both packages'
    jitted_decode_spec_step, the overlap (and the predictor state) carried:
    the compact int16 spectra through the fused tail to int16 PCM, or f32
    spectra through the predictor, TNS and synthesis to f32 PCM."""
    C, T = 8, 4
    pred_tns = kind == "pred_tns"
    flags = P.PipelineFlags(has_stereo=False, use_pallas=True,
                            out_int16=not pred_tns, spec_i16=not pred_tns,
                            has_tns=pred_tns, has_pred=pred_tns)
    # the reference's synthesis kernel has no interpret mode on the CPU:
    # where the predictor keeps a chunk off the tail, its route there is
    # XLA's (the port's CPU wrappers run their plain versions either way)
    jfn = JP.jitted_decode_spec_step(JP.PipelineFlags(**dict(
        dataclasses.asdict(flags), use_pallas=not pred_tns)))
    tfn = P.jitted_decode_spec_step(flags)
    ov = (np.random.default_rng(4).standard_normal((C, 1024)) * 100).astype(
        np.float32)
    jst = [jnp.asarray(ov)] + ([JP.pred_state_init(C)] if pred_tns else [])
    tst = [torch.from_numpy(ov)] + ([pred.pred_state_init(C, CPU)]
                                    if pred_tns else [])
    for k in range(3):
        b = TI.spec_step_chunk(k, C, T, i16=not pred_tns, tns=pred_tns,
                               pred=pred_tns)
        want = jfn(_j(b), *jst)
        got = tfn(_t(b), *tst)
        TI.assert_pcm_close(got[0].numpy(), np.asarray(want[0]),
                            flags.out_int16, f"chunk {k} pcm")
        assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 3e-3
        if pred_tns:
            np.testing.assert_array_equal(
                got[2].numpy().view(np.uint32),
                np.asarray(want[2]).view(np.uint32))
        jst, tst = list(want[1:]), list(got[1:])


def test_jitted_decode_step_matches_reference():
    """Three chunks of two Main-profile stereo streams (prediction, M/S,
    short windows, TNS), python-parsed and packed, through both packages'
    jitted_decode_step, the overlap and the predictor state carried."""
    chunks, C = TI.packed_step_chunks(2, 4, 3, seed=2)
    flags = dataclasses.replace(chunks[0][1], use_pallas=True)
    assert all(f == chunks[0][1] for _, f in chunks)
    jfn = JP.jitted_decode_step(JP.PipelineFlags(**dataclasses.asdict(flags)))
    tfn = P.jitted_decode_step(flags)
    jst = [jnp.zeros((C, 1024), jnp.float32), JP.pred_state_init(C)]
    tst = [torch.zeros((C, 1024)), pred.pred_state_init(C, CPU)]
    for k, (b, _) in enumerate(chunks):
        want = jfn(_j(b), *jst)
        got = tfn(_t(b), *tst)
        TI.assert_pcm_close(got[0].numpy(), np.asarray(want[0]), False,
                            f"chunk {k} pcm")
        TI.assert_pcm_close(got[1].numpy() / 32768.0,
                            np.asarray(want[1]) / 32768.0, False,
                            f"chunk {k} overlap")
        np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                      np.asarray(want[2]).view(np.uint32))
        jst, tst = list(want[1:]), list(got[1:])


# -- the SBR and SBR + PS programs ----------------------------------------------
def _he_chunks(streams, T, ps):
    """Three chunks of `streams` through the port's host phase and core
    step on the CPU: per chunk (core, exact SBR planes, PS planes or None,
    the port's cfg planes, the reference's cfg planes, the PS modes)."""
    payloads = [[x[a:b] for _, a, b in adts.split_frames(x)]
                for x in streams]
    config = parse_asc(adts.synthesize_cookie(
        adts.split_frames(streams[0])[0][0]))
    dec = BatchDecoder([config] * len(streams), chunk_frames=T,
                       cce_slots=int(ps), device="cpu")
    out = []
    for k in range(3):
        parsed, dense, ctx = dec._he_host_phase(
            [p[k * T:(k + 1) * T] for p in payloads], compact=False)
        core = meshlib.gather(dec._device_step(parsed), CPU)
        jcfg = JB.cfg_planes_zeros(dec.C)
        for s, hdr in enumerate(dec._slot_sbr_hdr):
            if hdr is not None:
                lg = float(JS._consts()["limgain"][hdr.limiter_gains])
                JB.set_cfg_row(jcfg, s, JB.SBRStaticConfig.from_tables(
                    JS.derive_tables(hdr, 2 * config.sample_rate), lg))
        out.append((core, {k: v.clone() for k, v in dense.items()},
                    dict(ctx["ps_planes"]) if ps else None,
                    {k: torch.from_numpy(v.copy())
                     for k, v in ctx["cfg"].items()}, _j(jcfg),
                    ctx.get("ps_modes")))
    return out, dec.C


def _check_he(got, want, what):
    """PCM (f32, or int16 in sample units) and every state array within
    2e-4 * max(1, max|ref|): the HE programs' bound, as the SBR math
    amplifies a last-bit difference of the carried state (see
    tests/test_torch_he_bound.py), here to 2 LSB of int16 on some
    samples."""
    assert got[0].dtype == {np.dtype(np.int16): torch.int16,
                            np.dtype(np.float32): torch.float32}[
        np.asarray(want[0]).dtype], what
    _he_close(got[0].numpy(), want[0], what)
    for gs, ws in zip(got[1:], want[1:]):
        assert sorted(gs) == sorted(ws), what
        for k in ws:
            _he_close(gs[k].numpy(), ws[k], f"{what} state {k}")


@pytest.mark.parametrize("out_int16", [False, True])
def test_jitted_sbr_apply_matches_reference(out_int16):
    """Three chunks of 4 frames of two HE-AAC v1 streams (one carries TNS
    in its core) through both packages' jitted_sbr_apply, the SBR state
    carried."""
    T = 4
    chunks, C = _he_chunks([TI.he_stream(12, ch=2, seed=1),
                            TI.he_stream(12, ch=2, seed=3, tns=True)], T,
                           ps=False)
    jfn, tfn = JB.jitted_sbr_apply(out_int16), SB.jitted_sbr_apply(out_int16)
    jst, tst = JB.sbr_state_init(C), SB.sbr_state_init(C, CPU)
    for k, (core, dense, _, cfg, jcfg, _) in enumerate(chunks):
        want = jfn(jnp.asarray(core.numpy()), _j(
            {n: v.numpy() for n, v in dense.items()}), jst, jcfg)
        got = tfn(core, dense, tst, cfg)
        _check_he(got, want, f"chunk {k}")
        jst, tst = want[1], got[1]


@pytest.mark.parametrize("modes", [(False, False), (True, True),
                                   (False, True)])
def test_jitted_sbr_ps_apply_matches_reference(modes):
    """Three chunks of 4 frames of two HE-AAC v2 streams (20-band, 34-band,
    or one of each through the dual program) through both packages'
    jitted SBR + PS programs, int16 PCM, the SBR and PS states carried."""
    specs = TI.ps_specs()
    T = 4
    chunks, C = _he_chunks(
        [TI.ps_stream(specs["34-band 2 env" if m else "20-band 2 env"],
                      n_frames=12, seed=3 + i) for i, m in enumerate(modes)],
        T, ps=True)
    dual = modes[0] != modes[1]
    if dual:
        jfn = JPS.jitted_sbr_ps_apply_dual(True)
        tfn = PB.jitted_sbr_ps_apply_dual(True)
        jps = [JPS.ps_state_init(C, False), JPS.ps_state_init(C, True)]
        tps = [PB.ps_state_init(C, False, CPU), PB.ps_state_init(C, True, CPU)]
    else:
        jfn = JPS.jitted_sbr_ps_apply(True, modes[0])
        tfn = PB.jitted_sbr_ps_apply(True, modes[0])
        jps, tps = [JPS.ps_state_init(C, modes[0])], [
            PB.ps_state_init(C, modes[0], CPU)]
    jst, tst = JB.sbr_state_init(C), SB.sbr_state_init(C, CPU)
    for k, (core, dense, ps, cfg, jcfg, ps_modes) in enumerate(chunks):
        assert ps_modes == sorted(set(modes)), (k, ps_modes)
        want = jfn(jnp.asarray(core.numpy()),
                   _j({n: v.numpy() for n, v in dense.items()}),
                   _j({n: v.numpy() for n, v in ps.items()}), jst, *jps,
                   jcfg)
        got = tfn(core, dense, ps, tst, *tps, cfg)
        _check_he(got, want, f"chunk {k}")
        jst, tst = want[1], got[1]
        jps, tps = list(want[2:]), list(got[2:])


# -- the encoder's programs ------------------------------------------------------
def test_jitted_encoder_programs_match_reference():
    """Three chunks of 6 frames of 2 stereo streams of the encoder's serving
    traffic through both packages' compiled analysis (coefs within 1e-5 of
    their peak, bin_band equal, base and fit_sf equal on >= 99.9% of bands
    and within one step, est within 1% of a row's largest), then both
    quantize programs fed the reference's analysis outputs at the port's
    chosen offsets: q and sf equal."""
    enc, chunks = TI.encoder_program_chunks(2, 6, 3)
    nF = 6
    psy = enc._psy_key()
    jfn = JE._jitted_analysis(enc._si, enc._cutoff_bin, JE.FRAME, nF, psy)
    tfn = EB._jitted_analysis(enc._si, enc._cutoff_bin, EB.FRAME, nF, psy)
    jq = JE._jitted_quantize(enc._w8, enc._si, enc._cutoff_bin)
    tq = EB._jitted_quantize(enc._w8)
    for k, (pcm_i16, w_idx, is_short) in enumerate(chunks):
        want = [np.asarray(a) for a in jfn(pcm_i16, w_idx, is_short)]
        got = [a.numpy() for a in tfn(*(torch.from_numpy(a) for a in (
            pcm_i16, w_idx, is_short)))]
        c_t, b_t, f_t, e_t, bb_t = got
        c_j, b_j, f_j, e_j, bb_j = want
        np.testing.assert_array_equal(bb_t, bb_j)
        assert np.abs(c_t - c_j).max() <= 1e-5 * float(np.abs(c_j).max())
        for name, g, w in (("base", b_t, b_j), ("fit_sf", f_t, f_j)):
            d = np.abs(g - w)
            assert (d != 0).mean() <= 1e-3 and d.max() <= 1.0, (k, name)
        row = np.maximum(np.abs(e_j).max(axis=1, keepdims=True), 1.0)
        assert (np.abs(e_t - e_j) / row).max() <= 0.01, k
        off, _ = enc._rate_choice(e_j, nF)
        short = is_short.reshape(-1)
        q_j, sf_j = (np.asarray(a) for a in jq(c_j, b_j, f_j, bb_j, off,
                                                short))
        q_t, sf_t = (a.numpy() for a in tq(
            *(torch.from_numpy(a.copy()) for a in (c_j, b_j, f_j)),
            torch.from_numpy(bb_j.astype(np.int64)), torch.from_numpy(off),
            torch.from_numpy(short)))
        np.testing.assert_array_equal(q_t, q_j)
        np.testing.assert_array_equal(sf_t, sf_j)
