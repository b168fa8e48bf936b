"""The port's HE-AAC v1 path against aacjax's on the same bytes, on the CPU
(JAX through XLA, the port with device="cpu"):

  * `sbr_batch.sbr_apply` (f32, int16, emit_x, exact and compact planes,
    state carried over chunks) with the test_sbr_batch parameters;
  * `BatchDecoder.step_he_raw` on the native and the python parse routes,
    `decode_he_pipelined` against `step_he_raw`, `request_reset` inside the
    pipeline, `save_state` / `restore_state`;
  * the sticky re-adoption cases of test_readopt without PS (a mid-chunk
    SBR header change; mixed headers in one batch);
  * `decode_adts`, `decode_loas` and the streaming `AACDecoder` on HE
    streams; a stream with ps_data decoding as stereo (the PS path itself is
    held in test_torch_ps.py).

Tolerances: f32 PCM and state within 2e-4 * max(1, max|ref|) (the envelope
gains divide by the patched bands' energies, so reassociated sums can grow
there); int16 within 1 LSB with < 2% of samples differing.  Shapes are few
and small: every new one is a new XLA compile."""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import aacjax
import aacjax_torch
from aacjax.kernels import sbr_batch as JB
from aacjax.runtime.batch import BatchDecoder as JaxDecoder
from aacjax_torch import testing as TI
from aacjax_torch.host import adts, native
from aacjax_torch.host import sbr as S
from aacjax_torch.host import sbr_pack as SP
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.host.bitio import BitReader
from aacjax_torch.host.syntax import decode_frame
from aacjax_torch.kernels import sbr_batch as TB
from aacjax_torch.runtime.batch import BatchDecoder
from test_sbr import _overhang_stream, make_he_stream

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native parser not built")
T = 3          # frames a chunk on the batch routes


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    """Drop the compiled XLA programs when the module is done: a test
    worker keeps every program it compiled, and the HE ones are large."""
    yield
    jax.clear_caches()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (float(np.abs(got - want).max())
            / max(1.0, float(np.abs(want).max())))


def _assert_f32(got, want, what):
    err = _rel(got, want)
    assert err <= 2e-4, f"{what}: max err {err:.3g} * max(1, max|ref|)"


def _assert_i16(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int16, (got.dtype, want.dtype)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d > 0).mean())
    assert d.max() <= 1 and share < 0.02, (
        f"{what}: max delta {d.max()} LSB, {share:.4f} of samples differ")


def _payloads(stream):
    return [stream[s:e] for _, s, e in adts.split_frames(stream)]


def _config(stream):
    return parse_asc(adts.synthesize_cookie(adts.split_frames(stream)[0][0]))


# -- sbr_apply ---------------------------------------------------------------
def _sbr_inputs(stream, ch):
    """Core PCM [ch, n, 1024] (the port's python route on the CPU) and the
    parsed SBR frames of an HE stream."""
    config = _config(stream)
    ctx = S.SBRContext(sample_rate=2 * config.sample_rate)
    dec = BatchDecoder([config], chunk_frames=8, use_native=False,
                       device="cpu")
    prev = dec.streams[0].prev_shapes
    frames = []
    for p in _payloads(stream):
        f = decode_frame(BitReader(p), config, prev, sbr_ctx=ctx)
        dec._update_shapes(dec.streams[0], f)
        frames.append(f)
    core = dec.step([frames])[:ch, :len(frames)]
    return core, frames


def _run_sbr(stream, ch, chunk, out_int16=False, compact=False,
             emit_x=False):
    """Both sbr_apply over the stream's frames in chunks of `chunk`, fed
    the same core PCM and packed planes; yields (chunk start, reference
    outputs, port outputs)."""
    core, frames = _sbr_inputs(stream, ch)
    sf0 = frames[0].elements[0].sbr
    lg = S._consts()["limgain"][sf0.header.limiter_gains]
    jcfg = {k: jnp.asarray(v) for k, v in JB.broadcast_cfg(
        JB.SBRStaticConfig.from_tables(sf0.tables, lg), ch).items()}
    tcfg = {k: torch.from_numpy(v) for k, v in TB.broadcast_cfg(
        TB.SBRStaticConfig.from_tables(sf0.tables, lg), ch).items()}
    hosts = [SP.SBRHostState() for _ in range(ch)]
    jst, tst = JB.sbr_state_init(ch), TB.sbr_state_init(ch, "cpu")
    jfn = (jax_emit_x if emit_x else JB.jitted_sbr_apply(out_int16))
    for lo in range(0, len(frames), chunk):
        n = min(chunk, len(frames) - lo)
        dense = SP.alloc_dense(ch, n)
        for t in range(n):
            sf = frames[lo + t].elements[0].sbr
            eq = S.dequant(sf)
            for c in range(ch):
                SP.pack_channel_frame(dense, c, t, hosts[c], sf, c, eq[c])
        planes = SP.compact_dense(dense) if compact else vars(dense)
        pcm = np.ascontiguousarray(core[:, lo:lo + n], np.float32)
        jout = jfn(jnp.asarray(pcm),
                   {k: jnp.asarray(v) for k, v in planes.items()}, jst, jcfg)
        tout = TB.sbr_apply(torch.from_numpy(pcm),
                            {k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in planes.items()}, tst, tcfg,
                            out_int16=out_int16, emit_x=emit_x)
        jst = dict(jst, **jout[-1])
        tst = dict(tst, **tout[-1])
        yield lo, jout, tout


jax_emit_x = jax.jit(functools.partial(JB.sbr_apply, emit_x=True))


@pytest.mark.parametrize("kw", [
    dict(invf=0), dict(invf=1), dict(num_env=4, noise_q=18),
    dict(freq_res=0),
])
def test_sbr_apply_matches_reference(kw):
    """The test_sbr_batch parameters, mono, one chunk of 6 frames."""
    for _, (jpcm, jst), (tpcm, tst) in _run_sbr(
            make_he_stream(n_frames=5, **kw), 1, 6):
        _assert_f32(tpcm.numpy(), jpcm, f"sbr_apply {kw}")
        for k in jst:
            _assert_f32(tst[k].numpy(), jst[k], f"sbr_apply {kw} state {k}")


@pytest.mark.parametrize("mode", ["f32", "int16", "compact", "emit_x"])
def test_sbr_apply_stereo_chunked_state(mode):
    """Stereo, two chunks of 3 frames with the state carried: f32 and int16
    PCM, the compact planes (sbr_pack.compact_dense, expanded on the
    device), and emit_x (the X planes and low-band lines before
    synthesis)."""
    stream = make_he_stream(ch=2, n_frames=5, invf=1)
    for lo, jout, tout in _run_sbr(stream, 2, T, out_int16=mode == "int16",
                                   compact=mode == "compact",
                                   emit_x=mode == "emit_x"):
        what = f"sbr_apply {mode} chunk at {lo}"
        if mode == "int16":
            _assert_i16(tout[0].numpy(), np.asarray(jout[0]), what)
        else:
            for i, (g, w) in enumerate(zip(tout[:-1], jout[:-1])):
                _assert_f32(g.numpy(), w, f"{what} output {i}")
        jst, tst = jout[-1], tout[-1]
        assert sorted(jst) == sorted(tst)
        for k in jst:
            _assert_f32(tst[k].numpy(), jst[k], f"{what} state {k}")


def test_sbr_apply_gathers_equal_reference_selections():
    """The port's patch gather by src_band equals the reference's one-hot
    psel product, and its cfg planes share the reference's other rows."""
    cfg_t = S.derive_tables(S.SBRHeader(amp_res=1, start_freq=6, stop_freq=4,
                                        xover_band=0), 44100)
    jrow = JB.SBRStaticConfig.from_tables(cfg_t, 1.0).plane_row()
    trow = TB.SBRStaticConfig.from_tables(cfg_t, 1.0).plane_row()
    for k in trow:
        if k != "src_band":
            np.testing.assert_array_equal(trow[k], jrow[k], err_msg=k)
    x = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    want = x @ jrow["psel"]
    got = x[:, trow["src_band"]] * trow["patched"]
    np.testing.assert_array_equal(got, want)


# -- the runtime -------------------------------------------------------------
@pytest.fixture(scope="module")
def stereo_stream():
    return make_he_stream(ch=2, n_frames=5, invf=1, num_env=2)


def _chunks(payloads, n=T):
    return [payloads[i:i + n] for i in range(0, len(payloads), n)]


@pytest.mark.parametrize("route", [
    pytest.param("native-exact", marks=needs_native),
    pytest.param("native-compact", marks=needs_native),
    "python"])
def test_step_he_raw_matches_reference(stereo_stream, route):
    """Two chunks of 3 frames through step_he_raw on the native route (exact
    f32 spectra and planes, or the q/sf spectra and compact planes) and the
    python route, against aacjax's step_he_raw on the same route."""
    native_route = route != "python"
    compact = route == "native-compact"
    payloads = _payloads(stereo_stream)
    config = _config(stereo_stream)
    jdec = JaxDecoder([config], chunk_frames=T, use_native=native_route)
    tdec = BatchDecoder([config], chunk_frames=T, use_native=native_route,
                        device="cpu")
    if compact:
        parsed = tdec._parse_native([payloads[:T]], qsf=True)
        assert parsed["_spec_qsf"] and not parsed["_spec_i16"]
        tdec = BatchDecoder([config], chunk_frames=T, device="cpu")
    for k, chunk in enumerate(_chunks(payloads)):
        want = jdec.step_he_raw([chunk], compact=compact)
        got = tdec.step_he_raw([chunk], compact=compact)
        _assert_f32(got, want, f"{route} chunk {k}")
    assert not any(tdec._sbr_np_sticky)


@needs_native
def test_decode_he_pipelined_matches_step_he_raw(stereo_stream):
    payloads = _payloads(stereo_stream)
    config = _config(stereo_stream)
    ref = BatchDecoder([config], chunk_frames=T, device="cpu")
    want = [ref.step_he_raw([c], out_int16=True) for c in _chunks(payloads)]
    dec = BatchDecoder([config], chunk_frames=T, device="cpu")
    got = list(dec.decode_he_pipelined(([c] for c in _chunks(payloads)),
                                       out_int16=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)


@needs_native
def test_request_reset_mid_he_pipeline():
    """A slot recycled while decode_he_pipelined has chunks in flight: the
    neighbour's PCM is bit-identical to an undisturbed run, and the
    newcomer decodes like a fresh decoder."""
    a = make_he_stream(ch=2, n_frames=11, invf=1)
    b = make_he_stream(ch=2, n_frames=11, invf=1, num_env=2)
    c = make_he_stream(ch=2, n_frames=5, invf=1, num_env=4)
    config = _config(a)
    pa, pb, pc = _payloads(a), _payloads(b), _payloads(c)

    ref = BatchDecoder([config, config], chunk_frames=T, device="cpu")
    want_b = [x[2:4] for x in ref.decode_he_pipelined(
        iter([[pa[i * T:(i + 1) * T], pb[i * T:(i + 1) * T]]
              for i in range(4)]))]
    fresh = BatchDecoder([config], chunk_frames=T, device="cpu")
    want_c = list(fresh.decode_he_pipelined(
        iter([[pc[i * T:(i + 1) * T]] for i in range(2)])))

    dec = BatchDecoder([config, config], chunk_frames=T, device="cpu")

    def source():
        for i in range(4):
            if i == 2:
                dec.request_reset(0)
            src0 = pa[i * T:(i + 1) * T] if i < 2 else \
                pc[(i - 2) * T:(i - 1) * T]
            yield [src0, pb[i * T:(i + 1) * T]]

    got = list(dec.decode_he_pipelined(source()))
    assert len(got) == 4
    for i in range(4):
        np.testing.assert_array_equal(got[i][2:4], want_b[i])
    for i in (0, 1):
        np.testing.assert_array_equal(got[2 + i][0:2], want_c[i][0:2])


def _header_change_stream(flip_at=4, n_frames=8):
    h1 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    h2 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0,
                     limiter_gains=1)
    return TI.he_stream(n_frames, ch=1, seed=5, header=h1,
                        header_at={flip_at: h2}), h2


@pytest.mark.parametrize("chunk,sticky_chunk", [(2, None), (3, 1)])
def test_header_change_readopts_like_reference(chunk, sticky_chunk):
    """An SBR header change on a chunk boundary re-renders the slot's row
    and never leaves the batched path; mid-chunk it replays that chunk on
    the float64 path and re-adopts at the next boundary, as aacjax's does.
    The PCM follows the reference's throughout."""
    stream, h2 = _header_change_stream()
    payloads = _payloads(stream)
    config = _config(stream)
    jdec = JaxDecoder([config], chunk_frames=chunk)
    tdec = BatchDecoder([config], chunk_frames=chunk, device="cpu")
    for k, c in enumerate(_chunks(payloads, chunk)):
        want = jdec.step_he_raw([c], compact=False)
        got = tdec.step_he_raw([c], compact=False)
        assert tdec._sbr_np_sticky == jdec._sbr_np_sticky, k
        assert any(tdec._sbr_np_sticky) == (k == sticky_chunk), k
        _assert_f32(got, want, f"header change, chunk {k}")
    assert all(p is None for p in tdec._sbr_np_procs)
    assert tdec._slot_sbr_hdr[0] == h2


@needs_native
def test_mixed_headers_one_batch_like_reference():
    """Streams carrying different SBR headers decode in one batch on the
    batched path (per-slot cfg rows), as aacjax's do."""
    h1 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    h2 = S.SBRHeader(amp_res=1, start_freq=6, stop_freq=4, xover_band=0,
                     limiter_gains=1)
    streams = [make_he_stream(ch=2, header=h, n_frames=5, seed=s)
               for h, s in ((h1, 1), (h2, 2))]
    per = [_payloads(s) for s in streams]
    config = _config(streams[0])
    jdec = JaxDecoder([config] * 2, chunk_frames=T)
    tdec = BatchDecoder([config] * 2, chunk_frames=T, device="cpu")
    for lo in range(0, 6, T):
        group = [p[lo:lo + T] for p in per]
        want = jdec.step_he_raw(group, compact=False)
        got = tdec.step_he_raw(group, compact=False)
        assert not any(tdec._sbr_np_sticky)
        _assert_f32(got, want, f"mixed headers, chunk at {lo}")
    assert set(tdec._slot_sbr_hdr) == {h1, h2}


@needs_native
def test_save_restore_state_round_trip(stereo_stream):
    """A checkpoint after one chunk resumes in a fresh decoder exactly as
    the original goes on; its SBR device state has aacjax's names and
    shapes, and the PS fields their empty values."""
    import pickle
    payloads = _payloads(stereo_stream)
    config = _config(stereo_stream)
    first, second = _chunks(payloads)
    dec = BatchDecoder([config], chunk_frames=T, device="cpu")
    dec.step_he_raw([first])
    state = pickle.loads(pickle.dumps(dec.save_state()))
    want = dec.step_he_raw([second])
    other = BatchDecoder([config], chunk_frames=T, device="cpu")
    other.restore_state(state)
    np.testing.assert_array_equal(other.step_he_raw([second]), want)

    jdec = JaxDecoder([config], chunk_frames=T)
    jdec.step_he_raw([first])
    jstate = jdec.save_state()
    assert sorted(state["sbr"]) == sorted(jstate["sbr"])
    assert {k: v.shape for k, v in state["sbr"]["dev"].items()} == \
        {k: v.shape for k, v in jstate["sbr"]["dev"].items()}
    assert state["sbr"]["ps_enabled"] is False
    assert state["sbr"]["ps_pair"] == [-1] * dec.C


# -- the API -----------------------------------------------------------------
def _multi_rdb_he():
    stream = make_he_stream(ch=2, n_frames=5)
    config = _config(stream)
    from aacjax_torch.testing import encoder as enc
    p = _payloads(stream)
    return b"".join(enc.adts_frame_multi(p[i:i + 2], config)
                    for i in range(0, len(p), 2))


@pytest.mark.parametrize("name", ["stereo", "overhang", "tns",
                                  "multi-raw_data_block"])
def test_decode_adts_he_matches_reference(name):
    stream = {"stereo": lambda: make_he_stream(ch=2, n_frames=5),
              "overhang": _overhang_stream,
              "tns": lambda: TI.he_stream(6, ch=2, tns=True),
              "multi-raw_data_block": _multi_rdb_he}[name]()
    if name == "tns" and native.available():
        dec = BatchDecoder([_config(stream)], chunk_frames=8, device="cpu")
        assert dec._parse_native([_payloads(stream)], compact=False)[
            "_has_tns"]
    want, wrate = aacjax.decode_adts(stream, chunk_frames=4)
    got, rate = aacjax_torch.decode_adts(stream, chunk_frames=4, device="cpu")
    assert rate == wrate == 44100
    _assert_f32(got, want, f"decode_adts {name}")


def _stream_decode(mod, data, **kw):
    dec = mod.AACDecoder(**kw)
    dec.feed(data)
    out = []
    while (c := dec.read_chunk()) is not None:
        out.append(c.reshape(-1, dec.output_channels))
    return np.concatenate(out), dec.output_sample_rate


@pytest.mark.parametrize("signalling", ["implicit", "explicit"])
def test_aacdecoder_he_matches_reference(signalling):
    """The streaming decoder: SBR found on the first frame, or signalled in
    the ASC given as the cookie."""
    stream = make_he_stream(ch=1, n_frames=5)
    kw = {}
    if signalling == "explicit":
        kw = dict(cookie=make_asc(2, 7, 1, sbr=True))
        stream = b"".join(_payloads(stream))
    want, wrate = _stream_decode(aacjax, stream, **kw)
    got, rate = _stream_decode(aacjax_torch, stream, device="cpu", **kw)
    assert rate == wrate == 44100
    _assert_f32(got, want, f"AACDecoder {signalling}")


@pytest.mark.parametrize("signalling", ["implicit", "explicit"])
def test_decode_loas_he_matches_reference(signalling):
    """LOAS: implicit signalling re-frames onto decode_adts' HE route,
    explicit signalling (SBR in the ASC) decodes on the streaming
    decoder."""
    from aacjax_torch.testing import encoder as enc
    stream = make_he_stream(ch=2, n_frames=5)
    config = parse_asc(make_asc(2, 7, 2, sbr=signalling == "explicit"))
    loas = enc.loas_stream(_payloads(stream), config)
    want, wrate = aacjax.decode_loas(loas, chunk_frames=4)
    got, rate = aacjax_torch.decode_loas(loas, chunk_frames=4, device="cpu")
    assert rate == wrate == 44100
    _assert_f32(got, want, f"decode_loas {signalling}")


@pytest.mark.parametrize("surface", ["decode_adts", "AACDecoder",
                                     pytest.param("step_he_raw",
                                                  marks=needs_native)])
def test_ps_data_raises_not_implemented(surface):
    """HE-AAC v2 (ROADMAP Queue 1 item 9, once refused here): a mono stream
    with ps_data decodes as stereo, equal to aacjax, on each surface."""
    stream = TI.he_ps_stream()
    if surface == "decode_adts":
        got = aacjax_torch.decode_adts(stream, chunk_frames=T, device="cpu")
        want = aacjax.decode_adts(stream, chunk_frames=T)
    elif surface == "AACDecoder":
        got = _stream_decode(aacjax_torch, stream, device="cpu")
        want = _stream_decode(aacjax, stream)
    else:
        group = [_payloads(stream)[:T]]
        dec = BatchDecoder([_config(stream)], chunk_frames=T, cce_slots=1,
                           device="cpu")
        got = (dec.step_he_raw(group)[:2], 44100)
        jdec = JaxDecoder([_config(stream)], chunk_frames=T, cce_slots=1)
        want = (np.asarray(jdec.step_he_raw(group))[:2], 44100)
    assert got[1] == want[1] == 44100
    assert got[0].shape == np.shape(want[0]) and 2 in got[0].shape
    _assert_f32(got[0], want[0], f"ps {surface}")
