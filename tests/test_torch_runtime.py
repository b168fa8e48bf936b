"""The port's runtime and API on CPU against the JAX package: the
pipelined batch decoder on real native-parsed chunks, decode_adts on a
stream with short windows and TNS, Main-profile, coupled, multichannel,
960-sample, LD / ELD and LTP batches, the python-packer route and the
chunks the native route delegates to it, stream resets, the state hand-over
between the two packages, and the routes the port does not take yet.

Tolerances (tests/test_pallas_tail.py): int16 PCM within 1 LSB with fewer
than 2% of samples differing; f32 PCM within 5e-5 * max(1, max|ref|).  The
predictor state and the LTP route (the same numpy code in both packages)
are held bit for bit.
"""
import numpy as np
import pytest
import torch

import aacjax
from aacjax.host import native
from aacjax.runtime.batch import BatchDecoder as JaxBatchDecoder
from aacjax.testing.streams import make_lc_payload_chunks
import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.testing import (adts_payloads, assert_pcm_close,
                                  encode_adts, tns_serving_corpus,
                                  tns_short_adts, tone_pcm)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")


@pytest.mark.parametrize("compact,out_int16", [(True, True), (False, False)])
def test_decode_pipelined_matches_reference(compact, out_int16):
    configs, chunks = make_lc_payload_chunks(n_streams=4, chunk_frames=8,
                                             n_chunks=3)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    want = list(ref.decode_pipelined(iter(chunks), out_int16=out_int16,
                                      compact=compact))
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    got = list(dec.decode_pipelined(iter(chunks), out_int16=out_int16,
                                    compact=compact))
    assert len(got) == len(want) == 3
    for k, (g, w) in enumerate(zip(got, want)):
        assert_pcm_close(g, w, out_int16, f"chunk {k}")
    assert dec.stats.steps == 3
    assert dec.stats.stream_frames == ref.stats.stream_frames
    np.testing.assert_array_equal(dec.prev_shapes, ref.prev_shapes)


def _tns_serving_chunks(n_streams, chunk_frames, n_chunks):
    """Payload chunks of the TNS serving corpus: its streams in turn."""
    config, streams = tns_serving_corpus(4, chunk_frames * n_chunks)
    corpus = [adts_payloads(d) for d in streams]
    per_stream = [corpus[i % len(corpus)] for i in range(n_streams)]
    return [config] * n_streams, [
        [p[k * chunk_frames:(k + 1) * chunk_frames] for p in per_stream]
        for k in range(n_chunks)]


@pytest.mark.parametrize("compact", [True, False])
def test_decode_pipelined_tns_corpus_matches_reference(compact):
    """8 streams x 2 chunks of the TNS serving corpus (M/S, short windows,
    TNS in both directions): every chunk takes the TNS route.  f32 PCM: the
    corpus's noise reaches gains of 2^20 and most of it saturates int16."""
    configs, chunks = _tns_serving_chunks(8, 8, 2)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False,
                                      compact=compact))
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    parsed = dec._parse_native(chunks[0], compact=compact)
    assert parsed["_has_tns"] and {"tns_lpc", "tns_range"} <= set(parsed)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False,
                                    compact=compact))
    assert len(got) == len(want) == 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.abs(w).max() > 1.0            # far outside the int16 range
        assert_pcm_close(g, w, False, f"chunk {k}")
    np.testing.assert_array_equal(dec.prev_shapes, ref.prev_shapes)


def test_state_handover_from_jax_on_tns_stream():
    """Chunk 0 of a TNS corpus in JAX, its state restored into the port,
    chunk 1 in both."""
    configs, chunks = _tns_serving_chunks(2, 8, 2)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    ref.step_raw(chunks[0], out_int16=False)
    state = ref.save_state()
    want = ref.step_raw(chunks[1], out_int16=False)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    dec.restore_state(state)
    got = dec.step_raw(chunks[1], out_int16=False)
    assert_pcm_close(got, want, False)
    assert dec.save_state()["frames_decoded"] == [16, 16]


def test_decode_adts_tns_short_matches_reference():
    data = tns_short_adts(12, seed=0)
    want, rate = aacjax.decode_adts(data)
    got, got_rate = aacjax_torch.decode_adts(data, device="cpu")
    assert got_rate == rate
    assert_pcm_close(got, want, False)


def test_decode_adts_mono_odd_chunks_matches_reference():
    """Mono in chunks of 5 frames: C = 1 + 2 CCE slots = 3, C*T = 15,
    which the port routes through the synthesis entry."""
    data = encode_adts(tone_pcm(1024 * 10)[:, :1], target_sf=120)
    want, rate = aacjax.decode_adts(data, chunk_frames=5)
    got, got_rate = aacjax_torch.decode_adts(data, chunk_frames=5,
                                             device="cpu")
    assert got_rate == rate and got.shape[1] == 1
    assert_pcm_close(got, want, False)


@pytest.mark.parametrize("drc_scale", [0.0, 0.5, 1.0])
def test_decode_adts_drc_matches_reference(drc_scale):
    """Banded dynamic_range_info gains with one excluded channel, folded
    into the native-parsed spectra on the host.  The stream comes from the
    port's copy of the encoder (its FIL path), byte-equal to aacjax's."""
    from aacjax.testing import encoder as jax_enc
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.testing import encoder as enc
    config = parse_asc(make_asc(2, 4, 2))
    t = np.arange(1024 * 6)[:, None] / 44100.0
    x = np.repeat(6000 * np.sin(2 * np.pi * 500 * t)
                  + 3000 * np.sin(2 * np.pi * 9000 * t), 2, axis=1)
    drc = enc.drc_payload([-18.0, 4.0], band_tops=[128, 1024],
                          excluded=[False, True])
    payloads = enc.encode_pcm_frames(x, config, target_sf=110,
                                     fil_payloads=[drc])
    assert payloads == jax_enc.encode_pcm_frames(x, config, target_sf=110,
                                                 fil_payloads=[drc])
    stream = b"".join(enc.adts_frame(p, config) for p in payloads)
    want, _ = aacjax.decode_adts(stream, drc_scale=drc_scale)
    got, _ = aacjax_torch.decode_adts(stream, drc_scale=drc_scale,
                                      device="cpu")
    assert_pcm_close(got, want, False)


def test_state_handover_from_jax():
    """Chunk 0 in JAX, its save_state() restored into the port, then
    chunk 1 in both packages."""
    configs, chunks = make_lc_payload_chunks(n_streams=2, chunk_frames=8,
                                             n_chunks=2, seed=3)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    ref.step_raw(chunks[0], out_int16=True)
    state = ref.save_state()
    want = ref.step_raw(chunks[1], out_int16=True)

    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    dec.restore_state(state)
    got = dec.step_raw(chunks[1], out_int16=True, compact=False)
    assert_pcm_close(got, want, True)
    back = dec.save_state()
    assert set(back) == {"overlap", "prev_shapes", "frames_decoded"}
    assert back["frames_decoded"] == [16, 16]


def test_he_stream_not_implemented():
    """HE-AAC v2 (ps_data; ROADMAP Queue 1 item 9, once refused) decodes
    through decode_adts as stereo at 44.1 kHz, equal to aacjax."""
    from aacjax_torch.testing import he_ps_stream
    got, rate = aacjax_torch.decode_adts(he_ps_stream(), chunk_frames=4,
                                         device="cpu")
    want, want_rate = aacjax.decode_adts(he_ps_stream(), chunk_frames=4)
    assert rate == want_rate == 44100 and got.shape == want.shape
    assert got.shape[1] == 2
    assert float(np.abs(got - want).max()) <= 2e-4 * max(
        1.0, float(np.abs(want).max()))


def test_restore_rejects_non_core_state():
    """A saved state with Parametric Stereo state round-trips (the next
    chunk after a restore equals the original decoder's); a predictor state
    of the wrong shape is refused, the right one taken, and a decoder on
    the python route is one."""
    from aacjax_torch.testing import he_ps_stream
    ps = adts_payloads(he_ps_stream(4))
    config = TI.parse_asc(TI.adts.synthesize_cookie(
        TI.adts.split_frames(he_ps_stream(1))[0][0]))
    src = aacjax_torch.BatchDecoder([config], chunk_frames=2, cce_slots=1,
                                    use_native=False, device="cpu")
    src.step_he_raw([ps[:2]])
    saved = src.save_state()
    assert saved["sbr"]["ps_enabled"] and saved["sbr"]["ps_pair"] == [1, -1]
    dst = aacjax_torch.BatchDecoder([config], chunk_frames=2, cce_slots=1,
                                    use_native=False, device="cpu")
    dst.restore_state(saved)
    np.testing.assert_array_equal(dst.step_he_raw([ps[2:4]]),
                                  src.step_he_raw([ps[2:4]]))

    configs, _ = make_lc_payload_chunks(n_streams=1, chunk_frames=4)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    state = dec.save_state()
    assert torch.equal(dec.overlap, torch.zeros_like(dec.overlap))
    state["pred_state"] = np.zeros((3, 672, 6), np.float32)
    with pytest.raises(ValueError, match="pred_state"):
        dec.restore_state(state)
    state["pred_state"] = np.ones((2, 672, 6), np.float32)
    dec.restore_state(state)
    assert dec.save_state()["pred_state"].shape == (2, 672, 6)
    assert not aacjax_torch.BatchDecoder(configs, use_native=False,
                                         device="cpu").use_native


# -- Main profile ----------------------------------------------------------------
def _chunked(per_stream, T):
    n = min(len(p) for p in per_stream) // T
    return [[p[k * T:(k + 1) * T] for p in per_stream] for k in range(n)]


def test_main_stereo_across_chunk_boundaries_matches_reference():
    """Two Main-profile stereo streams (prediction, reset groups, short
    windows, M/S, TNS) in chunks of 3 frames through decode_pipelined: the
    predictor state carries across chunks and equals the reference's bit
    for bit at the end."""
    cfg, corpus = TI.main_serving_corpus(2, 12)
    chunks = _chunked(corpus, 3)
    ref = JaxBatchDecoder([_jcfg(cfg)] * 2, chunk_frames=3)
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False))
    dec = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=3, device="cpu")
    parsed = dec._parse_native(chunks[0])
    assert parsed["_has_pred"] and not parsed["_spec_i16"]   # exact spectra
    dec = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=3, device="cpu")
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False))
    assert len(got) == len(want) == 4
    for k, (g, w) in enumerate(zip(got, want)):
        assert_pcm_close(g, w, False, f"chunk {k}")
    a, b = dec.save_state(), ref.save_state()
    np.testing.assert_array_equal(a["pred_state"].view(np.uint32),
                                  np.asarray(b["pred_state"]).view(np.uint32))
    assert not np.array_equal(a["pred_state"][..., :4], 0 * a["pred_state"][..., :4])


def test_state_handover_from_jax_with_predictor_state():
    """save_state of aacjax after chunk 0 restored into the port, chunk 1
    in both, and the port's state back into a fresh aacjax decoder for
    chunk 2."""
    cfg, corpus = TI.main_serving_corpus(2, 12)
    chunks = _chunked(corpus, 4)
    jcfgs = [_jcfg(cfg)] * 2
    ref = JaxBatchDecoder(jcfgs, chunk_frames=4)
    ref.step_raw(chunks[0])
    dec = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=4, device="cpu")
    dec.restore_state(ref.save_state())
    assert_pcm_close(dec.step_raw(chunks[1]), ref.step_raw(chunks[1]), False)
    back = dec.save_state()
    assert set(back) == {"overlap", "prev_shapes", "frames_decoded",
                         "pred_state"}
    ref2 = JaxBatchDecoder(jcfgs, chunk_frames=4)
    ref2.restore_state(back)
    assert_pcm_close(dec.step_raw(chunks[2]), ref2.step_raw(chunks[2]), False)


def test_main_with_intensity_is_delegated_to_the_python_route():
    """step_raw rolls the chunk back and redoes it on the python parser and
    packer; the stream is not left failed."""
    cfg = TI.main_config(2)
    payloads = TI.main_stereo_payloads(4, seed=6, intensity=True)
    ref = JaxBatchDecoder([_jcfg(cfg)], chunk_frames=4)
    want = ref.step_raw([payloads])
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=4, device="cpu")
    got = dec.step_raw([payloads])
    assert int(dec._last_status[0]) == native.ERR_DELEGATE
    assert not dec.streams[0].failed and dec.streams[0].frames_decoded == 4
    assert_pcm_close(got, want, False)
    np.testing.assert_array_equal(dec.prev_shapes, ref.prev_shapes)


# -- coupling, multichannel, other frame lengths --------------------------------
def _jcfg(cfg):
    """The aacjax StreamConfig of a port StreamConfig."""
    from aacjax.host.asc import make_asc, parse_asc
    return parse_asc(make_asc(cfg.profile, cfg.sample_index, cfg.chan_config,
                              frame_length=cfg.frame_length))


@pytest.mark.parametrize("point,target_tns", [(0, True), (1, False),
                                              (1, True), (2, True)])
def test_coupled_stream_matches_reference(point, target_tns):
    """A CCE at each coupling point: fused on the host, as device entries
    after TNS, and on the PCM through the coupling channel's own slot."""
    cfg = TI.lc_stereo_config()
    payloads = TI.cce_stereo_payloads(3, 50 + point, point, target_tns)
    ref = JaxBatchDecoder([_jcfg(cfg)], chunk_frames=3, cce_slots=1)
    want = ref.step_raw([payloads], compact=False)
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                    device="cpu")
    parsed = dec._parse_native([payloads], compact=False)
    assert parsed["_has_cce_post"] == (point == 1)
    assert parsed["_has_cce_time"] == (point == 2)
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                    device="cpu")
    got = dec.step_raw([payloads], compact=False)
    assert not dec.streams[0].failed
    assert_pcm_close(got, want, False)


def test_coupling_without_a_slot_fails_the_stream_with_the_fix():
    cfg = TI.lc_stereo_config()
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=1, cce_slots=0,
                                    device="cpu")
    dec.step_raw([TI.cce_stereo_payloads(1, 3, 2)])
    assert dec.streams[0].failed and "cce_slots" in dec.streams[0].last_error


@pytest.mark.parametrize("chan_config", [6, 7])
def test_multichannel_with_coupling_matches_reference(chan_config):
    """5.1 and 7.1 frames with a dependent AFTER_TNS and an independent
    coupling element, two streams, two chunks through decode_pipelined."""
    cfg = TI.multichannel_config(chan_config)
    per_stream = [TI.multichannel_payloads(chan_config, 4, s, coupling=True)
                  for s in (1, 2)]
    chunks = _chunked(per_stream, 2)
    ref = JaxBatchDecoder([_jcfg(cfg)] * 2, chunk_frames=2, cce_slots=2)
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False,
                                      compact=False))
    dec = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=2, cce_slots=2,
                                    device="cpu")
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False,
                                    compact=False))
    assert dec.C == 2 * (cfg.channels + 2)
    for g, w in zip(got, want, strict=True):
        assert_pcm_close(g, w, False)
    assert not any(st.failed for st in dec.streams)


@pytest.mark.parametrize("profile,frame_length,channels", [
    (2, 960, 2), (17, 1024, 1), (17, 960, 2), (23, 512, 2), (23, 480, 1),
    (39, 512, 2), (39, 480, 1)])
def test_other_profiles_and_frame_lengths_match_reference(profile,
                                                          frame_length,
                                                          channels):
    """LC at 960, ER-LC, LD and ELD through the native route in two chunks
    (the ELD carry is [C, 3F])."""
    cfg = TI.er_config(profile, frame_length, channels)
    if profile == 2:
        rng = np.random.default_rng(9)
        from aacjax_torch.host.bitio import BitWriter
        from aacjax_torch.testing import encoder as enc
        from aacjax_torch.testing.specgen import random_cpe_spec
        payloads = []
        for _ in range(6):
            w = BitWriter()
            enc.write_cpe(w, random_cpe_spec(rng, cfg), cfg)
            payloads.append(enc.end_frame(w))
    else:
        payloads = TI.er_payloads(cfg, 6, seed=frame_length + profile)
    chunks = _chunked([payloads], 3)
    ref = JaxBatchDecoder([_jcfg(cfg)], chunk_frames=3)
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, device="cpu")
    assert dec.F == frame_length and dec.use_native
    assert dec.overlap.shape == (channels,
                                 (3 if profile == 39 else 1) * frame_length)
    for chunk in chunks:
        want = ref.step_raw(chunk, compact=False)
        got = dec.step_raw(chunk, compact=False)
        assert got.shape == (channels, 3, frame_length)
        assert_pcm_close(got, want, False)
    assert not dec.streams[0].failed
    assert_pcm_close(dec.save_state()["overlap"] / 32768.0,
                     np.asarray(ref.save_state()["overlap"]) / 32768.0, False)


def test_eld_state_handover_from_jax():
    cfg = TI.er_config(39, 512, 1)
    payloads = TI.er_payloads(cfg, 4, seed=3)
    ref = JaxBatchDecoder([_jcfg(cfg)], chunk_frames=2)
    ref.step_raw([payloads[:2]], compact=False)
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=2, device="cpu")
    dec.restore_state(ref.save_state())
    assert_pcm_close(dec.step_raw([payloads[2:]], compact=False),
                     ref.step_raw([payloads[2:]], compact=False), False)


def test_constructor_refuses_mixed_batches():
    lc, eld = TI.lc_stereo_config(), TI.er_config(39, 512, 2)
    with pytest.raises(ValueError, match="frame lengths"):
        aacjax_torch.BatchDecoder([lc, eld], device="cpu")
    with pytest.raises(ValueError, match="ELD"):
        aacjax_torch.BatchDecoder([TI.er_config(23, 512, 2), eld],
                                  device="cpu")


# -- LTP ---------------------------------------------------------------------------
def test_ltp_batch_equals_reference_exactly():
    """An all-LTP batch decodes on the host engine, the same numpy code in
    both packages: equal bit for bit, f32 and int16."""
    from aacjax_torch.host.asc import make_asc, parse_asc
    cfg = parse_asc(make_asc(4, 4, 1))
    streams = [adts_payloads(TI.ltp_adts(6, seed=s, tns=s == 2)) for s in (1, 2)]
    ref = JaxBatchDecoder([_jcfg(cfg)] * 2, chunk_frames=3)
    dec = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=3, device="cpu")
    assert dec._ltp_batch is not None and not dec.use_native
    for k, chunk in enumerate(_chunked(streams, 3)):
        want = ref.step_raw(chunk, out_int16=k == 1)
        got = dec.step_raw(chunk, out_int16=k == 1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [st.frames_decoded for st in dec.streams] == [6, 6]


# -- the python parser and packer --------------------------------------------------
def test_python_route_matches_reference_and_native_route():
    """use_native=False: parse_stream_frames + step, and step_raw, against
    the reference's; and against the port's native route."""
    config, streams = tns_serving_corpus(2, 4)
    per_stream = [adts_payloads(d) for d in streams]
    ref = JaxBatchDecoder([_jcfg(config)] * 2, chunk_frames=4,
                          use_native=False)
    want = ref.step([ref.parse_stream_frames(i, p)
                     for i, p in enumerate(per_stream)])
    dec = aacjax_torch.BatchDecoder([config] * 2, chunk_frames=4,
                                    use_native=False, device="cpu")
    got = dec.step([dec.parse_stream_frames(i, p)
                    for i, p in enumerate(per_stream)])
    assert_pcm_close(got, want, False)
    np.testing.assert_array_equal(dec.prev_shapes, ref.prev_shapes)
    raw = aacjax_torch.BatchDecoder([config] * 2, chunk_frames=4,
                                    use_native=False, device="cpu")
    assert_pcm_close(raw.step_raw(per_stream), want, False)
    nat = aacjax_torch.BatchDecoder([config] * 2, chunk_frames=4,
                                    device="cpu")
    assert_pcm_close(nat.step_raw(per_stream, compact=False), want, False)


def test_python_route_isolates_a_corrupt_stream():
    config, streams = tns_serving_corpus(2, 3)
    good = adts_payloads(streams[0])
    bad = [adts_payloads(streams[1])[0], b"\x00\x01\x02\x03"]
    dec = aacjax_torch.BatchDecoder([config] * 2, chunk_frames=3,
                                    use_native=False, device="cpu")
    pcm = dec.step_raw([good, bad])
    assert dec.streams[1].failed and not dec.streams[0].failed
    assert dec.streams[1].frames_decoded == 1
    solo = aacjax_torch.BatchDecoder([config], chunk_frames=3,
                                     use_native=False, device="cpu")
    np.testing.assert_array_equal(pcm[:2], solo.step_raw([good]))
    with pytest.raises(ValueError, match="chunk size"):
        dec.step([dec.parse_stream_frames(0, good) * 2, None])


# -- stream reset --------------------------------------------------------------------
def test_reset_stream_recycles_slot():
    """One stream ends and another client takes its slots: the recycled
    slots decode like a fresh decoder, predictor rows included, and the
    neighbour's chain goes on."""
    cfg, corpus = TI.main_serving_corpus(3, 8)
    a, b, c = corpus
    dec = aacjax_torch.BatchDecoder([cfg, cfg], chunk_frames=4, device="cpu")
    dec.step_raw([a[:4], b[:4]])
    dec.reset_stream(0)
    assert dec.streams[0].frames_decoded == 0
    pcm = dec.step_raw([c[:4], b[4:]])
    fresh = aacjax_torch.BatchDecoder([cfg], chunk_frames=4, device="cpu")
    np.testing.assert_array_equal(pcm[:2], fresh.step_raw([c[:4]]))
    undisturbed = aacjax_torch.BatchDecoder([cfg], chunk_frames=4,
                                            device="cpu")
    undisturbed.step_raw([b[:4]])
    np.testing.assert_array_equal(pcm[2:], undisturbed.step_raw([b[4:]]))
    ref = JaxBatchDecoder([_jcfg(cfg)] * 2, chunk_frames=4)
    ref.step_raw([a[:4], b[:4]])
    ref.reset_stream(0)
    assert_pcm_close(pcm, ref.step_raw([c[:4], b[4:]]), False)


def test_reset_stream_swaps_config():
    """A 48 kHz client replaces a 44.1 kHz one in place; the three
    refusals."""
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.host.bitio import BitWriter
    from aacjax_torch.testing import encoder as enc
    from aacjax_torch.testing.specgen import random_channel_spec
    cfg44, cfg48 = parse_asc(make_asc(2, 4, 1)), parse_asc(make_asc(2, 3, 1))
    rng = np.random.default_rng(77)

    def sce(cfg):
        w = BitWriter()
        enc.write_sce(w, random_channel_spec(
            rng, cfg, window_sequence=0, allow_pulse=False,
            allow_noise=False), cfg)
        return enc.end_frame(w)

    pays44, pays48 = [sce(cfg44) for _ in range(3)], [sce(cfg48)
                                                      for _ in range(3)]
    dec = aacjax_torch.BatchDecoder([cfg44], chunk_frames=3, cce_slots=1,
                                    device="cpu")
    dec.step_raw([pays44], compact=False)
    dec.reset_stream(0, cfg48)
    got = dec.step_raw([pays48], compact=False)
    fresh = aacjax_torch.BatchDecoder([cfg48], chunk_frames=3, cce_slots=1,
                                      device="cpu")
    np.testing.assert_array_equal(got, fresh.step_raw([pays48],
                                                      compact=False))
    ref = JaxBatchDecoder([_jcfg(cfg44)], chunk_frames=3, cce_slots=1)
    ref.step_raw([pays44], compact=False)
    ref.reset_stream(0, _jcfg(cfg48))
    assert_pcm_close(got, ref.step_raw([pays48], compact=False), False)
    with pytest.raises(ValueError, match="frame length"):
        dec.reset_stream(0, parse_asc(make_asc(2, 4, 1, frame_length=960)))
    with pytest.raises(ValueError, match="channels"):
        dec.reset_stream(0, parse_asc(make_asc(2, 4, 6)))
    ld = aacjax_torch.BatchDecoder([TI.er_config(23, 512, 1)], device="cpu")
    with pytest.raises(ValueError, match="ELD"):
        ld.reset_stream(0, TI.er_config(39, 512, 1))


def test_request_reset_mid_pipeline():
    """A slot is recycled while decode_pipelined has a chunk in flight:
    request_reset waits for the next chunk boundary, the recycled stream
    restarts like a fresh decoder from there, the neighbour's PCM equals an
    undisturbed run's, and reset_stream itself refuses mid-flight."""
    cfg, corpus = TI.main_serving_corpus(3, 8)
    a, b, c = corpus
    T = 2
    want_b = aacjax_torch.BatchDecoder([cfg], chunk_frames=T, device="cpu")
    want_b = [want_b.step_raw([b[i * T:(i + 1) * T]]) for i in range(4)]
    fresh = aacjax_torch.BatchDecoder([cfg], chunk_frames=T, device="cpu")
    want_c = [fresh.step_raw([c[i * T:(i + 1) * T]]) for i in range(2)]
    dec = aacjax_torch.BatchDecoder([cfg, cfg], chunk_frames=T, device="cpu")

    def chunk_source():
        for i in range(4):
            if i == 2:      # asked for as the new client's first chunk is made
                dec.request_reset(0)
            src0 = a[i * T:(i + 1) * T] if i < 2 else c[(i - 2) * T:(i - 1) * T]
            yield [src0, b[i * T:(i + 1) * T]]

    got = []
    for i, pcm in enumerate(dec.decode_pipelined(chunk_source(),
                                                 out_int16=False)):
        got.append(pcm.copy())
        if i == 0:
            with pytest.raises(RuntimeError, match="request_reset"):
                dec.reset_stream(0)
            with pytest.raises(RuntimeError, match="in flight"):
                dec.save_state()
    assert len(got) == 4
    for i in range(4):
        np.testing.assert_array_equal(got[i][2:4], want_b[i])
    np.testing.assert_array_equal(got[2][0:2], want_c[0])
    np.testing.assert_array_equal(got[3][0:2], want_c[1])
    assert dec._deferred_resets == [] and not dec._pipeline_active
