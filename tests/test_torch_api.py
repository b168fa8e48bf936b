"""The port's public API on the CPU against the JAX package on the same
bytes: decode_adts on Main, delegated, coupled, multichannel, LTP and
multi-raw_data_block streams, decode_loas on the ER profiles and 960-sample
frames, and the streaming AACDecoder fed in small pieces.

Tolerances: f32 PCM within 5e-5 * max(1, max|ref|); the LTP route, the same
numpy code in both packages, exactly.
"""
import numpy as np
import pytest

import aacjax
from aacjax.host import native
import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.testing import assert_pcm_close
from aacjax_torch.testing import encoder as enc

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")


def both(fn, data, **kw):
    want, rate = getattr(aacjax, fn)(data, **kw)
    got, got_rate = getattr(aacjax_torch, fn)(data, device="cpu", **kw)
    assert got_rate == rate and got.shape == want.shape
    return got, want


def adts_of(payloads, cfg):
    return b"".join(enc.adts_frame(p, cfg) for p in payloads)


@pytest.mark.parametrize("chunk_frames", [64, 3])
def test_decode_adts_main_matches_reference(chunk_frames):
    """Prediction with reset groups, short-window resets, M/S and TNS; in
    chunks of 3 frames the predictor state crosses chunk boundaries."""
    got, want = both("decode_adts", TI.main_stereo_adts(10, seed=0),
                     chunk_frames=chunk_frames)
    assert got.shape == (10 * 1024, 2)
    assert_pcm_close(got, want, False)


def test_decode_adts_main_with_intensity_restarts_on_the_python_route():
    data = TI.main_stereo_adts(5, seed=8, intensity=True)
    got, want = both("decode_adts", data, chunk_frames=2)
    assert np.isfinite(got).all() and got.shape == (5 * 1024, 2)
    assert_pcm_close(got, want, False)


@pytest.mark.parametrize("point", [0, 1, 2])
def test_decode_adts_coupled_stream_matches_reference(point):
    """The default cce_slots covers the coupling channel."""
    cfg = TI.lc_stereo_config()
    data = adts_of(TI.cce_stereo_payloads(3, 60 + point, point, True), cfg)
    got, want = both("decode_adts", data)
    assert_pcm_close(got, want, False)


@pytest.mark.parametrize("chan_config,n_ch", [(6, 6), (7, 8)])
def test_decode_adts_multichannel_matches_reference(chan_config, n_ch):
    cfg = TI.multichannel_config(chan_config)
    data = adts_of(TI.multichannel_payloads(chan_config, 3, 2, coupling=True),
                   cfg)
    got, want = both("decode_adts", data)
    assert got.shape == (3 * 1024, n_ch)
    assert_pcm_close(got, want, False)
    np.testing.assert_array_equal(
        aacjax_torch.to_canonical_order(got, chan_config),
        aacjax.api.to_canonical_order(got, chan_config))
    assert aacjax_torch.api.CANONICAL_ORDER == aacjax.api.CANONICAL_ORDER
    canon = aacjax_torch.to_canonical_order(got, chan_config)
    assert sorted(map(tuple, canon.T[:, :8])) == sorted(map(tuple,
                                                            got.T[:, :8]))


@pytest.mark.parametrize("kw", [dict(), dict(channels=2),
                                dict(tns=True), dict(short_frames=(3, 4))])
def test_decode_adts_ltp_equals_reference_exactly(kw):
    data = TI.ltp_adts(8, seed=5, **kw)
    got, want = both("decode_adts", data)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0


def test_decode_adts_ltp_python_loop_equals_reference_exactly():
    """drc_scale > 0 keeps LTP off the native feed: the per-frame loop."""
    data = TI.ltp_adts(4, seed=6)
    got, want = both("decode_adts", data, drc_scale=0.5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crc", [False, True])
def test_decode_adts_multi_rdb_matches_reference(crc):
    """Three raw_data_blocks a frame, plain and with the per-block
    crc_check layout, through the streaming decoder."""
    data = TI.multi_rdb_adts(9, crc=crc)
    got, want = both("decode_adts", data)
    assert got.shape == (9 * 1024, 2)
    assert_pcm_close(got, want, False)
    if crc:
        got_v, want_v = both("decode_adts", data, verify_crc=True)
        assert_pcm_close(got_v, want_v, False)
        np.testing.assert_array_equal(got_v, got)


def test_decode_adts_multi_rdb_conceals_a_frame_that_fails_its_crc():
    data = bytearray(TI.multi_rdb_adts(9, crc=True))
    frames = aacjax_torch.host.adts.split_frames(bytes(data))
    _, s, _ = frames[1]
    data[s + 4] ^= 0x10
    with pytest.raises(aacjax_torch.api.BitstreamError, match="crc_check"):
        aacjax_torch.decode_adts(bytes(data), verify_crc=True, device="cpu")
    got, want = both("decode_adts", bytes(data), verify_crc=True,
                     on_error="skip")
    assert got.shape == (9 * 1024, 2)
    assert not got[3 * 1024:6 * 1024].any()
    assert_pcm_close(got, want, False)


@pytest.mark.parametrize("profile,frame_length,channels", [
    (17, 1024, 2), (23, 512, 1), (23, 480, 2), (39, 512, 2), (39, 480, 1)])
@pytest.mark.parametrize("chunk_frames", [64, 2])
def test_decode_loas_er_profiles_match_reference(profile, frame_length,
                                                 channels, chunk_frames):
    """ER-LC, LD and ELD through LOAS/LATM; in chunks of 2 frames the ELD
    carry crosses chunk boundaries."""
    cfg = TI.er_config(profile, frame_length, channels)
    loas = enc.loas_stream(TI.er_payloads(cfg, 5, seed=profile + channels),
                           cfg)
    got, want = both("decode_loas", loas, chunk_frames=chunk_frames)
    assert got.shape == (5 * frame_length, channels)
    assert_pcm_close(got, want, False)


def _pcm960(n_frames, channels):
    t = np.arange(960 * n_frames) / 44100
    x = 8000 * np.sin(2 * np.pi * 700 * t) + 200 * np.random.default_rng(
        1).standard_normal(t.size)
    return np.stack([x, 0.7 * np.roll(x, 31)], axis=1)[:, :channels]


def test_decode_loas_960_takes_the_streaming_decoder():
    cfg = TI.er_config(2, 960, 2)
    payloads = enc.encode_pcm_frames(_pcm960(5, 2), cfg, target_sf=120)
    got, want = both("decode_loas", enc.loas_stream(payloads, cfg))
    assert got.shape == (len(payloads) * 960, 2)
    assert_pcm_close(got, want, False)


def test_decode_loas_lc_is_reframed_onto_decode_adts():
    cfg = TI.lc_stereo_config()
    payloads = TI.adts_payloads(TI.tns_short_adts(4, seed=2))
    got, want = both("decode_loas", enc.loas_stream(payloads, cfg))
    assert_pcm_close(got, want, False)
    with pytest.raises(aacjax_torch.api.BitstreamError, match="LOAS"):
        aacjax_torch.decode_loas(b"\x00" * 64, device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        aacjax_torch.decode_loas(b"", on_error="ignore", device="cpu")


def _drain(dec, data, step):
    chunks = []
    for i in range(0, len(data), step):
        dec.feed(data[i:i + step])
        while (c := dec.read_chunk()) is not None:
            chunks.append(c)
    return chunks


def test_streaming_decoder_adts_in_small_pieces_matches_reference():
    """ADTS fed 97 bytes at a time: the first block through the python
    parser (it settles that there is no SBR), the rest through the native
    streaming route."""
    data = TI.tns_short_adts(6, seed=4)
    ref = aacjax.AACDecoder()
    dec = aacjax_torch.AACDecoder(device="cpu")
    want, got = _drain(ref, data, 97), _drain(dec, data, 97)
    assert len(got) == len(want) == 6
    assert_pcm_close(np.stack(got), np.stack(want), False)
    assert dec.output_sample_rate == 44100 and dec.output_channels == 2
    assert dec._runtime.use_native and dec._sbr_mode is False
    whole, _ = aacjax_torch.decode_adts(data, device="cpu")
    assert_pcm_close(np.stack(got).reshape(-1, 2), whole, False)
    st = dec.state
    assert st["bitpos"] > 0 and st["runtime"]["frames_decoded"] == [6]
    dec.reset()
    assert dec.read_chunk() is None and dec.state["bitpos"] == 0


@pytest.mark.parametrize("use_native", [None, False])
def test_streaming_decoder_main_matches_reference(use_native):
    """Main profile block by block (T = 1): the predictor state advances
    one frame a step, on the native streaming route and on the python
    parser and packer."""
    data = TI.main_stereo_adts(6, seed=0)
    ref = aacjax.AACDecoder(use_native=use_native)
    dec = aacjax_torch.AACDecoder(use_native=use_native, device="cpu")
    want, got = _drain(ref, data, 4096), _drain(dec, data, 4096)
    assert len(got) == len(want) == 6
    assert_pcm_close(np.stack(got), np.stack(want), False)


@pytest.mark.parametrize("profile,frame_length", [(39, 512), (23, 480)])
def test_streaming_decoder_loas_in_small_pieces_matches_reference(
        profile, frame_length):
    """LOAS sniffed at the first feed and demuxed as it arrives; ELD runs
    the low-delay filterbank at T = 1."""
    cfg = TI.er_config(profile, frame_length, 1)
    loas = enc.loas_stream(TI.er_payloads(cfg, 6, seed=19), cfg)
    ref, dec = aacjax.AACDecoder(), aacjax_torch.AACDecoder(device="cpu")
    want, got = _drain(ref, loas, 97), _drain(dec, loas, 97)
    assert len(got) == len(want) == 6 and got[0].shape == (frame_length,)
    assert_pcm_close(np.stack(got), np.stack(want), False)
    whole, _ = aacjax_torch.decode_loas(loas, device="cpu")
    assert_pcm_close(np.concatenate(got)[:, None], whole, False)


def test_streaming_decoder_960_cookie_matches_reference():
    cfg = TI.er_config(2, 960, 1)
    payloads = enc.encode_pcm_frames(_pcm960(4, 1), cfg, target_sf=120)
    cookie = make_asc(2, 4, 1, frame_length=960)
    ref = aacjax.AACDecoder(cookie=cookie)
    dec = aacjax_torch.AACDecoder(cookie=cookie, device="cpu")
    want = _drain(ref, b"".join(payloads), 4096)
    got = _drain(dec, b"".join(payloads), 4096)
    assert len(got) == len(payloads) and all(c.shape == (960,) for c in got)
    assert_pcm_close(np.stack(got), np.stack(want), False)


def test_streaming_decoder_ltp_equals_reference_exactly():
    data = TI.ltp_adts(5, seed=7)
    want = _drain(aacjax.AACDecoder(), data, 300)
    got = _drain(aacjax_torch.AACDecoder(device="cpu"), data, 300)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_streaming_decoder_without_configuration():
    dec = aacjax_torch.AACDecoder(device="cpu")
    with pytest.raises(aacjax_torch.api.UnsupportedError):
        dec.read_chunk()
    dec.feed(b"\xff")                 # half a syncword: keep waiting
    assert dec.readChunk() is None
    with pytest.raises(aacjax_torch.api.UnsupportedError):
        dec.output_sample_rate


def test_he_content_raises_not_implemented_everywhere():
    """HE-AAC v2 (Parametric Stereo, ROADMAP Queue 1 item 9), once the only
    content the port refused, decodes as stereo equal to aacjax: implicit
    signalling through decode_adts and the streaming decoder, explicit
    signalling through a cookie and through LOAS."""
    ps = TI.he_ps_stream()

    def drain(mod, **kw):
        dec = mod.AACDecoder(**kw)
        dec.feed(data)
        out = []
        while (c := dec.read_chunk()) is not None:
            out.append(c.reshape(-1, dec.output_channels))
        return np.concatenate(out), dec.output_sample_rate

    raw = TI.adts_payloads(ps)
    explicit = make_asc(2, 7, 1, sbr=True)
    loas = enc.loas_stream(raw, parse_asc(explicit))
    cases = [("decode_adts", aacjax_torch.decode_adts(ps, chunk_frames=4,
                                                      device="cpu"),
              aacjax.decode_adts(ps, chunk_frames=4)),
             ("decode_loas", aacjax_torch.decode_loas(loas, device="cpu"),
              aacjax.decode_loas(loas))]
    data = ps
    cases.append(("AACDecoder", drain(aacjax_torch, device="cpu"),
                  drain(aacjax)))
    data = b"".join(raw)
    cases.append(("AACDecoder, explicit cookie",
                  drain(aacjax_torch, cookie=explicit, device="cpu"),
                  drain(aacjax, cookie=explicit)))
    for what, (got, rate), (want, want_rate) in cases:
        assert rate == want_rate == 44100, what
        assert got.shape == want.shape and got.shape[1] == 2, what
        err = float(np.abs(got - want).max()) / max(1.0, float(
            np.abs(want).max()))
        assert err <= 2e-4, (what, err)