"""The port's container and player surfaces on the CPU: MP4/M4A demux and
decode_m4a (the cases of tests/test_mp4.py), the random-access AACFile
(tests/test_seek.py) and the Aurora-style facade (tests/test_aurora.py),
each also against the same call in aacjax on the same bytes.

Tolerances: the port's own routes are held to each other as the reference
holds its own (bit for bit where the reference is: decode_m4a against
decode_adts, trims, AAC-LC and LD/ELD seek reads against the full decode);
against aacjax, 2e-4 * max(1, max|ref|) for the core and HE_ROUTE_TOL =
1e-3 for HE-AAC, the tolerances of the port's other tests."""
import numpy as np
import pytest
import torch

import aacjax
import aacjax_torch
from aacjax_torch import AACFile, decode_adts, decode_loas, decode_m4a
from aacjax_torch.host import adts, mp4
from aacjax_torch.host.asc import UnsupportedError, make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.mp4mux import _box, _full, mux_fmp4, mux_m4a
from aacjax_torch.testing.specgen import random_channel_spec, random_cpe_spec

CORE_TOL = 2e-4
HE_ROUTE_TOL = 1e-3
CPU = dict(device="cpu")


def _close(got, want, tol=CORE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _payloads(n=6, seed=3, config=None):
    config = config or parse_asc(make_asc(2, 4, 2))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, config, common=True), config)
        out.append(enc.end_frame(w))
    return config, out


def _mux(config, payloads, **kw):
    asc = make_asc(config.profile, config.sample_index, config.chan_config)
    return mux_m4a(payloads, asc, config.sample_rate, config.channels, **kw)


def _he_payloads(n_frames, seed):
    """HE-AAC (22.05 kHz core, 44.1 kHz out) raw payloads of low-level noise
    with one SBR extension a frame, as the reference's seek and m4a tests
    build them."""
    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import SBRFrameSpec, sbr_payload
    rng = np.random.default_rng(seed)
    core_cfg = parse_asc(make_asc(2, 7, 1))
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    tab = S.derive_tables(h, 2 * core_cfg.sample_rate)
    spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * tab.n_q,
                        env_q=np.full((2, tab.n_bands(1)), 25, np.int64),
                        noise_q=np.full((2, tab.n_q), 30, np.int64))
    pay = sbr_payload([spec], h, 2 * core_cfg.sample_rate)
    x = 1500 * rng.standard_normal((1024 * n_frames, 1))
    return core_cfg, enc.encode_pcm_frames(x, core_cfg, target_sf=118,
                                           fil_payloads=[pay])


# -- MP4 / M4A ---------------------------------------------------------------
def test_probe():
    config, payloads = _payloads()
    data = _mux(config, payloads)
    for d, want in ((data, True), (b"\xff\xf1" + data, False),
                    (b"garbage bytes here", False), (b"", False)):
        assert aacjax_torch.probe_m4a(d) is want
        assert aacjax.probe_m4a(d) is want


@pytest.mark.parametrize("kw", [
    dict(),                          # mdat before moov
    dict(moov_first=True),           # faststart
    dict(co64=True),                 # 64-bit chunk offsets
    dict(samples_per_chunk=1),
    dict(samples_per_chunk=100),     # single chunk
    dict(qt_version=1),              # QuickTime v1 sound description
])
def test_demux_roundtrip(kw):
    """The port's muxer writes the reference muxer's bytes, and its demuxer
    returns the muxed payloads byte for byte, across layout variants."""
    from aacjax.testing.mp4mux import mux_m4a as j_mux
    config, payloads = _payloads(n=9)
    data = _mux(config, payloads, **kw)
    asc = make_asc(config.profile, config.sample_index, config.chan_config)
    assert data == j_mux(payloads, asc, config.sample_rate, config.channels,
                         **kw)
    track, got = mp4.split_samples(data)
    assert got == payloads, kw
    assert track.config.sample_rate == config.sample_rate
    assert track.config.chan_config == config.chan_config
    assert track.timescale == config.sample_rate
    assert track.sample_durations == [1024] * len(payloads)


def test_demux_fragmented():
    config, payloads = _payloads(n=8)
    asc = make_asc(config.profile, config.sample_index, config.chan_config)
    data = mux_fmp4([payloads[:3], payloads[3:6], payloads[6:]], asc,
                    config.sample_rate, config.channels)
    assert mp4.split_samples(data)[1] == payloads


def test_decode_m4a_matches_adts_path():
    """decode_m4a routes ADTS-expressible configs through decode_adts: bit
    for bit on the port's CPU route, and within the core tolerance of
    aacjax's decode_m4a."""
    config, payloads = _payloads()
    data = _mux(config, payloads)
    a, ra = decode_m4a(data, **CPU)
    b, rb = decode_adts(b"".join(adts.wrap_frame(p, config)
                                 for p in payloads), **CPU)
    assert ra == rb
    np.testing.assert_array_equal(a, b)
    want, rate = aacjax.decode_m4a(data)
    assert rate == ra
    _close(a, want)


def test_gapless_trim():
    """elst priming + valid duration trim the output to the source window,
    as in aacjax."""
    config, payloads = _payloads(n=6)
    n_total = 1024 * len(payloads)
    priming = 2112
    valid = n_total - priming - 500
    data = _mux(config, payloads, priming=priming, valid_samples=valid,
                movie_ts=config.sample_rate)
    track = mp4.parse(data)
    assert (track.priming, track.total_samples) == (priming, valid)
    full, _ = decode_m4a(data, trim=False, **CPU)
    trimmed, _ = decode_m4a(data, **CPU)
    assert full.shape[0] == n_total and trimmed.shape[0] == valid
    np.testing.assert_array_equal(trimmed, full[priming:priming + valid])
    _close(trimmed, aacjax.decode_m4a(data)[0])


def test_esds_parse_errors():
    with pytest.raises(mp4.MP4Error):
        mp4.parse_esds(b"\x00\x00\x00\x00\x07", 0, 5)
    with pytest.raises(mp4.MP4Error):
        mp4.parse(b"\x00\x00\x00\x08ftyp")
    moov = _box(b"moov", _full(b"mvhd", 0, 0, b"\x00" * 96))
    with pytest.raises(mp4.MP4Error):
        mp4.parse(_box(b"ftyp", b"M4A ") + moov)
    with pytest.raises(UnsupportedError):
        decode_m4a(_box(b"ftyp", b"M4A ") + moov, **CPU)


def test_corrupt_sample_table_is_bounded():
    """Sample ranges past EOF are dropped instead of crashing; the port
    decodes what is left as aacjax does."""
    config, payloads = _payloads(n=4)
    data = _mux(config, payloads, moov_first=True)
    track = mp4.parse(data)
    short = data[: track.samples[-1][0] + 1]
    t2 = mp4.parse(short)
    assert len(t2.samples) == len(payloads) - 1
    assert [short[s:e] for s, e in t2.samples] == payloads[:-1]
    got, _ = decode_m4a(short, **CPU)
    assert got.shape[0] == 1024 * (len(payloads) - 1)
    _close(got, aacjax.decode_m4a(short)[0])


def test_decode_m4a_he_aac_explicit_sbr():
    """HE-AAC with explicit AOT-5 signalling in the esds ASC: 2x the core
    rate, the elst trim scaled to output samples; within HE_ROUTE_TOL of
    aacjax."""
    core_cfg, payloads = _he_payloads(5, seed=2)
    priming = 1024
    data = mux_m4a(payloads, make_asc(2, 7, 1, sbr=True),
                   core_cfg.sample_rate, 1, priming=priming,
                   movie_ts=core_cfg.sample_rate)
    pcm, rate = decode_m4a(data, **CPU)
    assert rate == 44100
    assert pcm.shape[0] == 2048 * len(payloads) - 2 * priming
    full, _ = decode_m4a(data, trim=False, **CPU)
    np.testing.assert_array_equal(pcm, full[2 * priming:])
    want, want_rate = aacjax.decode_m4a(data)
    assert want_rate == rate
    _close(pcm, want, HE_ROUTE_TOL)


def test_decode_m4a_960_mode():
    """960-sample frames (inexpressible in ADTS) through the streaming
    route with the embedded cookie."""
    config = parse_asc(make_asc(2, 4, 1, frame_length=960))
    rng = np.random.default_rng(5)
    payloads = []
    for _ in range(4):
        w = BitWriter()
        enc.write_sce(w, random_channel_spec(rng, config), config)
        payloads.append(enc.end_frame(w))
    asc = make_asc(2, 4, 1, frame_length=960)
    data = mux_m4a(payloads, asc, config.sample_rate, 1, frame_length=960)
    pcm, rate = decode_m4a(data, **CPU)
    assert rate == config.sample_rate and pcm.shape == (960 * 4, 1)
    assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0
    _close(pcm, aacjax.decode_m4a(data)[0])


# -- AACFile -----------------------------------------------------------------
def _adts_stream(n=12, seed=0, ch=2):
    config = parse_asc(make_asc(2, 4, ch))
    rng = np.random.default_rng(seed)
    t = np.arange(1024 * n)[:, None] / 44100.0
    x = 8000 * np.sin(2 * np.pi * np.array([[440.0, 660.0][:ch]]) * t)
    x += 300 * rng.standard_normal((1024 * n, ch))
    return config, enc.encode_pcm(x.astype(np.float64), config,
                                  target_sf=120)


def test_facts_and_full_read():
    _, stream = _adts_stream()
    f = AACFile(stream, **CPU)
    assert (f.sample_rate, f.channels) == (44100, 2)
    full, _ = decode_adts(stream, **CPU)
    assert f.total_samples == full.shape[0]
    assert f.duration == pytest.approx(full.shape[0] / 44100)
    np.testing.assert_array_equal(f.read(), full)
    j = aacjax.AACFile(stream)
    assert (j.sample_rate, j.channels, j.total_samples, j.frames) == (
        f.sample_rate, f.channels, f.total_samples, f.frames)


@pytest.mark.parametrize("start,n", [
    (0, 1024),                # head
    (5 * 1024, 1024),         # frame-aligned interior
    (5 * 1024 + 137, 2000),   # unaligned, crosses a boundary
    (11 * 1024 + 512, 4096),  # clipped at EOF
    (3 * 1024, 1),            # single sample
])
def test_seek_read_bit_identical(start, n):
    """AAC-LC: a warmed-in ranged read equals the same slice of the full
    decode bit for bit, and aacjax's ranged read within the core
    tolerance."""
    _, stream = _adts_stream()
    full, _ = decode_adts(stream, **CPU)
    got = AACFile(stream, **CPU).read(start, n)
    want = full[start:start + n]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    _close(got, aacjax.AACFile(stream).read(start, n))


def test_player_cursor():
    _, stream = _adts_stream(n=6)
    full, _ = decode_adts(stream, **CPU)
    f = AACFile(stream, **CPU)
    f.seek(3 * 1024 / 44100)
    assert f.tell() == pytest.approx(3 * 1024 / 44100)
    chunks = []
    while (c := f.read_chunk()) is not None:
        chunks.append(c)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=0),
                                  full[3 * 1024:])


def test_m4a_with_gapless_trim():
    """Seek positions are presentation samples: the elst priming is
    transparent to read()."""
    config = parse_asc(make_asc(2, 4, 2))
    rng = np.random.default_rng(1)
    t = np.arange(1024 * 8)[:, None] / 44100.0
    x = 8000 * np.sin(2 * np.pi * np.array([[440.0, 660.0]]) * t)
    x += 300 * rng.standard_normal(x.shape)
    payloads = enc.encode_pcm_frames(x, config, target_sf=120)
    data = mux_m4a(payloads, make_asc(2, 4, 2), 44100, 2, priming=2112,
                   movie_ts=44100)
    trimmed, _ = decode_m4a(data, **CPU)
    f = AACFile(data, **CPU)
    assert f.total_samples == trimmed.shape[0]
    got = f.read(3000, 1500)
    np.testing.assert_array_equal(got, trimmed[3000:4500])
    _close(got, aacjax.AACFile(data).read(3000, 1500))


def test_he_aac_seek_converges():
    """HE-AAC: QMF and envelope histories decay, so a warmed-in seek read
    matches the full decode above 60 dB; the read is within HE_ROUTE_TOL
    of aacjax's same read (both in chunks of 8 frames)."""
    core_cfg, payloads = _he_payloads(24, seed=2)
    stream = b"".join(enc.adts_frame(p, core_cfg) for p in payloads)
    full, rate = decode_adts(stream, chunk_frames=8, **CPU)
    assert rate == 44100
    f = AACFile(stream, chunk_frames=8, **CPU)
    assert f.sample_rate == 44100
    start, n = 20 * 2048, 2 * 2048
    got = f.read(start, n)
    want = full[start:start + n]
    err = float(np.sum((got - want) ** 2))
    snr = 10 * np.log10((float(np.sum(want ** 2)) or 1.0) / max(err, 1e-30))
    assert snr > 60, snr
    _close(got, aacjax.AACFile(stream, chunk_frames=8).read(start, n),
           HE_ROUTE_TOL)


def test_bad_inputs():
    with pytest.raises(UnsupportedError):
        AACFile(b"no aac content here at all", **CPU)
    with pytest.raises(UnsupportedError):
        AACFile(b"\x01" * 64, cookie=b"\x12\x10", **CPU)


@pytest.mark.parametrize("profile,frame_length", [(23, 512), (39, 512),
                                                  (39, 480)])
def test_seek_ld_eld_loas(profile, frame_length):
    """Ranged reads on LD/ELD LOAS streams equal the full decode bit for
    bit (ELD's 3-segment carry needs the deeper warm-in), and aacjax's
    read within the core tolerance."""
    cfg = parse_asc(make_asc(profile, 4, 1, frame_length=frame_length))
    rng = np.random.default_rng(61)
    pays = []
    for _ in range(12):
        s = random_channel_spec(rng, cfg, window_sequence=0,
                                allow_pulse=False, allow_noise=False)
        pays.append(enc.write_eld_frame([("SCE", s)], cfg) if profile == 39
                    else enc.write_er_frame([("SCE", s)], cfg))
    loas = enc.loas_stream(pays, cfg)
    whole, _ = decode_loas(loas, **CPU)
    fl = frame_length
    clip = AACFile(loas, **CPU).read(start=6 * fl, n=3 * fl)
    np.testing.assert_array_equal(clip, whole[6 * fl:9 * fl])
    _close(clip, aacjax.AACFile(loas).read(start=6 * fl, n=3 * fl))


def test_he_aac_m4a_output_rate_timescale():
    """An HE-AAC .m4a whose mdhd timescale is the SBR output rate: priming
    and valid duration convert with the track's timescale, as in aacjax."""
    _, payloads = _he_payloads(6, seed=3)
    data = mux_m4a(payloads, make_asc(2, 7, 1, sbr=True), 44100, 1,
                   frame_length=2048, priming=2048, movie_ts=44100)
    trimmed, rate = decode_m4a(data, **CPU)
    assert rate == 44100
    f = AACFile(data, **CPU)
    j = aacjax.AACFile(data)
    assert f._timescale == j._timescale == 44100
    assert f._priming_out == j._priming_out == 2048
    assert f.total_samples == j.total_samples == trimmed.shape[0]
    assert f.duration == pytest.approx(trimmed.shape[0] / 44100)


def test_device_requests_without_cuda_raise(monkeypatch):
    _, stream = _adts_stream(n=2)
    config, payloads = _payloads(n=2)
    data = _mux(config, payloads)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AACFile(stream)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_m4a(data)


# -- Aurora facade -------------------------------------------------------------
def _aurora_stream(n_frames=12, f0=523.0):
    cfg = parse_asc(make_asc(2, 4, 2))
    t = np.arange(1024 * n_frames) / cfg.sample_rate
    x = 9000 * np.sin(2 * np.pi * f0 * t)
    return enc.encode_pcm(np.stack([x, 0.8 * x], axis=1), cfg,
                          target_sf=125), cfg


def _events(demux_cls, data):
    events = []
    d = demux_cls()
    for kind in ("format", "cookie", "data"):
        d.on(kind, lambda v, kind=kind: events.append((kind, v)))
    for off in range(0, len(data), 777):
        d.feed(data[off:off + 777])
    return events


def test_demuxer_event_order_and_fields():
    """format and cookie fire once, then data carries every byte
    unstripped; the same events as aacjax's demuxer."""
    from aacjax.aurora import ADTSDemuxer as JDemuxer
    from aacjax_torch.aurora import ADTSDemuxer
    data, _ = _aurora_stream()
    assert ADTSDemuxer.probe(data) and not ADTSDemuxer.probe(b"\x00" * 64)
    events = _events(ADTSDemuxer, data)
    kinds = [k for k, _ in events]
    assert kinds[:2] == ["format", "cookie"]
    assert kinds.count("format") == 1 and kinds.count("cookie") == 1
    assert events[0][1] == {"formatID": "aac ", "sampleRate": 44100,
                            "channelsPerFrame": 2, "floatingPoint": True}
    assert parse_asc(events[1][1]).sample_rate == 44100
    assert b"".join(b for k, b in events if k == "data") == data
    assert events == _events(JDemuxer, data)


def _pipe(mod, data, **kw):
    chunks, ended = [], []
    demux = mod.ADTSDemuxer()
    dec = demux.pipe(mod.AuroraDecoder(**kw))
    dec.on("data", chunks.append)
    dec.on("end", lambda: ended.append(True))
    for off in range(0, len(data), 1000):
        demux.feed(data[off:off + 1000])
        dec.decode_all()
    demux.end()
    assert ended
    return np.concatenate(chunks, axis=0), dec.format


def test_pipe_decodes_identically_to_decode_adts():
    """The demuxer piped into AuroraDecoder (device forwarded to the
    port's AACDecoder) gives decode_adts's PCM, and aacjax's pipe's."""
    from aacjax import aurora as j_aurora
    from aacjax_torch import aurora
    data, cfg = _aurora_stream()
    want, rate = decode_adts(data, **CPU)
    got, fmt = _pipe(aurora, data, **CPU)
    got = got.reshape(-1, cfg.channels)
    assert fmt["sampleRate"] == rate and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    ref, _ = _pipe(j_aurora, data)
    _close(got, ref.reshape(-1, cfg.channels))


def test_decoder_error_event():
    """A corrupt frame raises through readChunk with an 'error' event, or
    is concealed, as in aacjax: both packages end the same way."""
    from aacjax import aurora as j_aurora
    from aacjax_torch import aurora
    data, _ = _aurora_stream(n_frames=4)
    bad = bytearray(data)
    bad[40] ^= 0xFF
    bad[41] ^= 0xFF

    def run(mod, **kw):
        dec = mod.AuroraDecoder(**kw)
        dec.setCookie(make_asc(2, 4, 2))
        dec.feed(bytes(bad))
        errors, n = [], 0
        dec.on("error", errors.append)
        try:
            while n < 8 and dec.readChunk() is not None:
                n += 1
        except Exception as e:  # noqa: BLE001 — the reference-style throw
            assert errors and errors[-1] is e
            return n, type(e).__name__
        return n, None

    assert run(aurora, **CPU) == run(j_aurora)

