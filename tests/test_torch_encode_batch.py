"""The port's batched encoder (aacjax_torch/encode_batch.py) against
aacjax's (aacjax/encode_batch.py) on the CPU: the reference's own tests of
the batched encoder, ported, and the device programs held to the
reference's stage by stage on the same inputs.

Tolerances, stage by stage.  The analysis's matrix products, `pow`,
`exp2` and `log2` may round differently from XLA's in the last bit, and a
`floor` turns that into a one-step difference:
  - coefs within 1e-5 * max|coefs|;
  - base and fit_sf equal on at least 99.9% of (row, band) entries and
    never more than one step apart;
  - est within 1% of each row's largest estimate;
  - quantize fed the reference's own analysis outputs: q equal on at least
    99.99% of bins and never more than one step apart, sf exact;
  - the host stages fed identical inputs: identical bytes;
  - end to end: the port's stream decoded by the port within 0.5 dB SNR of
    the reference's stream decoded by the reference.
"""
import numpy as np
import pytest
import torch

import aacjax_torch
from aacjax_torch import encode_batch as TE
from aacjax_torch.testing.encoder import adts_frame

SR = 44100
CPU = torch.device("cpu")


def _stream_of(enc, chunks_out, s):
    payloads = [p for o in chunks_out for p in o[s]]
    return b"".join(adts_frame(p, enc.config) for p in payloads)


def _snr(ref, got):
    err = got[: len(ref)] - ref[: len(got)]
    n = min(len(ref), len(got))
    return 10 * np.log10((ref[:n] ** 2).mean()
                         / max((err[:n] ** 2).mean(), 1e-12))


def _tones_noise(n, seed=3):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    x = np.stack([8000 * np.sin(2 * np.pi * 440 * t),
                  8000 * np.sin(2 * np.pi * 660 * t)], axis=1)
    return x + 400 * rng.standard_normal(x.shape)


def _mixed_pcm(n_streams, n):
    t = np.arange(n) / SR
    rng = np.random.default_rng(17)
    pcm = np.empty((n_streams, n, 2), np.float32)
    for s in range(n_streams):
        x = (7000 * np.sin(2 * np.pi * (300 + 70 * s) * t)
             + 500 * rng.standard_normal(n))
        # a click per stream so short windows appear mid-run
        x[n // 2: n // 2 + 64] += 15000
        pcm[s, :, 0] = x
        pcm[s, :, 1] = 0.8 * np.roll(x, 31)
    return pcm


def _encoder(*args, **kw):
    return TE.BatchEncoder(*args, device="cpu", **kw)


# -- the reference's tests of the batched encoder, on the port ---------------
def test_roundtrip_rate_and_quality():
    """3 chunks of stereo tones + noise: the port's stream decodes through
    the port above 18 dB once the bit-estimate calibration warms, and the
    realised rate lands near the target."""
    n = 1024 * 24
    x = _tones_noise(n)
    enc = _encoder(SR, 2, 128_000, n_streams=1)
    outs = [enc.encode_chunk(x[None, i * 8192:(i + 1) * 8192])
            for i in range(3)]
    stream = _stream_of(enc, outs, 0)
    kbps = len(stream) * 8 / (n / SR) / 1000
    assert 70 < kbps < 180, kbps
    out, rate = aacjax_torch.decode_adts(stream, device="cpu")
    assert rate == SR
    ref = x[8192: out.shape[0] - 1024]
    got = (out[1024:] * 32768)[8192: 8192 + len(ref)]
    assert _snr(ref, got) > 18.0
    assert set(enc.stats) == {"h2d_s", "analysis_s", "d2h_s", "host_s",
                              "write_s", "frames"}
    assert enc.stats["frames"] == 24


def test_transients_use_short_windows():
    """A hard attack plans EIGHT_SHORT (with the legal START/STOP
    transitions around it) and still round-trips."""
    from aacjax_torch.host.bitio import BitReader
    from aacjax_torch.host.syntax import decode_frame
    n = 1024 * 8
    rng = np.random.default_rng(5)
    x = 500 * rng.standard_normal((n, 1))
    x[4000:4200] += 18000
    enc = _encoder(SR, 1, 96_000, n_streams=1)
    outs = [enc.encode_chunk(x[None])]
    seqs = [decode_frame(BitReader(p), enc.config, [0])
            .elements[0].ics.info.window_sequence for p in outs[0][0]]
    assert 2 in seqs                       # EIGHT_SHORT engaged
    i = seqs.index(2)
    if i > 0:
        assert seqs[i - 1] in (1, 2)       # legal predecessor
    out, _ = aacjax_torch.decode_adts(_stream_of(enc, outs, 0), device="cpu")
    assert np.isfinite(out).all()


def test_multistream_matches_single():
    """Encoding S streams in one batch is byte-identical to encoding each
    alone (per-stream state isolation)."""
    n = 1024 * 8
    rng = np.random.default_rng(7)
    t = np.arange(n) / SR
    pcm = np.zeros((3, n, 2))
    for s in range(3):
        f0 = 300.0 * (s + 1)
        pcm[s] = np.stack([6000 * np.sin(2 * np.pi * f0 * t),
                           6000 * np.sin(2 * np.pi * 1.5 * f0 * t)], axis=1)
        pcm[s] += 300 * rng.standard_normal((n, 2))
    batch_out = _encoder(SR, 2, 128_000, n_streams=3).encode_chunk(pcm)
    for s in range(3):
        solo = _encoder(SR, 2, 128_000, n_streams=1).encode_chunk(pcm[s][None])
        assert batch_out[s] == solo[0]


def test_chunk_boundary_window_chain():
    """An attack straddling the chunk boundary keeps the window-sequence
    chain legal across encode_chunk calls and the decode stays clean."""
    n = 1024 * 8
    rng = np.random.default_rng(9)
    x = 400 * rng.standard_normal((2 * n, 1))
    x[n - 300: n - 100] += 15000        # attack at the boundary
    enc = _encoder(SR, 1, 96_000, n_streams=1)
    outs = [enc.encode_chunk(x[None, :n]), enc.encode_chunk(x[None, n:])]
    out, _ = aacjax_torch.decode_adts(_stream_of(enc, outs, 0), device="cpu")
    assert np.isfinite(out).all()
    seg = out[n - 2048: n + 2048] * 32768
    assert np.abs(seg).max() < 32768 * 1.5


@pytest.mark.parametrize("duplex", [False, True])
def test_pipelined_matches_sequential(duplex):
    """encode_pipelined yields byte-identical payloads, in order, to
    sequential encode_chunk calls on a fresh encoder (`duplex` is accepted
    and changes nothing)."""
    S, chunk, n_chunks = 3, 4 * 1024, 4
    pcm = _mixed_pcm(S, chunk * n_chunks)
    chunks = [pcm[:, k * chunk:(k + 1) * chunk] for k in range(n_chunks)]
    seq = _encoder(SR, 2, 96_000, n_streams=S)
    want = [seq.encode_chunk(c) for c in chunks]
    pipe = _encoder(SR, 2, 96_000, n_streams=S)
    got = list(pipe.encode_pipelined(iter(chunks), duplex=duplex))
    assert len(got) == len(want)
    for k, (w, g) in enumerate(zip(want, got)):
        for s in range(S):
            assert w[s] == g[s], (k, s)
    assert np.allclose(seq._reservoir, pipe._reservoir)
    assert np.allclose(seq._est_ratio, pipe._est_ratio)
    assert pipe.stats["frames"] == seq.stats["frames"] == S * 4 * n_chunks


def test_packed_q_d2h_matches_full_width():
    """The coded-region packing (_quantize_fn w8 < 128 + host _unpack_q) is
    byte-identical to shipping the full [N, 1024] q planes."""
    S, n = 2, 1024 * 6
    pcm = _mixed_pcm(S, n)                 # clicks force short windows
    enc = _encoder(SR, 2, 96_000, n_streams=S)
    assert enc._w8 < TE.FRAME // 8         # packing actually engages
    want = enc.encode_chunk(pcm)
    full = _encoder(SR, 2, 96_000, n_streams=S)
    full._w8 = TE.FRAME // 8
    full._quantize = TE._quantize_fn(TE.FRAME // 8)
    got = full.encode_chunk(pcm)
    for s in range(S):
        assert want[s] == got[s]


def test_pipelined_single_chunk_and_empty():
    """Pipeline drain paths: zero and one chunk."""
    S = 2
    enc = _encoder(SR, 2, 96_000, n_streams=S)
    assert list(enc.encode_pipelined(iter([]))) == []
    pcm = _mixed_pcm(S, 2 * 1024)
    ref = _encoder(SR, 2, 96_000, n_streams=S).encode_chunk(pcm)
    out = list(enc.encode_pipelined(iter([pcm])))
    assert len(out) == 1
    for s in range(S):
        assert out[0][s] == ref[s]


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.BatchEncoder(SR, 2, 128_000, n_streams=1)


def test_tf32_off_when_imported_first():
    """Importing the encoder module first still switches TF32 off (the
    package's __init__ runs before any submodule)."""
    import subprocess
    import sys
    code = ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n"
            "import aacjax_torch.encode_batch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- the device programs against the reference's, stage by stage ------------
PARITY_S, PARITY_NF = 3, 6


@pytest.fixture(scope="module")
def parity():
    """One chunk through both packages' analysis and quantize on the same
    host inputs (3 stereo streams of tones, noise and attacks at 96 kbps, 6
    frames, short windows included): numpy copies of every output."""
    from aacjax import encode_batch as JE
    pcm = _mixed_pcm(PARITY_S, PARITY_NF * 1024)
    for s in range(PARITY_S):                  # attacks: short windows
        pcm[s, 2500 + 700 * s: 2700 + 700 * s] += 18000
    enc_t = _encoder(SR, 2, 96_000, n_streams=PARITY_S)
    enc_j = JE.BatchEncoder(SR, 2, 96_000, n_streams=PARITY_S)
    prep_t = enc_t._prep_chunk(pcm)
    prep_j = enc_j._prep_chunk(pcm)
    for a, b in zip(prep_t, prep_j):
        np.testing.assert_array_equal(a, b)
    seqs, pcm_i16, w_idx, is_short, nF = prep_t
    assert is_short.any() and not is_short.all()
    psy = (enc_t._psy.smr_db, enc_t._psy.spread_up_db,
           enc_t._psy.spread_down_db)
    outs_j = [np.asarray(a) for a in JE._jitted_analysis(
        enc_j._si, enc_j._cutoff_bin, JE.FRAME, nF, psy)(
            pcm_i16, w_idx, is_short)]
    outs_t = [a.numpy() for a in TE._analysis_fn(
        enc_t._si, enc_t._cutoff_bin, TE.FRAME, nF, psy, CPU)(
            torch.from_numpy(pcm_i16), torch.from_numpy(w_idx.astype(np.int64)),
            torch.from_numpy(is_short))]
    # encoders with a fresh reservoir for the tests that advance it
    fresh = lambda: (_encoder(SR, 2, 96_000, n_streams=PARITY_S),  # noqa: E731
                     JE.BatchEncoder(SR, 2, 96_000, n_streams=PARITY_S))
    return dict(fresh=fresh, JE=JE, seqs=seqs, nF=nF, is_short=is_short,
                outs_j=outs_j, outs_t=outs_t)


def test_analysis_matches_reference(parity):
    """coefs, base, fit_sf, est and bin_band of the port's analysis against
    XLA's on the same int16 PCM and plan."""
    (c_t, b_t, f_t, e_t, bb_t) = parity["outs_t"]
    (c_j, b_j, f_j, e_j, bb_j) = parity["outs_j"]
    assert c_t.shape == c_j.shape and e_t.shape == e_j.shape
    np.testing.assert_array_equal(bb_t, bb_j)
    scale = float(np.abs(c_j).max())
    assert float(np.abs(c_t - c_j).max()) <= 1e-5 * scale
    for name, got, want in (("base", b_t, b_j), ("fit_sf", f_t, f_j)):
        diff = np.abs(got - want)
        share = float((diff != 0).mean())
        print(f"{name}: {share:.6f} of entries differ, max step "
              f"{float(diff.max())}")
        assert share <= 1e-3 and float(diff.max()) <= 1.0, name
    row = np.maximum(np.abs(e_j).max(axis=1, keepdims=True), 1.0)
    assert float((np.abs(e_t - e_j) / row).max()) <= 0.01


def test_quantize_matches_reference(parity):
    """The port's quantize fed the reference's own analysis outputs at the
    same offsets: q equal on >= 99.99% of bins, never more than one step
    apart; sf exact."""
    JE, (enc_t, _) = parity["JE"], parity["fresh"]()
    c, b, f, e, bb = parity["outs_j"]
    off, _ = enc_t._rate_choice(e, parity["nF"])
    short = parity["is_short"].reshape(-1)
    q_j, sf_j = (np.asarray(a) for a in JE._jitted_quantize(
        enc_t._w8, enc_t._si, enc_t._cutoff_bin)(c, b, f, bb, off, short))
    q_t, sf_t = (a.numpy() for a in enc_t._quantize(
        *(torch.from_numpy(a.copy()) for a in (c, b, f)),
        torch.from_numpy(bb.astype(np.int64)), torch.from_numpy(off),
        torch.from_numpy(short)))
    assert q_t.dtype == np.int16 and sf_t.dtype == np.int16
    assert q_t.shape == q_j.shape and q_t.shape[1] == 8 * enc_t._w8
    np.testing.assert_array_equal(sf_t, sf_j)
    diff = np.abs(q_t.astype(np.int32) - q_j)
    share = float((diff != 0).mean())
    print(f"quantize: {share:.7f} of q differ")
    assert share <= 1e-4 and int(diff.max()) <= 1


def test_host_stages_match_reference(parity):
    """Rate choice, unpacking and the bitstream writers fed the same est
    and q: identical offsets and bytes, the native writer and the Python
    writer both."""
    enc_t, enc_j = parity["fresh"]()
    c, b, f, e, bb = parity["outs_j"]
    nF = parity["nF"]
    off_t, est_t = enc_t._rate_choice(e, nF)
    off_j, est_j = enc_j._rate_choice(e, nF)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(est_t, est_j)
    short = parity["is_short"].reshape(-1)
    q, sf = (np.asarray(a) for a in parity["JE"]._jitted_quantize(
        enc_j._w8, enc_j._si, enc_j._cutoff_bin)(c, b, f, bb, off_j, short))
    q_t = enc_t._unpack_q(q, short)
    np.testing.assert_array_equal(q_t, enc_j._unpack_q(q, short))
    q4 = q_t.reshape(PARITY_S, 2, nF, TE.FRAME)
    sf4 = sf.reshape(PARITY_S, 2, nF, -1)
    assert enc_t._native_write and enc_j._native_write
    want = enc_j._write_out(parity["seqs"], q4, sf4, est_j)
    assert enc_t._write_out(parity["seqs"], q4, sf4, est_t) == want
    py = [enc_t._write_stream(parity["seqs"][s], q4[s], sf4[s])
          for s in range(PARITY_S)]
    assert py == want


def _serving_pcm(S, n):
    """Streams 0, 56, ... of the ENC-512 traffic (aacjax_torch/bench.py's
    bench_encode): rotations of bench_encode's shared base."""
    from aacjax_torch.testing import encode_serving_pcm
    return encode_serving_pcm(57, n)[[0, 56][:S]]


@pytest.mark.parametrize("signal", ["tones_noise", "serving"])
def test_stream_matches_reference_end_to_end(signal):
    """Two chunks of 2 stereo streams through both encoders at 128 kbps:
    the port's streams decoded by the port within 0.5 dB SNR of the
    reference's decoded by the reference; the SNRs and the share of
    byte-identical frames are printed.  `serving` is the ENC-512 traffic in
    its chunks of 16 frames (about 18 dB in both packages at this rate)."""
    import aacjax
    from aacjax import encode_batch as JE
    S = 2
    if signal == "tones_noise":
        chunk = 8 * 1024
        pcm = np.stack([_tones_noise(2 * chunk, seed=s) for s in range(S)])
    else:
        chunk = 16 * 1024
        pcm = _serving_pcm(S, 2 * chunk)
    enc_t = _encoder(SR, 2, 128_000, n_streams=S)
    enc_j = JE.BatchEncoder(SR, 2, 128_000, n_streams=S)
    outs_t = [enc_t.encode_chunk(pcm[:, k * chunk:(k + 1) * chunk])
              for k in range(2)]
    outs_j = [enc_j.encode_chunk(pcm[:, k * chunk:(k + 1) * chunk])
              for k in range(2)]
    same = total = 0
    for s in range(S):
        pt = [p for o in outs_t for p in o[s]]
        pj = [p for o in outs_j for p in o[s]]
        same += sum(a == b for a, b in zip(pt, pj))
        total += len(pj)
        got, _ = aacjax_torch.decode_adts(_stream_of(enc_t, outs_t, s),
                                          device="cpu")
        want, _ = aacjax.decode_adts(_stream_of(enc_j, outs_j, s))
        # the decode lags the source by one frame; skip the first two
        # frames and the last one
        end = min(len(got), len(want)) - 1024 - 1024
        ref = pcm[s, 2048:end]
        snr_t = _snr(ref, got[1024 + 2048:1024 + end] * 32768)
        snr_j = _snr(ref, want[1024 + 2048:1024 + end] * 32768)
        print(f"{signal} stream {s}: SNR port {snr_t:.3f} dB, reference "
              f"{snr_j:.3f} dB")
        assert abs(snr_t - snr_j) <= 0.5
        if signal == "tones_noise":
            assert snr_t > 18.0
    print(f"{same} of {total} frames byte-identical")
