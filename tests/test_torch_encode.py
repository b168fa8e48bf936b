"""The port's per-stream encoders, its command line and its examples, on
the CPU.

`aacjax_torch.encode` and `aacjax_torch.encode_he` are copies of the
reference's host encoders (tests/test_torch_no_jax.py holds the source);
here they must write the reference's bytes on the same PCM.  The CLI
(`python -m aacjax_torch.cli`) is driven through `main` with --device cpu,
as tests/test_cli.py drives the reference's, and its decode is compared
with the reference CLI's on the same file (int16 within 1 LSB, the rule of
the port's int16 routes).  The four examples under aacjax_torch/examples
run by subprocess with --device cpu."""
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import aacjax
import aacjax_torch
from aacjax_torch.cli import _read_wav, _write_wav, main

REPO = pathlib.Path(__file__).resolve().parent.parent
SR = 44100


def _tone(n=SR, ch=2, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    x = 9000 * np.sin(2 * np.pi * 523 * t) + 200 * rng.standard_normal(n)
    pcm = np.stack([x, 0.8 * np.roll(x, 17)], axis=1)
    return pcm[:, :ch]


def write_wav(path, pcm, rate=SR):
    i16 = np.clip(np.round(pcm), -32768, 32767).astype("<i2")
    data = i16.tobytes()
    ch = pcm.shape[1]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                      rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.fixture()
def tone_wav(tmp_path):
    p = tmp_path / "in.wav"
    write_wav(str(p), _tone())
    return p


# -- the copied encoders write the reference's bytes --------------------------
@pytest.mark.parametrize("name,kw,method", [
    ("lc stereo, all tools", dict(), "encode"),
    ("lc mono, no tools", dict(channels=1, tns=False, pns=False,
                               intensity=False), "encode"),
    ("lc stereo 96 kbps crc", dict(bitrate=96_000), "encode_crc"),
    ("lc 960 loas", dict(frame_length=960), "encode_loas"),
    ("ld loas", dict(profile=23, pns=False), "encode_loas"),
    ("eld loas", dict(profile=39, pns=False), "encode_loas"),
])
def test_aac_encoder_matches_reference(name, kw, method):
    """AACEncoder of the port and of aacjax on the same PCM: the same
    bytes."""
    from aacjax.encode import AACEncoder as JEncoder
    pcm = _tone(SR // 4, ch=kw.get("channels", 2))
    outs = []
    for cls in (aacjax_torch.AACEncoder, JEncoder):
        e = cls(SR, **kw)
        outs.append(e.encode(pcm, crc=True) if method == "encode_crc"
                    else getattr(e, method)(pcm))
    assert len(outs[0]) > 100 and outs[0] == outs[1], name


@pytest.mark.parametrize("ps", [False, True])
def test_he_encoder_matches_reference(ps):
    """HEAACEncoder (v1, and v2 with Parametric Stereo) of the port and of
    aacjax on the same PCM: the same ADTS and .m4a bytes."""
    from aacjax.encode_he import HEAACEncoder as JHE
    pcm = _tone(SR // 4)
    got = aacjax_torch.HEAACEncoder(SR, 2, 40_000, ps=ps)
    want = JHE(SR, 2, 40_000, ps=ps)
    assert got.encode(pcm) == want.encode(pcm)
    assert got.encode_m4a(pcm) == want.encode_m4a(pcm)


def test_one_call_encoders_match_reference():
    pcm = _tone(SR // 4)
    assert aacjax_torch.encode_adts(pcm, SR) == aacjax.encode_adts(pcm, SR)
    assert aacjax_torch.encode_m4a(pcm, SR) == aacjax.encode_m4a(pcm, SR)
    assert (aacjax_torch.encode_he_adts(pcm, SR)
            == aacjax.encode_he_adts(pcm, SR))


def test_top_level_names():
    """The reference's top-level names (and BatchEncoder, which the
    reference keeps in aacjax.encode_batch), and the port's version."""
    names = ("AACDecoder", "AACEncoder", "AACFile", "BatchDecoder",
             "HEAACEncoder", "StreamConfig", "decode_adts", "decode_loas",
             "decode_m4a", "encode_adts", "encode_he_adts", "encode_m4a",
             "make_asc", "parse_asc", "probe", "probe_loas", "probe_m4a")
    for name in names:
        assert hasattr(aacjax, name), name
    for name in names + ("BatchEncoder",):
        assert hasattr(aacjax_torch, name), name
    assert aacjax_torch.__version__ == aacjax.__version__
    asc = aacjax_torch.make_asc(2, 4, 2)
    assert asc == aacjax.make_asc(2, 4, 2)
    assert aacjax_torch.parse_asc(asc).sample_rate == 44100


# -- the CLI -------------------------------------------------------------------
def test_encode_decode_adts_roundtrip(tone_wav, tmp_path, capsys):
    """encode -> probe -> decode through the port's CLI, the WAV within 1
    LSB of the reference CLI's decode of the same file."""
    from aacjax.cli import main as j_main
    aac, wav, ref = (tmp_path / n for n in ("out.aac", "out.wav", "ref.wav"))
    assert main(["encode", str(tone_wav), str(aac),
                 "--bitrate", "128000"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "adts" and abs(info["kbps"] - 128.0) < 20
    assert main(["probe", str(aac)]) == 0
    probe = json.loads(capsys.readouterr().out)
    assert probe["adts"] and probe["sample_rate"] == SR
    assert main(["decode", str(aac), str(wav), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["format"] == "wav/pcm_s16le" and out["samples"] >= SR
    assert j_main(["decode", str(aac), str(ref)]) == 0
    got, rate = _read_wav(str(wav))
    want, ref_rate = _read_wav(str(ref))
    assert rate == ref_rate == SR and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0


def test_encode_m4a_gapless(tone_wav, tmp_path, capsys):
    m4a = tmp_path / "out.m4a"
    assert main(["encode", str(tone_wav), str(m4a)]) == 0
    assert json.loads(capsys.readouterr().out)["container"] == "m4a"
    wav = tmp_path / "out.wav"
    assert main(["decode", str(m4a), str(wav), "--device", "cpu"]) == 0
    # the gapless metadata trims the encoder delay: exact sample count back
    assert json.loads(capsys.readouterr().out)["samples"] == SR


def test_encode_tool_switches(tone_wav, tmp_path, capsys):
    aac = tmp_path / "plain.aac"
    assert main(["encode", str(tone_wav), str(aac), "--no-tns",
                 "--no-pns", "--no-is"]) == 0
    capsys.readouterr()
    pcm, _ = aacjax_torch.decode_adts(aac.read_bytes(), device="cpu")
    assert np.isfinite(pcm).all()


def test_decode_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"definitely not audio" * 10)
    with pytest.raises(Exception):
        main(["decode", str(bad), str(tmp_path / "x.pcm"), "--device", "cpu"])


def test_encode_he_and_ld(tone_wav, tmp_path, capsys):
    """--he writes HE-AAC ADTS (decoded at twice the core rate) and --ld
    AAC-LD in LOAS; both decode through the port."""
    aac, loas = tmp_path / "he.aac", tmp_path / "ld.loas"
    assert main(["encode", str(tone_wav), str(aac), "--he",
                 "--bitrate", "40000"]) == 0
    assert json.loads(capsys.readouterr().out)["profile"] == "HE-AAC"
    out, rate = aacjax_torch.decode_adts(aac.read_bytes(), chunk_frames=8,
                                         device="cpu")
    assert rate == SR and out.shape[1] == 2 and np.isfinite(out).all()
    assert main(["encode", str(tone_wav), str(loas), "--ld"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "loas" and info["profile"] == "AAC-LD"
    pcm = tmp_path / "ld.pcm"
    assert main(["decode", str(loas), str(pcm), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["format"] == "float32"


def test_info_and_parity(capsys):
    """info names torch and the card (none here) and the native libraries;
    parity holds the CPU route to the float64 model decoder."""
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["version"] == aacjax_torch.__version__
    assert info["cuda_available"] is False and info["cuda_device"] is None
    assert info["native_parser"] and info["native_writer"]
    assert main(["parity", "--cases", "4", "--frames", "2", "--all-profiles",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["pass"] and out["cases"] == 4


def test_decode_on_cuda_without_cuda_fails(tone_wav, tmp_path, capsys,
                                          monkeypatch):
    aac = tmp_path / "out.aac"
    assert main(["encode", str(tone_wav), str(aac)]) == 0
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["decode", str(aac), str(tmp_path / "x.wav")])


def test_wav_helpers_roundtrip(tmp_path):
    pcm = np.arange(200, dtype=np.int16).reshape(100, 2) - 100
    path = tmp_path / "x.wav"
    _write_wav(str(path), pcm, 22050)
    got, rate = _read_wav(str(path))
    assert rate == 22050
    np.testing.assert_array_equal(got, pcm.astype(np.float64))


# -- the examples --------------------------------------------------------------
def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=timeout)
    assert r.returncode == 0, (args, r.stderr[-800:])
    return r


def test_transcode_example_chain(tone_wav, tmp_path):
    """wav -> LC adts -> HE m4a -> ELD loas -> wav, every decode on the
    CPU."""
    steps = [
        (tone_wav, tmp_path / "a.aac", []),
        (tmp_path / "a.aac", tmp_path / "b.m4a",
         ["--profile", "he", "--bitrate", "48000"]),
        (tmp_path / "b.m4a", tmp_path / "c.loas",
         ["--profile", "eld", "--bitrate", "64000"]),
        (tmp_path / "c.loas", tmp_path / "d.wav", []),
    ]
    for src, dst, extra in steps:
        _run("aacjax_torch.examples.transcode", str(src), str(dst),
             *extra, "--device", "cpu")
    assert (tmp_path / "d.wav").stat().st_size > 40000


def test_player_example(tone_wav, tmp_path):
    m4a = tmp_path / "p.m4a"
    _run("aacjax_torch.cli", "encode", str(tone_wav), str(m4a),
         "--bitrate", "96000")
    r = _run("aacjax_torch.examples.player", str(m4a), str(tmp_path / "p.wav"),
             "--start", "0.2", "--duration", "0.4", "--device", "cpu")
    assert "played 17640 samples" in r.stdout


def test_serving_example():
    r = _run("aacjax_torch.examples.serving", "--demo", "--device", "cpu")
    assert "failed streams: []" in r.stderr


def test_serving_async_example():
    """Live clients on one BatchDecoder with mid-pipeline slot recycling;
    the selftest holds each client's PCM to its solo decode."""
    r = _run("aacjax_torch.examples.serving_async", "--selftest",
             "--device", "cpu")
    assert "selftest OK" in r.stdout
