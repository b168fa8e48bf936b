"""Make the benchmark's frozen corpus: music-like stereo PCM from a fixed
seed, encoded once, offline on the CPU, by the repo's rate-controlled
encoders.

    python -m portbench.corpus.make_corpus [--workers 4]

For each configuration under portbench/configs/ whose `corpus.make`
section says how, this writes the ADTS streams (`<prefix>-NN.aac`) and a
frame table (`<config>.frames.json`: per stream one hex digit a frame,
the OR of FLAG_TNS, FLAG_SHORT and FLAG_NOT_QSF, read by the reference's
parser), then rewrites the configuration's `corpus` section with the
files' sha256 and sizes and the mean bitrate each stream reached.  Every
run from the same seeds writes the same bytes.

The configuration's `codec` names its encoder: `codecs/<codec>.py`, which
gives CODED_CHANNELS, the channels the stream codes, and `encode(pcm,
job) -> bytes`, the ADTS stream of the stereo PCM.  A later codec is a
new file there.

The PCM: per stream a tempo, a key and three voices (bass, chords, a lead
with vibrato), each note a tone with harmonics under an attack-decay
envelope; a kick, a snare and a hi-hat on the beat grid, whose onsets
make the encoder switch to short windows and use TNS where real music
would; and a low noise floor.  Stereo from per-voice panning.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import importlib.util
import json
import multiprocessing
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CONFIGS = HERE.parent / "configs"

FLAG_TNS, FLAG_SHORT, FLAG_NOT_QSF = 1, 2, 4
SR = 44100


def _note_tone(rng, f0: float, n: int, sr: int, vibrato: bool,
               n_harm: int, rolloff: float) -> np.ndarray:
    t = np.arange(n) / sr
    f = np.full(n, f0)
    if vibrato:
        f = f * (1.0 + rng.uniform(0.003, 0.006)
                 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t
                          + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f) / sr
    out = np.zeros(n)
    for k in range(1, n_harm + 1):
        if k * f0 > 0.45 * sr:
            break
        out += k ** -rolloff * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    att = min(n, max(1, int(rng.uniform(0.004, 0.03) * sr)))
    env = np.exp(-t / rng.uniform(0.4, 1.5))
    env[:att] *= np.linspace(0.0, 1.0, att)
    rel = min(n, int(0.04 * sr))
    env[n - rel:] *= np.linspace(1.0, 0.0, rel)
    return out * env


def _drum(rng, kind: str, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    if kind == "kick":
        f = 45.0 + 75.0 * np.exp(-t / 0.03)
        return np.sin(2 * np.pi * np.cumsum(f) / sr) * np.exp(-t / 0.15)
    noise = rng.standard_normal(n)
    if kind == "snare":
        hp = np.diff(noise, prepend=0.0)
        return (0.7 * hp * np.exp(-t / 0.09)
                + 0.5 * np.sin(2 * np.pi * 185.0 * t) * np.exp(-t / 0.05))
    hp = np.diff(np.diff(noise, prepend=0.0), prepend=0.0)    # hi-hat
    return 0.25 * hp * np.exp(-t / 0.025)


def music(seed: int, seconds: float, sr: int = SR) -> np.ndarray:
    """Stereo float64 PCM [n, 2] in the 32768 scale."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    out = np.zeros((n, 2))
    beat = 60.0 / rng.uniform(84.0, 140.0)
    root = int(rng.integers(40, 52))                 # MIDI note of the key
    scale = np.array([0, 2, 3, 5, 7, 8, 10] if rng.random() < 0.5
                     else [0, 2, 4, 5, 7, 9, 11])
    voices = [  # (octave offset, note lengths in beats, level, vibrato, pan)
        (0, (1.0, 2.0), 0.9, False, 0.0),
        (12, (2.0, 4.0), 0.5, False, -0.5),
        (24, (0.5, 1.0, 1.5), 0.55, True, 0.45),
    ]
    for octave, lengths, level, vib, pan in voices:
        pos = 0.0
        n_harm = int(rng.integers(6, 14))
        rolloff = rng.uniform(0.9, 1.8)
        while pos < seconds:
            dur = float(rng.choice(lengths)) * beat
            lo, hi = int(pos * sr), min(n, int((pos + dur) * sr))
            if hi - lo > 64 and rng.random() < 0.9:
                deg = int(rng.integers(0, len(scale)))
                midi = root + octave + scale[deg] + 12 * int(
                    rng.integers(0, 2) if octave else 0)
                f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
                tone = level * _note_tone(rng, f0, hi - lo, sr, vib, n_harm,
                                          rolloff)
                out[lo:hi, 0] += tone * (1.0 - pan) / 2
                out[lo:hi, 1] += tone * (1.0 + pan) / 2
            pos += dur
    step = beat / 2
    for i in range(int(seconds / step)):
        start = int(i * step * sr)
        for kind, when, level, pan in (("kick", i % 4 == 0, 1.1, 0.0),
                                       ("snare", i % 4 == 2, 0.9, 0.1),
                                       ("hat", True, 0.6, -0.3)):
            if not when:
                continue
            m = min(n - start, int(0.4 * sr))
            hit = level * rng.uniform(0.8, 1.0) * _drum(rng, kind, m, sr)
            out[start:start + m, 0] += hit * (1.0 - pan) / 2
            out[start:start + m, 1] += hit * (1.0 + pan) / 2
    floor = np.cumsum(rng.standard_normal((n, 2)), axis=0)
    floor -= np.convolve(floor[:, 0], np.ones(64) / 64, "same")[:, None]
    out += 0.004 * floor / (np.abs(floor).max() + 1e-9)
    peak = 32768.0 * 10 ** (-rng.uniform(1.0, 6.0) / 20.0)
    return out * (peak / np.abs(out).max())


def frame_flags(data: bytes, sample_index: int, channels: int) -> str:
    """One hex digit a frame of a stream of `channels` coded channels
    (its codec's CODED_CHANNELS): FLAG_TNS where a channel carries TNS,
    FLAG_SHORT where one has eight short windows, FLAG_NOT_QSF where one
    uses M/S, PNS or intensity stereo (the frames whose spectra the
    program cannot send as raw quantized values)."""
    from portbench.corpus import adts_payloads
    from portbench.reference import asc
    from portbench.reference.bitio import BitReader
    from portbench.reference.syntax import CPEData, SCEData, decode_frame
    config = asc.stream_config(2, sample_index, channels)
    prev = [0] * channels
    digits = []
    for payload in adts_payloads(data):
        frame = decode_frame(BitReader(payload), config, prev)
        flags, ch = 0, 0
        for elem in frame.elements:
            if isinstance(elem, SCEData):
                chans = [elem.ics]
            elif isinstance(elem, CPEData):
                chans = [elem.left, elem.right]
                if elem.mask_present:
                    flags |= FLAG_NOT_QSF
            else:
                continue
            for cs in chans:
                prev[ch] = cs.info.window_shape
                ch += 1
                if cs.tns_present:
                    flags |= FLAG_TNS
                if cs.info.window_sequence == 2:
                    flags |= FLAG_SHORT
                if (cs.band_types >= 13).any():
                    flags |= FLAG_NOT_QSF
        digits.append(f"{flags:x}")
    return "".join(digits)


def codec(name: str):
    """The encoder module of codec `name` (codecs/<name>.py)."""
    path = HERE / "codecs" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no codec module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.corpus.codecs.{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encode_one(job: dict) -> dict:
    """Encode one stream (a worker's unit) into the directory `out`;
    returns its file's facts."""
    sys.path.insert(0, str(ROOT))
    pcm = music(job["seed"], job["seconds"])
    enc = codec(job["codec"])
    data = enc.encode(pcm, job)
    path = pathlib.Path(job["out"]) / job["file"]
    path.write_bytes(data)
    from portbench.corpus import adts_payloads
    n_frames = len(adts_payloads(data))
    return dict(file=f"portbench/corpus/{job['file']}",
                sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
                frames=n_frames, seed=job["seed"],
                kbps=round(len(data) * 8 / job["seconds"] / 1000, 2),
                flags=frame_flags(data, job["sample_index"],
                                  enc.CODED_CHANNELS))


def make(config_name: str, workers: int, out: pathlib.Path | None = None,
         streams: int | None = None) -> dict:
    """Make the corpus of configuration `config_name` and return the
    configuration with its `corpus` section rewritten.  Into
    portbench/corpus/, rewriting the configuration's file, by default;
    with `out`, its first `streams` streams, their frame table and the
    rewritten configuration go into that directory instead."""
    cpath = CONFIGS / f"{config_name}.json"
    cfg = json.loads(cpath.read_text())
    mk = cfg["corpus"]["make"]
    dest = HERE if out is None else pathlib.Path(out)
    jobs = [dict(codec=cfg["codec"], bitrate=cfg["bitrate_bps"],
                 seconds=mk["seconds"], seed=mk["seed"] + i,
                 file=f"{mk['prefix']}-{i:02d}.aac", out=str(dest),
                 sample_rate=SR, sample_index=cfg["sample_index"],
                 pns=mk.get("pns", True), intensity=mk.get("intensity", True))
            for i in range(mk["streams"] if streams is None else streams)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        files = list(pool.map(encode_one, jobs))
    frames = {f["file"]: f.pop("flags") for f in files}
    table = dest / f"{config_name}.frames.json"
    table.write_text(json.dumps(frames, indent=0) + "\n")
    kbps = [f["kbps"] for f in files]
    cfg["corpus"].update(
        files=files,
        frames_file=f"portbench/corpus/{table.name}",
        frames_sha256=hashlib.sha256(table.read_bytes()).hexdigest(),
        mean_kbps=round(float(np.mean(kbps)), 2),
        kbps_range=[min(kbps), max(kbps)])
    (cpath if out is None else dest / cpath.name).write_text(
        json.dumps(cfg, indent=2) + "\n")
    print(f"{config_name}: {len(files)} streams, mean {np.mean(kbps):.2f} "
          f"kbps ({min(kbps)}-{max(kbps)}), "
          f"{sum(f['bytes'] for f in files)} bytes")
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.corpus.make_corpus")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    for cpath in sorted(CONFIGS.glob("*.json")):
        if "make" in json.loads(cpath.read_text()).get("corpus", {}):
            make(cpath.stem, args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
