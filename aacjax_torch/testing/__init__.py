"""Test inputs for the port's checks (the CPU tests, the card tests and
chip_smoke.py): numpy-seeded kernel inputs, and streams built with the
port's copy of the test encoder (`aacjax_torch.testing.encoder`).
Everything here is numpy, so the JAX reference and the port can be fed the
same arrays."""
from __future__ import annotations

import numpy as np

from aacjax_torch.host import adts
from aacjax_torch.host.asc import StreamConfig, make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import random_cpe_spec

SR = 44100
FRAME = 1024

def assert_pcm_close(pcm, ref, out_int16: bool, what: str = "") -> float:
    """Hold PCM to the reference's tolerance for its Pallas tail
    (tests/test_pallas_tail.py): int16 within 1 LSB with fewer than 2% of
    samples differing (matmul rounding can flip a round() at .5); f32
    within 5e-5 * max(1, max|ref|).  Takes numpy arrays or CPU tensors.
    Returns max |pcm - ref|; raises AssertionError past the bound."""
    pcm, ref = np.asarray(pcm), np.asarray(ref)
    if pcm.shape != ref.shape or pcm.dtype != ref.dtype:
        raise AssertionError(f"{what}: {pcm.dtype}{pcm.shape} vs reference "
                             f"{ref.dtype}{ref.shape}")
    if not np.isfinite(pcm).all():
        raise AssertionError(f"{what}: non-finite output")
    d = np.abs(pcm.astype(np.float64) - ref.astype(np.float64))
    if out_int16:
        ok = d.max() <= 1 and (d > 0).mean() < 0.02
        bound = "1 LSB, < 2% of samples"
    else:
        tol = 5e-5 * max(1.0, float(np.abs(ref).max()))
        ok = d.max() <= tol
        bound = f"{tol}"
    if not ok:
        raise AssertionError(f"{what}: max |delta| {d.max()} "
                             f"({(d > 0).mean():.4f} of samples differ), "
                             f"bound {bound}")
    return float(d.max())


# the argument order of tail.decode_tail (overlap_in last)
TAIL_ARGS = ("spec", "spec_scale", "f_idx", "s_idx", "shape_idx",
             "prev_shape_idx", "is_short", "valid", "last_valid", "overlap")


def random_tail_chunk(seed: int, C: int, T: int, *, i16: bool,
                      has_short: bool = True, ragged: bool = True,
                      amp: float = 300.0) -> dict[str, np.ndarray | None]:
    """A random [C, T, 1024] chunk for the decode tail, as
    tests/test_pallas_tail.py builds one: all four window sequences
    (EIGHT_SHORT only with has_short), random window shapes.  ragged gives
    each channel a random count of valid frames, channel 0 none
    (last_valid = -1) and channel 1 all of them.  i16 block-scales the
    spectra to int16 with per-16-bin scales (spec_scale None otherwise)."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((C, T, FRAME)).astype(np.float32) * amp
    seq = rng.integers(0, 4, (C, T)).astype(np.int32)
    if not has_short:
        seq = np.where(seq == 2, 0, seq)
    shape = rng.integers(0, 2, (C, T)).astype(np.int32)
    prev = rng.integers(0, 2, (C, T)).astype(np.int32)
    nval = rng.integers(0, T + 1, C) if ragged else np.full(C, T)
    if ragged:
        nval[0] = 0
        nval[1 % C] = T
    b = dict(f_idx=seq * 2 + prev, s_idx=seq * 2 + shape, shape_idx=shape,
             prev_shape_idx=prev, is_short=(seq == 2).astype(np.int32),
             valid=(np.arange(T)[None, :] < nval[:, None]).astype(np.int32),
             last_valid=(nval - 1).astype(np.int32), spec=spec,
             spec_scale=None)
    if i16:
        b["spec"], b["spec_scale"] = block_scale_i16(spec)
    b["overlap"] = (rng.standard_normal((C, FRAME)) * amp / 3).astype(
        np.float32)
    return b


def block_scale_i16(spec: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Block-scale f32 spectra [C, T, 1024] to the compact form: int16
    [C, T, 1024] and one f32 scale per 16 bins [C, T, 64]."""
    C, T, _ = spec.shape
    blocks = spec.reshape(C, T, FRAME // 16, 16)
    sc = np.maximum(np.abs(blocks).max(axis=-1) / 32767.0,
                    1e-30).astype(np.float32)
    q = np.clip(np.round(blocks / sc[..., None]), -32768,
                32767).astype(np.int16).reshape(C, T, FRAME)
    return q, sc


def random_synth_batch(seed: int, B: int) -> tuple[np.ndarray, ...]:
    """Arguments of synth.synthesis for B rows (B >= 4) of all four window
    sequences: (spec, f_idx, s_idx, shape_idx, prev_shape_idx, is_short)."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((B, FRAME)).astype(np.float32) * 100
    seq = rng.integers(0, 4, B).astype(np.int32)
    seq[:4] = [0, 1, 2, 3]
    shape = rng.integers(0, 2, B).astype(np.int32)
    prev = rng.integers(0, 2, B).astype(np.int32)
    return (spec, seq * 2 + prev, seq * 2 + shape, shape, prev,
            (seq == 2).astype(np.int32))


def _lpc_from_reflection(k: np.ndarray) -> np.ndarray:
    """Levinson step-up: reflection coefficients -> AR taps.  |k| < 1
    gives a stable all-pole filter."""
    a = np.zeros(0)
    for m, km in enumerate(k):
        a = np.concatenate([a + km * a[::-1], [km]]) if m else np.array([km])
    return a


TNS_KINDS = ((2, 0.7), (12, 0.95), (20, 0.9))


def random_tns_chunk(seed: int, C: int, T: int,
                     kinds=TNS_KINDS) -> tuple[np.ndarray, ...]:
    """Arguments of tns.tns: (x, fwd_lpc, fwd_start, fwd_end, rev_lpc,
    rev_start, rev_end), contiguous.  Each row and direction has two
    disjoint filters, the first starting at bin 0 and the second ending at
    bin 1024, of one (order, max |reflection coefficient|) kind from
    `kinds`, taken in turn: stable order-2 (+-0.7), and high-gain order-12
    (+-0.95) and order-20 (+-0.9) "torture" filters."""
    rng = np.random.default_rng(seed)
    lpc = np.zeros((C, T, 2, 8, 20), np.float32)
    rngs = np.zeros((C, T, 2, 8, 2), np.int32)
    for c in range(C):
        for t in range(T):
            for d in range(2):
                order, kmax = kinds[(c * T + t + d) % len(kinds)]
                cut = int(rng.integers(200, 800))
                regions = [(0, cut), (cut + int(rng.integers(0, 40)), FRAME)]
                for s, (lo, hi) in enumerate(regions):
                    k = rng.uniform(-kmax, kmax, order)
                    lpc[c, t, d, s, :order] = _lpc_from_reflection(k)
                    rngs[c, t, d, s] = (lo, hi)
    x = (rng.standard_normal((C, T, FRAME)) * 1000).astype(np.float32)
    return tuple(np.ascontiguousarray(a) for a in (
        x, lpc[:, :, 0], rngs[:, :, 0, :, 0], rngs[:, :, 0, :, 1],
        lpc[:, :, 1], rngs[:, :, 1, :, 0], rngs[:, :, 1, :, 1]))


TNS_SERVING_TOP = 736     # bin of band 42, the 44.1 kHz long-window TNS limit


def serving_tns_chunk(seed: int, C: int, T: int) -> tuple[np.ndarray, ...]:
    """Arguments of tns.tns_packed with a filter mix like a serving chunk's:
    (spec_i16 [C,T,1024], spec_scale [C,T,64], tns_lpc [C,T,2,8,20],
    tns_range [C,T,2,8,2]), as the native parser packs them (the reverse
    bank's ranges in flipped coordinates, start' = 1024 - end).

    40% of the rows carry TNS.  Such a row has 1, 2 or 3 filters that tile
    a run of bins inside [0, 736) without overlap (boundaries on multiples
    of 4, as band offsets are); each filter has an order drawn from 1..12,
    reflection coefficients uniform in [-0.9, 0.9] and one random direction,
    and takes the next free slot of its direction's bank.  Every other slot
    is empty (start = end = 0, lpc = 0)."""
    rng = np.random.default_rng(seed)
    lpc = np.zeros((C, T, 2, 8, 20), np.float32)
    rngs = np.zeros((C, T, 2, 8, 2), np.int32)
    grid = np.arange(0, TNS_SERVING_TOP + 1, 4)
    for c, t in np.argwhere(rng.random((C, T)) < 0.4):
        n_filt = int(rng.integers(1, 4))
        cuts = np.sort(rng.choice(grid, n_filt + 1, replace=False))
        used = [0, 0]
        for i in range(n_filt):
            order = int(rng.integers(1, 13))
            d = int(rng.integers(0, 2))
            lo, hi = int(cuts[i]), int(cuts[i + 1])
            lpc[c, t, d, used[d], :order] = _lpc_from_reflection(
                rng.uniform(-0.9, 0.9, order))
            rngs[c, t, d, used[d]] = (FRAME - hi, FRAME - lo) if d else (lo, hi)
            used[d] += 1
    x = (rng.standard_normal((C, T, FRAME)) * 1000).astype(np.float32)
    return (*block_scale_i16(x), lpc, rngs)


def overlap_tns_chunk(seed: int = 8) -> tuple[np.ndarray, ...]:
    """Arguments of tns.tns_packed for one channel of three frames whose
    forward filters (order 3 over bins [10, 300), order 9 over [301, 1024))
    meet reverse ranges: frame 0 an order-5 reverse filter over bins
    [200, 400) (it wins there), frame 1 a reverse range [650, 700) with no
    taps (it still claims its bins: they pass through), frame 2 a reverse
    range with no taps over every bin (the whole frame passes through)."""
    q, sc = block_scale_i16(np.random.default_rng(seed).standard_normal(
        (1, 3, FRAME)).astype(np.float32) * 1000)
    lpc = np.zeros((1, 3, 2, 8, 20), np.float32)
    rngs = np.zeros((1, 3, 2, 8, 2), np.int32)
    lpc[0, :, 0, 0, :3] = (0.6, -0.3, 0.1)
    lpc[0, :, 0, 1, :9] = np.linspace(0.4, -0.4, 9)
    lpc[0, 0, 1, 0, :5] = (0.5, 0.2, -0.2, 0.1, 0.05)
    rngs[0, :, 0, 0] = (10, 300)
    rngs[0, :, 0, 1] = (301, FRAME)
    rngs[0, 0, 1, 0] = (FRAME - 400, FRAME - 200)
    rngs[0, 1, 1, 0] = (FRAME - 700, FRAME - 650)
    rngs[0, 2, 1, 0] = (0, FRAME)
    return q, sc, lpc, rngs


def lc_stereo_config() -> StreamConfig:
    """AAC-LC, 44.1 kHz, stereo."""
    return parse_asc(make_asc(2, 4, 2))


def tns_short_adts(n_frames: int = 12, seed: int = 0) -> bytes:
    """An AAC-LC stereo 44.1 kHz ADTS stream of random legal CPE frames
    (M/S, window switching incl. EIGHT_SHORT, TNS in both directions)."""
    rng = np.random.default_rng(seed)
    config = lc_stereo_config()
    out = []
    for _ in range(n_frames):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, config, common=True), config)
        out.append(enc.adts_frame(enc.end_frame(w), config))
    return b"".join(out)


def tns_serving_corpus(n_unique: int = 4, n_frames: int = 48):
    """A serving corpus whose chunks carry TNS: n_unique AAC-LC stereo
    44.1 kHz streams of n_frames random legal CPE frames each
    (`tns_short_adts`, seeds 0..n_unique-1: M/S, all four window sequences,
    about 40% of the channel-frames with TNS in either direction, order
    <= 12 on long and <= 7 on short windows).  The audio is synthetic noise
    with gains up to 2^20, so most of its PCM is far outside the int16
    range.  Returns (config, list of ADTS streams)."""
    return lc_stereo_config(), [tns_short_adts(n_frames, seed=i)
                                for i in range(n_unique)]


def tone_pcm(n: int, seed: int = 0) -> np.ndarray:
    """Stereo test signal [n, 2] in the 32768 scale: two tones + noise."""
    t = np.arange(n) / SR
    x = (8000 * np.sin(2 * np.pi * 440 * t)
         + 3000 * np.sin(2 * np.pi * 1850 * t)
         + 400 * np.random.default_rng(seed).standard_normal(n))
    return np.stack([x, np.roll(x, 100) * 0.8], axis=1)


def encode_adts(pcm: np.ndarray, target_sf: int) -> bytes:
    """AAC-LC 44.1 kHz ADTS of pcm [n, channels] (mono or stereo)."""
    config = parse_asc(make_asc(2, 4, pcm.shape[1]))
    return enc.encode_pcm(pcm, config, target_sf=target_sf)


def make_corpus(n_unique: int, seconds: float, sr: int = 44100):
    """Encode n_unique distinct stereo streams with realistic content
    (tones + noise with per-stream character): the corpus of the
    reference's headline benchmark (`bench.py` `make_corpus`), with the
    same seeds and arithmetic.  Returns (config, list of ADTS streams)."""
    config = parse_asc(make_asc(2, 4, 2))
    n = int(seconds * sr) // 1024 * 1024
    t = np.arange(n) / sr
    streams = []
    for i in range(n_unique):
        rng = np.random.default_rng(1000 + i)
        f0 = 200.0 * (1.3 ** i)
        x = (7000 * np.sin(2 * np.pi * f0 * t)
             + 2500 * np.sin(2 * np.pi * 2.7 * f0 * t + 0.3)
             + 900 * rng.standard_normal(n))
        pcm = np.stack([x, np.roll(x, 64) * 0.85], axis=1)
        # target_sf=146 lands around 500-700 bytes/frame (~200 kbps stereo),
        # the realistic high-quality streaming operating point
        streams.append(enc.encode_pcm(pcm, config, target_sf=146))
    return config, streams


def adts_payloads(data: bytes) -> list[bytes]:
    """The raw_data_block payloads of an ADTS stream."""
    return [data[s:e] for _, s, e in adts.split_frames(data)]
