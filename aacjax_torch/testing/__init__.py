"""Test inputs for the port's checks (the CPU tests, the card tests and
scripts/kernel_times.py): numpy-seeded kernel inputs, streams built with the
port's copy of the test encoder (`aacjax_torch.testing.encoder`), and the
tolerances of the HE routes on the card (HE_ROUTE_TOL, HE_I16_ONSET /
HE_I16_STEADY).
Everything here is numpy, so the JAX reference and the port can be fed the
same arrays."""
from __future__ import annotations

import numpy as np

from aacjax_torch.host import adts
from aacjax_torch.host.asc import StreamConfig, make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import (random_channel_spec,
                                          random_cpe_spec)

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


def pred_chunk(seed: int, C: int, T: int, F: int = FRAME
               ) -> tuple[np.ndarray, ...]:
    """Arguments of pred.apply_prediction but the state: (spec f32
    [C,T,F], mode, reset, nbins int32 [C,T], used uint8 [C,T,672]) with
    every mode (0 none, 1 long, 2 short; long the most frequent), reset
    groups on a third of the frames, nbins at and below 672 and `used` set
    in runs of 16 bins on half of them."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((C, T, F)) * 300).astype(np.float32)
    mode = rng.choice([0, 1, 1, 1, 1, 2], size=(C, T)).astype(np.int32)
    reset = np.where(rng.random((C, T)) < 0.33,
                     rng.integers(1, 31, (C, T)), 0).astype(np.int32)
    nbins = rng.choice([672, 672, 640, 100], size=(C, T)).astype(np.int32)
    used = np.repeat(rng.random((C, T, 42)) < 0.5, 16,
                     axis=-1).astype(np.uint8)
    return spec, mode, reset, nbins, used


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


# -- streams of the profiles and tools beyond the LC serving path ---------------
def window_chain(rng, n: int, p_short: float = 0.12) -> list[int]:
    """A legal window-sequence chain of n frames: mostly ONLY_LONG, with
    runs of EIGHT_SHORT entered through LONG_START and left through
    LONG_STOP."""
    seqs, cur = [], 0
    for _ in range(n):
        seqs.append(cur)
        if cur in (0, 3):
            cur = 1 if rng.random() < p_short else 0
        else:                               # LONG_START or EIGHT_SHORT
            cur = 2 if rng.random() < 0.5 else 3
    return seqs


def main_config(channels: int = 2) -> StreamConfig:
    """AAC Main, 44.1 kHz."""
    return parse_asc(make_asc(1, 4, channels))


def main_stereo_payloads(n_frames: int, seed: int, intensity: bool = False,
                         tns: bool = True) -> list[bytes]:
    """raw_data_blocks of a Main-profile stereo stream: random legal CPE
    frames with a common window, M/S, prediction_used bits on the long
    frames (max_sfb 42), a predictor reset group on every fifth frame,
    runs of EIGHT_SHORT frames (which reset the predictor) and TNS on about
    half of the channel-frames.  No PNS and no pulse data.  With
    `intensity` the right channel's first band is intensity-coded, which
    the native parser delegates to the python parser and packer."""
    rng = np.random.default_rng(seed)
    cfg = main_config(2)
    out = []
    for f, seq in enumerate(window_chain(rng, n_frames)):
        kw = dict(window_sequence=seq, allow_pulse=False, allow_noise=False,
                  allow_tns=tns)
        if seq != 2:
            kw["max_sfb"] = 42
        left = random_channel_spec(rng, cfg, **kw)
        right = random_channel_spec(
            rng, cfg, **{**kw, "max_sfb": left.max_sfb},
            grouping=left.grouping, window_shape=left.window_shape)
        if seq != 2:
            n = min(left.max_sfb, cfg.pred_sfb_max)
            for ch in (left, right):
                ch.pred_used = rng.integers(0, 2, n) > 0
                ch.pred_reset_group = (f % 30) + 1 if f % 5 == 4 else 0
        if intensity:
            right.band_books[0] = enc.INTENSITY
            right.band_sf[0] = 0
            right.quant[:int(cfg.swb_offsets_long[1])] = 0
        ms_type = 0 if intensity else int(rng.integers(0, 3))
        n_idx = left.group_count * left.max_sfb
        ms_used = ((rng.random(n_idx) < 0.5).astype(np.int64)
                   if ms_type == 1 else None)
        w = BitWriter()
        enc.write_cpe(w, enc.CPESpec(left=left, right=right,
                                     common_window=True, ms_type=ms_type,
                                     ms_used=ms_used), cfg)
        out.append(enc.end_frame(w))
    return out


def main_stereo_adts(n_frames: int, seed: int, **kw) -> bytes:
    cfg = main_config(2)
    return b"".join(enc.adts_frame(p, cfg)
                    for p in main_stereo_payloads(n_frames, seed, **kw))


def main_serving_corpus(n_unique: int = 4, n_frames: int = 48):
    """A serving corpus of Main-profile stereo streams
    (`main_stereo_payloads`, seeds 0..n_unique-1, no intensity).  Like the
    TNS corpus its audio is synthetic noise far outside the int16 range.
    Returns (config, list of payload lists)."""
    return main_config(2), [main_stereo_payloads(n_frames, seed=i)
                            for i in range(n_unique)]


def _coupling_element(rng, config, point: int, targets, instance: int = 0):
    """A CCE over long windows: dependent BEFORE_TNS (0) / AFTER_TNS (1)
    with per-band gain deltas, or independent AFTER_IMDCT (2)."""
    ics = random_channel_spec(rng, config, window_sequence=0, allow_tns=False,
                              allow_noise=False, allow_pulse=False)
    n_coded = int(np.count_nonzero(ics.band_books))
    n_lists = sum(2 if (pair and sel == 3) else 1
                  for pair, _, sel in targets) - 1
    lists = [(0 if point != 2 else 1, 3,
              [int(rng.integers(-3, 4)) for _ in range(n_coded)])
             for _ in range(n_lists)]
    return enc.CCESpec(ics=ics, coupling_point=point, targets=targets,
                       sign=int(rng.integers(2)), scale_idx=1,
                       gain_lists=lists), instance


def _tns_cpe(rng, config):
    """A common-window CPE whose two channels both carry TNS, no M/S."""
    left = random_channel_spec(rng, config, force_tns=True, allow_pulse=False)
    right = random_channel_spec(
        rng, config, window_sequence=left.window_sequence,
        grouping=left.grouping, max_sfb=left.max_sfb,
        window_shape=left.window_shape, force_tns=True, allow_pulse=False)
    return enc.CPESpec(left=left, right=right, common_window=True, ms_type=0,
                       ms_used=np.zeros(128, bool))


def cce_stereo_payloads(n_frames: int, seed: int, point: int,
                        target_tns: bool = False) -> list[bytes]:
    """AAC-LC stereo frames, each a CPE (with TNS on both channels when
    `target_tns`) followed by one CCE at `point` coupled onto both channels
    with separate gains.  AFTER_TNS onto TNS'd targets and AFTER_IMDCT
    reach the device as coupling entries; the rest the native parser fuses
    on the host."""
    rng = np.random.default_rng(seed)
    config = lc_stereo_config()
    out = []
    for _ in range(n_frames):
        w = BitWriter()
        cpe = (_tns_cpe(rng, config) if target_tns
               else random_cpe_spec(rng, config, common=True))
        enc.write_cpe(w, cpe, config, instance=0)
        spec, inst = _coupling_element(rng, config, point, [(1, 0, 3)])
        enc.write_cce(w, spec, config, instance=inst)
        out.append(enc.end_frame(w))
    return out


# element layouts of the multichannel configurations (ISO/IEC 14496-3
# Table 1.19): 5.1 and 7.1
MC_LAYOUTS = {
    6: [("SCE", 0), ("CPE", 0), ("CPE", 1), ("LFE", 0)],
    7: [("SCE", 0), ("CPE", 0), ("CPE", 1), ("CPE", 2), ("LFE", 0)],
}


def multichannel_payloads(chan_config: int, n_frames: int, seed: int,
                          coupling: bool = False) -> list[bytes]:
    """AAC-LC 48 kHz frames of channel configuration 6 (5.1) or 7 (7.1),
    long windows.  With `coupling` the first CPE carries TNS on both
    channels and each frame ends with two coupling elements: a dependent
    AFTER_TNS one onto that CPE (a device entry per target, since the
    targets carry TNS) and an independent AFTER_IMDCT one onto the centre
    channel (coupled in the time domain through its own slot)."""
    rng = np.random.default_rng(seed)
    cfg = parse_asc(make_asc(2, 3, chan_config))
    out = []
    for _ in range(n_frames):
        w = BitWriter()
        for kind, inst in MC_LAYOUTS[chan_config]:
            if kind != "CPE":
                s = random_channel_spec(rng, cfg, window_sequence=0,
                                        allow_pulse=False, allow_noise=False)
                enc.write_sce(w, s, cfg, instance=inst, lfe=kind == "LFE")
            elif coupling and inst == 0:
                enc.write_cpe(w, _tns_cpe(rng, cfg), cfg, instance=inst)
            else:
                left = random_channel_spec(rng, cfg, window_sequence=0,
                                           allow_pulse=False,
                                           allow_noise=False)
                right = random_channel_spec(
                    rng, cfg, window_sequence=0, max_sfb=left.max_sfb,
                    window_shape=left.window_shape, allow_pulse=False,
                    allow_noise=False)
                enc.write_cpe(w, enc.CPESpec(left=left, right=right,
                                             common_window=True, ms_type=0),
                              cfg, instance=inst)
        if coupling:
            for i, (point, targets) in enumerate(((1, [(1, 0, 3)]),
                                                  (2, [(0, 0, 0)]))):
                spec, _ = _coupling_element(rng, cfg, point, targets)
                enc.write_cce(w, spec, cfg, instance=i)
        out.append(enc.end_frame(w))
    return out


def multichannel_config(chan_config: int) -> StreamConfig:
    return parse_asc(make_asc(2, 3, chan_config))


def er_config(profile: int, frame_length: int, channels: int = 1
              ) -> StreamConfig:
    """ER AAC-LC (17), AAC-LD (23) or AAC-ELD (39) at 44.1 kHz."""
    return parse_asc(make_asc(profile, 4, channels,
                              frame_length=frame_length))


def er_payloads(cfg: StreamConfig, n_frames: int, seed: int) -> list[bytes]:
    """raw_data_blocks of an ER-LC, LD or ELD stream (long windows, no PNS,
    no pulse data): SCE frames for a mono config, common-window CPE frames
    with M/S and intensity for a stereo one."""
    rng = np.random.default_rng(seed)
    write = enc.write_eld_frame if cfg.profile == 39 else enc.write_er_frame
    kw = dict(window_sequence=0, allow_pulse=False, allow_noise=False)
    out = []
    for _ in range(n_frames):
        if cfg.channels == 1:
            out.append(write([("SCE", random_channel_spec(rng, cfg, **kw))],
                             cfg))
            continue
        left = random_channel_spec(rng, cfg, **kw)
        right = random_channel_spec(rng, cfg, max_sfb=left.max_sfb,
                                    window_shape=left.window_shape,
                                    allow_intensity=True, **kw)
        ms_type = int(rng.integers(0, 3))
        ms_used = ((rng.random(left.max_sfb) < 0.5).astype(np.int64)
                   if ms_type == 1 else None)
        out.append(write([("CPE", enc.CPESpec(
            left=left, right=right, common_window=True, ms_type=ms_type,
            ms_used=ms_used))], cfg))
    return out


def ltp_adts(n_frames: int, seed: int, channels: int = 1, tns: bool = False,
             short_frames=()) -> bytes:
    """An AAC-LTP 44.1 kHz ADTS stream: long frames carry ltp_data (lag,
    coefficient, per-band bits) from the second frame on; `short_frames`
    are EIGHT_SHORT, entered and left through LONG_START / LONG_STOP; with
    `tns` the long frames carry TNS.  Stereo frames are common-window CPEs
    with M/S whose right channel opts out of LTP on some frames."""
    rng = np.random.default_rng(seed)
    cfg = parse_asc(make_asc(4, 4, channels))
    out = []
    for f in range(n_frames):
        short = f in short_frames
        seq = (2 if short else 1 if f + 1 in short_frames
               else 3 if f - 1 in short_frames else 0)
        chs = []
        for _ in range(channels):
            s = random_channel_spec(
                rng, cfg, window_sequence=seq, allow_tns=False,
                force_tns=tns and not short, allow_noise=False,
                allow_pulse=False,
                **(dict(grouping=chs[0].grouping, max_sfb=chs[0].max_sfb)
                   if chs else {} if short else dict(max_sfb=42)))
            if f >= 1 and not short:
                s.ltp_lag = int(rng.integers(64, 2048))
                s.ltp_coef_idx = int(rng.integers(8))
                s.ltp_used = rng.integers(0, 2, 40) > 0
            chs.append(s)
        w = BitWriter()
        if channels == 1:
            enc.write_sce(w, chs[0], cfg, instance=0)
        else:
            chs[1].window_shape = chs[0].window_shape
            if f >= 1 and f % 2 == 0:
                chs[1].ltp_lag = None
            enc.write_cpe(w, enc.CPESpec(
                left=chs[0], right=chs[1], common_window=True, ms_type=1,
                ms_used=rng.integers(0, 2, 128).astype(bool)), cfg,
                instance=0)
        out.append(enc.adts_frame(enc.end_frame(w), cfg))
    return b"".join(out)


def multi_rdb_adts(n_blocks: int = 9, crc: bool = False, seed: int = 0
                   ) -> bytes:
    """An AAC-LC stereo ADTS stream whose frames carry three
    raw_data_blocks each (encoded tones), with the per-block crc_check
    layout when `crc`."""
    cfg = lc_stereo_config()
    payloads = enc.encode_pcm_frames(tone_pcm(FRAME * n_blocks, seed), cfg,
                                     target_sf=140)[:n_blocks]
    return b"".join(enc.adts_frame_multi(payloads[i:i + 3], cfg, crc=crc)
                    for i in range(0, len(payloads), 3))


# -- HE-AAC v1 -------------------------------------------------------------
# Whole HE decodes on the card against the CPU, f32 within HE_ROUTE_TOL *
# max(1, max|ref|): their cores differ by the kernels' FFT IMDCT against the
# plain versions' dense product (agreeing to 5e-5 * max(1, max|ref|) in the
# PCM, far less in practice), and the SBR program's envelope gains divide by
# the patched bands' energies, which amplifies that.
HE_ROUTE_TOL = 1e-3
# HE int16 PCM through the kernel route's core (the tail kernel, FFT IMDCT)
# against the plain route's (the dense IMDCT), both through the same SBR
# (and PS) program.  The cores differ by float rounding (~5e-7 of full
# scale); the SBR program amplifies that in the first two frames of a
# stream, where the covariance LPC of the patch source bands is solved over
# a window that still holds the zeroed start-up history and the quiet
# onset: a near-singular 2x2 system.  tests/test_torch_he_bound.py measures
# it on the CPU over 2 stereo streams x 4 frames of HE-512's traffic, with
# the port's numpy model of the kernel's FFT against its dense IMDCT: frames
# 0-1 differ by 4 LSB on 12.0% of their samples (low-passed as bench_he
# builds it) and 5 LSB on 16.8% (the same noise unfiltered), frames 2-3 by
# 1 LSB on 0.15% and 0.23%; the reference's SBR program fed the same two
# cores gives 4 LSB on 12.1% / 1 on 0.18% and 5 on 16.8% / 1 on 0.21%, so
# the growth is the SBR math's, in both packages (the two SBR programs on
# one core agree within 1 LSB on <= 0.15%).  Hence the bound per frame of a
# stream: frames 0 and 1 within HE_I16_ONSET (max LSB, share of their
# samples; 8 and 0.40 leave a margin over the measured 5 and 0.168), later
# frames the North-star rule HE_I16_STEADY.
HE_ONSET_FRAMES = 2
HE_I16_ONSET = (8, 0.40)
HE_I16_STEADY = (1, 0.02)


def he_i16_stats(pairs) -> dict:
    """HE int16 PCM of one route against another's: `pairs` holds (got,
    want, first) per chunk, [C, T, 2F] int16 arrays whose frame t is frame
    first + t of its stream.  Returns, for the onset frames and the later
    ones, (max delta in LSB, share of samples that differ, samples)."""
    stats = {}
    for part in ("onset", "steady"):
        d_max, n_diff, n_all = 0, 0, 0
        for got, want, first in pairs:
            t = first + np.arange(got.shape[1])
            sel = (t < HE_ONSET_FRAMES) == (part == "onset")
            if not sel.any():
                continue
            d = np.abs(got[:, sel].astype(np.int32)
                       - want[:, sel].astype(np.int32))
            d_max = max(d_max, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.size
        stats[part] = (d_max, n_diff / max(n_all, 1), n_all)
    return stats


def he_serving_corpus(n_unique: int, seconds: float, chunk: int,
                      lowpass: bool = True, ps: bool = False):
    """A serving corpus of HE-AAC v1 stereo streams built as the reference's
    HE benchmark builds its one (`bench.py` `bench_he`): the core AAC-LC at
    22.05 kHz (target_sf=122) from 8th-order Butterworth low-passed noise
    (3.6 kHz, x9000), each frame carrying one SBR extension (start_freq 4,
    stop_freq 3, two FIXFIX envelopes per channel at high frequency
    resolution, inverse filtering LOW, envelope 25 and noise 24 in the
    quantizer's units); 2x output to 44.1 kHz.  The reference encodes one
    stream from seed 7; stream i here uses seed 7 + i.  Each stream is cut
    to a whole number of `chunk`-frame chunks.  lowpass=False leaves the
    noise unfiltered (x9000 all the same).  ps=True builds `bench_he`'s
    HE-AAC v2 corpus instead (see ps_serving_corpus).  Returns (config,
    list of payload lists)."""
    from scipy import signal as sig

    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import (PSSpec, SBRFrameSpec,
                                                  sbr_payload)
    nch = 1 if ps else 2
    config = parse_asc(make_asc(2, 7, nch))  # 22.05 kHz core
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    t = S.derive_tables(h, 2 * config.sample_rate)
    spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                        env_q=np.full((2, t.n_high), 25, np.int64),
                        noise_q=np.full((2, t.n_q), 24, np.int64))
    if ps:
        psd = PSSpec(iid_mode=0, num_env=2,
                     iid_par=np.stack([np.arange(10) % 15 - 7,
                                       7 - np.arange(10) % 15]),
                     icc_mode=0, icc_par=np.arange(20).reshape(2, 10) % 8,
                     ipd_par=np.arange(10).reshape(2, 5) % 8,
                     opd_par=np.arange(10)[::-1].reshape(2, 5) % 8)
        pay = sbr_payload([spec], h, 2 * config.sample_rate, ps=psd)
    else:
        pay = sbr_payload([spec, spec], h, 2 * config.sample_rate)
    n = int(seconds * config.sample_rate) // 1024 * 1024
    bl, al = sig.butter(8, 3600 / (config.sample_rate / 2))
    corpus = []
    for i in range(n_unique):
        rng = np.random.default_rng(7 + i)
        x = rng.standard_normal((n, nch))
        if lowpass:
            x = sig.lfilter(bl, al, x, axis=0)
        frames = enc.encode_pcm_frames(x * 9000, config, target_sf=122,
                                       fil_payloads=[pay])
        corpus.append(list(frames[:len(frames) // chunk * chunk]))
    return config, corpus


def ps_serving_corpus(n_unique: int, seconds: float, chunk: int):
    """A serving corpus of HE-AAC v2 mono streams, `bench_he(ps=True)`'s
    construction: the HE-512 corpus's core and SBR extension at one channel,
    the extension carrying ps_data (IID in coarse 10 bands ramped -7..7 and
    back over two envelopes, ICC in 10 bands, IPD and OPD in 5 bands: 20-band
    hybrid mode).  Decoded as stereo at 44.1 kHz; each stream needs one
    spare slot (cce_slots=1).  Returns (config, list of payload lists)."""
    return he_serving_corpus(n_unique, seconds, chunk, ps=True)


def _quiet_tns_cpe(rng, cfg):
    """A random legal common-window CPE whose channels both carry TNS, its
    scalefactors shifted so the largest is 100: the PCM stays within
    ~2^20 of full scale, where the SBR stage's energies fit in f32 (the
    generator's raw gains reach 2^37)."""
    while True:
        left = random_channel_spec(rng, cfg, force_tns=True,
                                   allow_pulse=False, allow_noise=False)
        right = random_channel_spec(
            rng, cfg, window_sequence=left.window_sequence,
            grouping=left.grouping, max_sfb=left.max_sfb,
            window_shape=left.window_shape, force_tns=True,
            allow_pulse=False, allow_noise=False)
        ok = True
        for ch in (left, right):
            coded = (ch.band_books > 0) & (ch.band_books <= 11)
            d = int(ch.band_sf[coded].max()) - 100 if coded.any() else 0
            ch.band_sf[coded] -= d
            ch.global_gain -= d
            ok &= 0 <= ch.global_gain <= 255 and bool(
                (ch.band_sf[coded] >= 0).all())
        if ok:
            return enc.CPESpec(left=left, right=right, common_window=True,
                               ms_type=0, ms_used=np.zeros(128, bool))


def he_stream(n_frames: int = 7, ch: int = 2, seed: int = 1, header=None,
              tns: bool = False, header_at=()) -> bytes:
    """An HE-AAC v1 ADTS stream (22.05 kHz core, 44.1 kHz out) of low-passed
    noise with a small broadband floor, one SBR extension a frame (two
    envelopes, inverse filtering LOW).  `header` is the SBR header (start 4,
    stop 3 by default); `header_at` maps frame -> a header that replaces it
    from that frame on (written into that frame's extension); with `tns`
    the core frames are random legal CPE frames with TNS instead of
    encoded noise (stereo only)."""
    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import (SBRFrameSpec, sbr_payload,
                                                  write_sbr_fil)
    rng = np.random.default_rng(seed)
    cfg = parse_asc(make_asc(2, 7, ch))
    hdr = header or S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3,
                                xover_band=0)
    changes = dict(header_at)
    pays = []
    for f in range(n_frames):
        hdr = changes.get(f, hdr)
        t = S.derive_tables(hdr, 2 * cfg.sample_rate)
        spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                            env_q=np.full((2, t.n_high), 25, np.int64),
                            noise_q=np.full((2, t.n_q), 30, np.int64))
        pays.append(sbr_payload([spec] * ch, hdr, 2 * cfg.sample_rate,
                                write_header=(f == 0 or f in changes)))
    if tns:
        out = []
        for f in range(n_frames):
            w = BitWriter()
            enc.write_cpe(w, _quiet_tns_cpe(rng, cfg), cfg)
            write_sbr_fil(w, pays[f])
            out.append(enc.adts_frame(enc.end_frame(w), cfg))
        return b"".join(out)
    x = rng.standard_normal((1024 * n_frames + 256, ch))
    k = np.hanning(65) * np.sinc(np.linspace(-8, 8, 65) * 0.4)
    for c in range(ch):
        x[:, c] = np.convolve(x[:, c], k, mode="same")
    x = x[:1024 * n_frames] + 0.03 * rng.standard_normal((1024 * n_frames, ch))
    x = x * 27000 / max(1.0, np.abs(x).max())
    frames = enc.encode_pcm_frames(x, cfg, target_sf=118, fil_payloads=pays)
    return b"".join(enc.adts_frame(p, cfg) for p in frames)


def he_ps_stream(n_frames: int = 3, seed: int = 2) -> bytes:
    """An HE-AAC v2 mono ADTS stream: one SBR extension a frame carrying
    ps_data (the reference benchmark's PS payload without IPD/OPD)."""
    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import (PSSpec, SBRFrameSpec,
                                                  sbr_payload)
    config = parse_asc(make_asc(2, 7, 1))
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    t = S.derive_tables(h, 2 * config.sample_rate)
    spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                        env_q=np.full((2, t.n_high), 25, np.int64),
                        noise_q=np.full((2, t.n_q), 24, np.int64))
    ps = PSSpec(iid_mode=0, num_env=2,
                iid_par=np.stack([np.arange(10) % 15 - 7,
                                  7 - np.arange(10) % 15]),
                icc_mode=0, icc_par=np.arange(20).reshape(2, 10) % 8)
    pay = sbr_payload([spec], h, 2 * config.sample_rate, ps=ps)
    x = np.random.default_rng(seed).standard_normal((1024 * n_frames, 1))
    frames = enc.encode_pcm_frames(x * 3000, config, target_sf=118,
                                   fil_payloads=[pay])
    return b"".join(enc.adts_frame(p, config) for p in frames)


def he_chunk(n_streams: int, T: int, seconds: float = 1.0,
             lowpass: bool = True):
    """One chunk of HE-AAC v1 serving traffic: (config, payload lists of
    n_streams stereo streams, T frames each) from `he_serving_corpus(2,
    seconds, T, lowpass)`."""
    config, corpus = he_serving_corpus(2, seconds, T, lowpass)
    return config, [corpus[i % len(corpus)][:T] for i in range(n_streams)]


def sbr_apply_inputs(n_streams: int, T: int, device, compact: bool = False):
    """The inputs `sbr_batch.sbr_apply` takes on the HE serving path, for
    one chunk of `he_chunk` traffic (C = 2 * n_streams slots): (core PCM
    [C, T, 1024] f32, SBR planes, cfg planes, zero state), tensors on
    `device`, from BatchDecoder's native route there.  compact picks the
    compact planes (the serving transfer) over the exact ones."""
    import torch

    from aacjax_torch.kernels import sbr_batch as SB
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.runtime.batch import BatchDecoder
    config, chunk = he_chunk(n_streams, T)
    dec = BatchDecoder([config] * n_streams, chunk_frames=T, device=device)
    parsed, dense, ctx = dec._he_host_phase(chunk, compact=compact)
    core = meshlib.gather(dec._device_step(parsed), dec.device)
    dev = torch.device(device)
    planes = {k: v.to(dev) for k, v in dense.items()}
    cfg = {k: torch.from_numpy(v).to(dev) for k, v in ctx["cfg"].items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return core, planes, cfg, SB.sbr_state_init(dec.C, dev)


# -- HE-AAC v2 (Parametric Stereo) -------------------------------------------
def _ps_noise(rng, n: int) -> np.ndarray:
    """Mostly low-pass mono noise with a small broadband floor, peak ~27000."""
    x = rng.standard_normal((n + 256, 1))
    k = np.hanning(65) * np.sinc(np.linspace(-8, 8, 65) * 0.4)
    x[:, 0] = np.convolve(x[:, 0], k, mode="same")
    x = x[:n] + 0.03 * rng.standard_normal((n, 1))
    return x * 9000 / max(1.0, np.abs(x).max()) * 3


def ps_specs() -> dict:
    """Named PSSpecs: the two of the reference's libavcodec test of its
    batched PS (`20-band` with IPD/OPD in 5 bands, `34-band` with IPD/OPD in
    17), and two-envelope ramps without phases in each mode."""
    from aacjax_torch.testing.sbr_encoder import PSSpec
    r10, r20, r34 = (np.arange(n) % 15 - 7 for n in (10, 20, 34))
    return {
        "20-band": PSSpec(iid_mode=0, iid_par=r10[None, :], icc_mode=0,
                          icc_par=(np.arange(10) % 8)[None, :],
                          ipd_par=((np.arange(5) * 3) % 8)[None, :],
                          opd_par=(np.arange(5) % 8)[None, :]),
        "34-band": PSSpec(iid_mode=2, iid_par=r34[None, :], icc_mode=2,
                          icc_par=(np.arange(34) % 8)[None, :],
                          ipd_par=((np.arange(17) * 3) % 8)[None, :],
                          opd_par=((np.arange(17) * 5) % 8)[None, :]),
        "20-band 2 env": PSSpec(iid_mode=1, num_env=2,
                                iid_par=np.stack([r20, -r20]), icc_mode=1,
                                icc_par=np.arange(40).reshape(2, 20) % 8),
        "34-band 2 env": PSSpec(iid_mode=2, num_env=2,
                                iid_par=np.stack([r34, -r34]), icc_mode=2,
                                icc_par=np.stack([np.arange(34) % 8,
                                                  np.arange(34)[::-1] % 8])),
    }


def ps_stream(ps, n_frames: int = 7, seed: int = 1) -> bytes:
    """An HE-AAC v2 mono ADTS stream (22.05 kHz core, stereo at 44.1 kHz):
    every frame's SBR extension carries the PSSpec `ps`."""
    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import SBRFrameSpec, sbr_payload
    rng = np.random.default_rng(seed)
    config = parse_asc(make_asc(2, 7, 1))
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    t = S.derive_tables(h, 2 * config.sample_rate)
    spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                        env_q=np.full((2, t.n_bands(1)), 25, np.int64),
                        noise_q=np.full((2, t.n_q), 30, np.int64))
    pay = sbr_payload([spec], h, 2 * config.sample_rate, ps=ps)
    frames = enc.encode_pcm_frames(_ps_noise(rng, 1024 * n_frames), config,
                                   target_sf=118, fil_payloads=[pay])
    return b"".join(enc.adts_frame(p, config) for p in frames)


def ps_flip_stream(modes, seed: int = 7) -> bytes:
    """An HE-AAC v2 stream of one frame per entry of `modes` (0 / 1 / 2 =
    10 / 20 / 34 bands), IID / ICC / IPD / OPD random walks: the band scheme
    flips where the mode does."""
    from aacjax_torch.host import sbr as S
    from aacjax_torch.testing.sbr_encoder import (PSSpec, SBRFrameSpec,
                                                  sbr_payload)
    rng = np.random.default_rng(seed)
    config = parse_asc(make_asc(2, 7, 1))
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    t = S.derive_tables(h, 2 * config.sample_rate)
    nb = t.n_bands(1)
    pays = []
    for f, m in enumerate(modes):
        nr, nri = (10, 20, 34)[m], (5, 11, 17)[m]
        iid = np.clip(np.cumsum(rng.integers(-2, 3, (2, nr)), axis=1), -7, 7)
        icc = np.clip(3 + np.cumsum(rng.integers(-2, 3, (2, nr)), axis=1),
                      0, 7)
        ps = PSSpec(
            iid_mode=m, num_env=2, iid_par=iid, icc_mode=m, icc_par=icc,
            ipd_par=np.clip(np.cumsum(
                rng.integers(-1, 2, (2, nri)), axis=1) % 8, 0, 7),
            opd_par=np.clip(np.cumsum(
                rng.integers(-1, 2, (2, nri)), axis=1) % 8, 0, 7))
        spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                            env_q=np.full((2, nb), 25, np.int64),
                            noise_q=np.full((2, t.n_q), 30, np.int64))
        pays.append(sbr_payload([spec], h, 2 * config.sample_rate, ps=ps,
                                write_header=(f == 0)))
    frames = enc.encode_pcm_frames(_ps_noise(rng, 1024 * len(modes)), config,
                                   target_sf=118, fil_payloads=pays)
    return b"".join(enc.adts_frame(p, config) for p in frames)


def ps_decorr_inputs(seed: int, B: int, S: int, is34: bool):
    """Inputs of `ps_decorr.decorrelate_chunk` for B rows over S slots in
    one band mode, as numpy: the hybrid planes s_r, s_i [B,S,nb] (noise at
    hybrid-band scale with silent stretches and bursts, so that the
    transient gain takes both branches) and a carried decorrelator state
    (`ps_decorr.STATE_KEYS`: delay_r / delay_i [B,nb,14], ap_r / ap_i
    [B,nap,3,5], peak / psmooth / pdiff [B,npar], the peak near the power
    of its band).  The constants come from `ps_batch._consts`."""
    from aacjax_torch.kernels import ps_batch as PB
    rng = np.random.default_rng(seed)
    nb, npar, nap = PB._NB[is34], PB._NPAR[is34], PB._NAP[is34]
    level = np.where(rng.random((B, S, 1)) < 0.1, 30.0, 1.0)
    level[:, S // 3: S // 3 + 8] = 0.0
    s_r, s_i = (rng.standard_normal((B, S, nb)) * 300 * level
                for _ in range(2))
    width = np.bincount(PB.consts_np(is34)["k_to_i"], minlength=npar)
    peak = rng.random((B, npar)) * 2e5 * width
    state = dict(delay_r=rng.standard_normal((B, nb, 14)) * 300,
                 delay_i=rng.standard_normal((B, nb, 14)) * 300,
                 ap_r=rng.standard_normal((B, nap, 3, 5)) * 100,
                 ap_i=rng.standard_normal((B, nap, 3, 5)) * 100,
                 peak=peak, psmooth=peak * 0.5, pdiff=peak * 0.3)
    return (s_r.astype(np.float32), s_i.astype(np.float32),
            {k: v.astype(np.float32) for k, v in state.items()})


def sbr_ps_apply_inputs(n_streams: int, T: int, device):
    """The inputs `ps_batch.sbr_ps_apply` takes on the PS serving path for
    one chunk of `ps_serving_corpus` traffic (n_streams mono streams with a
    spare slot each, C = 2 * n_streams): (core PCM [C, T, 1024] f32,
    compact SBR planes, PS planes, cfg planes, zero SBR state, zero 20-band
    PS state seeded as the runtime seeds it), tensors on `device`, from
    BatchDecoder's native route there."""
    import torch

    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import sbr_batch as SB
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.runtime.batch import BatchDecoder
    config, corpus = ps_serving_corpus(2, 1.0, T)
    chunk = [corpus[i % len(corpus)][:T] for i in range(n_streams)]
    dec = BatchDecoder([config] * n_streams, chunk_frames=T, cce_slots=1,
                       device=device)
    parsed, dense, ctx = dec._he_host_phase(chunk, compact=True)
    core = meshlib.gather(dec._device_step(parsed), dec.device)
    dev = torch.device(device)
    planes = {k: v.to(dev) for k, v in dense.items()}
    ps = {k: v.to(dev) for k, v in ctx["ps_planes"].items()}
    cfg = {k: torch.from_numpy(v).to(dev) for k, v in ctx["cfg"].items()}
    state = SB.sbr_state_init(dec.C, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return core, planes, ps, cfg, state, PB.ps_state_init(dec.C, False, dev)


def encode_serving_pcm(n_streams: int, n_samples: int) -> np.ndarray:
    """The batched encoder's serving traffic, float32 [n_streams,
    n_samples, 2] in the 32768 scale: bench.py bench_encode's construction
    (two tones and noise from seed 11, each stream a rotation of the shared
    base by 97 samples, its right channel 0.8 x the left rotated by 41
    more)."""
    t = np.arange(n_samples) / SR
    rng = np.random.default_rng(11)
    base = (6000 * np.sin(2 * np.pi * 440 * t)
            + 2000 * np.sin(2 * np.pi * 1230 * t)
            + 500 * rng.standard_normal(n_samples))
    pcm = np.empty((n_streams, n_samples, 2), np.float32)
    for s in range(n_streams):
        r = np.roll(base, 97 * s)
        pcm[s, :, 0] = r
        pcm[s, :, 1] = 0.8 * np.roll(r, 41)
    return pcm


# -- inputs of the compiled programs (runtime/graphs.py), chunk after chunk ---
def spec_step_chunk(seed: int, C: int, T: int, *, i16: bool = False,
                    tns: bool = False, pred: bool = False) -> dict:
    """A chunk in the native parser's format, the batch of
    `decode_spec_step`: meta [C,T,6] (random_tail_chunk's windows and
    valid frames), the spectra (spec f32, or spec_i16 + spec_scale with
    i16), with tns the packed TNS planes of serving_tns_chunk's mix
    (tns_lpc [C,T,2,8,20], tns_range [C,T,2,8,2]), with pred the predictor
    planes (pred_meta [C,T,3] of mode, reset group, bins; pred_used_u8
    [C,T,672]).  numpy arrays."""
    b = random_tail_chunk(seed, C, T, i16=False)
    meta = np.stack([b[k] for k in ("f_idx", "s_idx", "shape_idx",
                                    "prev_shape_idx", "is_short", "valid")],
                    axis=-1).astype(np.int32)
    out = dict(meta=meta)
    if i16:
        out["spec_i16"], out["spec_scale"] = block_scale_i16(b["spec"])
    else:
        out["spec"] = b["spec"]
    if tns:
        _, _, out["tns_lpc"], out["tns_range"] = serving_tns_chunk(
            seed + 1, C, T)
    if pred:
        rng = np.random.default_rng(seed + 2)
        mode = rng.choice([0, 1, 1, 1, 1, 2], size=(C, T))
        reset = np.where(rng.random((C, T)) < 0.33,
                         rng.integers(1, 31, (C, T)), 0)
        nbins = rng.choice([672, 672, 640, 100], size=(C, T))
        out["pred_meta"] = np.stack([mode, reset, nbins],
                                    axis=-1).astype(np.int32)
        out["pred_used_u8"] = np.repeat(rng.random((C, T, 42)) < 0.5, 16,
                                        axis=-1).astype(np.uint8)
    return out


def packed_step_chunks(n_streams: int, T: int, n_chunks: int,
                       seed: int = 0):
    """n_chunks chunks of T frames of n_streams Main-profile stereo streams
    (main_stereo_payloads: prediction, reset groups, short windows, M/S,
    TNS), parsed on the python route and packed (`pack_frames`), the batch
    of `decode_step`.  Returns (list of (numpy batch, flags), C)."""
    from aacjax_torch.runtime.batch import BatchDecoder
    from aacjax_torch.runtime.pack import pack_frames
    dec = BatchDecoder([main_config()] * n_streams, chunk_frames=T,
                       use_native=False, device="cpu")
    frames = [dec.parse_stream_frames(
        i, main_stereo_payloads(T * n_chunks, seed + i))
        for i in range(n_streams)]
    out = []
    for k in range(n_chunks):
        per_slot = [(dec.streams[i].base_slot, f[k * T:(k + 1) * T])
                    for i, f in enumerate(frames)]
        out.append(pack_frames(per_slot, dec.C, T))
    return out, dec.C


def he_program_chunks(n_streams: int, T: int, n_chunks: int, device,
                      ps: bool = False):
    """n_chunks chunks of HE-AAC v1 (he_serving_corpus) or, with ps, v2
    (ps_serving_corpus, a spare slot a stream) traffic through
    BatchDecoder's native host phase and core step on `device`: per chunk
    a dict of the SBR program's inputs there (core [C,T,1024] f32, the
    compact SBR planes `dense`, the cfg planes `cfg`, with ps the PS planes
    `ps`), each a copy of its own.  Returns (chunks, C)."""
    import torch

    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.runtime.batch import BatchDecoder
    if ps:
        config, corpus = ps_serving_corpus(2, 1.0, T)
    else:
        config, corpus = he_serving_corpus(2, 1.0, T)
    streams = [corpus[i % len(corpus)] for i in range(n_streams)]
    dec = BatchDecoder([config] * n_streams, chunk_frames=T,
                       cce_slots=int(ps), device=device)
    dev = dec.device
    out = []
    for k in range(n_chunks):
        chunk = [p[k * T:(k + 1) * T] for p in streams]
        parsed, dense, ctx = dec._he_host_phase(chunk, compact=True)
        d = dict(core=meshlib.gather(dec._device_step(parsed), dev),
                 dense={k: v.to(dev, copy=True) for k, v in dense.items()},
                 cfg={k: torch.from_numpy(v.copy()).to(dev)
                      for k, v in ctx["cfg"].items()})
        if ps:
            d["ps"] = {k: v.to(dev, copy=True)
                       for k, v in ctx["ps_planes"].items()}
        out.append(d)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, dec.C


def encoder_program_chunks(n_streams: int, n_frames: int, n_chunks: int,
                           bitrate: int = 128_000):
    """n_chunks chunks of encode_serving_pcm traffic through the host prep
    of a CPU BatchEncoder (window plan, int16 PCM with the carried frame):
    (encoder, list of (pcm_i16 [S*2, nF*1024 + 1024] int16, w_idx
    [S*2, nF] int64, is_short [S*2, nF] bool)), numpy arrays."""
    from aacjax_torch.encode_batch import BatchEncoder
    n = n_frames * FRAME
    pcm = encode_serving_pcm(n_streams, n * n_chunks)
    enc_ = BatchEncoder(SR, 2, bitrate, n_streams, device="cpu")
    out = []
    for k in range(n_chunks):
        _, pcm_i16, w_idx, is_short, _ = enc_._prep_chunk(
            pcm[:, k * n:(k + 1) * n])
        out.append((pcm_i16, w_idx.astype(np.int64), is_short))
    return enc_, out


def enc_scans_random(seed: int, N: int, sample_rate: int = SR,
                     cutoff_bin: int = 542, short_share: float = 0.25
                     ) -> dict:
    """Random inputs of the batched encoder's two scans
    (kernels/enc_scans.py) at the band layout of one configuration
    (encode_batch._arrangement; the default is ENC-512's, 44.1 kHz at
    cutoff bin 542): band energies `e` f32 [N, nb] >= 0 with zero bands and
    zero rows, and the grid's inputs as the analysis program makes them --
    `t34` f32 [N, Pe] (0 on padding bins), `is_short` bool [N], `regions`
    int64 [2, Pe], and integer `base` / `fit_sf` / `zero_sf` f32 [N, nb]:
    fit_sf >= 0, zero_sf about 73 above it, base between them (255 for
    bands a row type does not code; silent bands as the analysis leaves
    them, fit 0, zero -294, base -294), t34 scaled so that the offsets
    quantize from 0 up to the 8191 clamp.  Numpy arrays."""
    from aacjax_torch import tables
    from aacjax_torch.encode_batch import FRAME as F, _arrangement
    si = int(np.argmin(np.abs(tables.SAMPLE_RATES[:12] - sample_rate)))
    arr = _arrangement(si, cutoff_bin, F)
    nb, S = arr["nb"], F // 8
    cut_l = int(arr["ptr_l"][-1])
    cut_s = int(arr["cfg"].swb_offsets_short[arr["max_sfb_s"]])
    Pe = max(cut_l, 8 * cut_s)
    regions = np.stack([
        np.concatenate([arr["bb_l"][:cut_l], np.full(Pe - cut_l, nb)]),
        np.concatenate([arr["bb_s"].reshape(8, S)[:, :cut_s].reshape(-1),
                        np.full(Pe - 8 * cut_s, nb)])]).astype(np.int64)
    rng = np.random.default_rng(seed)
    is_short = rng.random(N) < short_share
    e = (np.exp(rng.normal(0.0, 3.0, (N, nb))) * 1e4).astype(np.float32)
    e[rng.random((N, nb)) < 0.1] = 0.0
    e[rng.random(N) < 0.05] = 0.0
    fit = rng.integers(0, 130, (N, nb)).astype(np.float32)
    zero = fit + rng.integers(70, 76, (N, nb))
    base = fit + np.floor(rng.random((N, nb)) * (zero - fit + 1))
    silent = rng.random((N, nb)) < 0.08
    fit[silent], zero[silent], base[silent] = 0.0, -294.0, -294.0
    coded = np.where(is_short[:, None], arr["coded_s"], arr["coded_l"])
    base = np.where(coded, base, 255.0).astype(np.float32)
    # per bin: a magnitude the band's base quantizes to ~0-30
    region = np.where(is_short[:, None], regions[1], regions[0])
    b_bin = np.concatenate([base, np.full((N, 1), 255.0)], 1)
    b_bin = np.take_along_axis(b_bin, region, 1)
    amp = np.exp(rng.normal(0.5, 1.5, (N, Pe))) * (rng.random((N, Pe)) > 0.2)
    t34 = amp * np.exp2((np.minimum(b_bin, 250.0) - 100.0) * 0.1875)
    t34[(region == nb) | (b_bin < 0)] = 0.0
    return dict(e=e, t34=t34.astype(np.float32), is_short=is_short,
                regions=regions, base=base, fit_sf=fit.astype(np.float32),
                zero_sf=zero.astype(np.float32), nb=nb, Pe=Pe)


def enc_grid_random(seed: int, N: int, Pe: int, nb: int,
                    short_share: float = 0.25, odd_bands: bool = False
                    ) -> dict:
    """Random inputs of the rate-cost grid (kernels/enc_scans.py) at any
    shape the kernel takes, beyond the encoder's arrangements: Pe bins
    (even), nb bands (<= 63), long rows' bands in order over about 7/8 of
    the bins (the rest padding, band nb), short rows' bins in 8 windows of
    about nb / 8 bands each; band widths even, or any with odd_bands (so
    that some pairs straddle two bands).  `base` / `fit_sf` / `zero_sf` as
    in enc_scans_random (silent bands, bands a row type does not code),
    `t34` from 0 past the 8191 clamp at the grid's offsets.  Numpy arrays;
    `regions` int64 [2, Pe]."""
    rng = np.random.default_rng(seed)

    def band_map(bands, bins):
        step = 1 if odd_bands else 2
        cuts = np.sort(rng.choice(np.arange(step, bins, step), len(bands) - 1,
                                  replace=False))
        return np.repeat(bands, np.diff(np.concatenate([[0], cuts, [bins]])))

    coded = (Pe * 7 // 8) & ~1
    long_map = band_map(np.arange(nb), coded)
    win = max(nb // 8, 1)
    seg = (coded // 8) & ~1
    short_map = np.concatenate([band_map((w * win + np.arange(win)) % nb, seg)
                                for w in range(8)])
    regions = np.full((2, Pe), nb, np.int64)
    regions[0, :coded] = long_map
    regions[1, :8 * seg] = short_map
    is_short = rng.random(N) < short_share
    fit = rng.integers(0, 130, (N, nb)).astype(np.float32)
    zero = fit + rng.integers(70, 76, (N, nb))
    base = fit + np.floor(rng.random((N, nb)) * (zero - fit + 1))
    silent = rng.random((N, nb)) < 0.08
    fit[silent], zero[silent], base[silent] = 0.0, -294.0, -294.0
    uncoded = rng.random(nb) < 0.1
    base = np.where(is_short[:, None] & uncoded, 255.0, base)
    region = np.where(is_short[:, None], regions[1], regions[0])
    b_bin = np.take_along_axis(
        np.concatenate([base, np.full((N, 1), 255.0)], 1), region, 1)
    amp = np.exp(rng.normal(0.5, 2.0, (N, Pe))) * (rng.random((N, Pe)) > 0.2)
    t34 = amp * np.exp2((np.minimum(b_bin, 250.0) - 100.0) * 0.1875)
    t34[(region == nb) | (b_bin < 0)] = 0.0
    return dict(t34=t34.astype(np.float32), is_short=is_short,
                regions=regions, base=base.astype(np.float32),
                fit_sf=fit.astype(np.float32),
                zero_sf=zero.astype(np.float32), nb=nb, Pe=Pe)


def enc_scans_inputs(enc, pcm: np.ndarray, device) -> tuple[dict, tuple]:
    """One chunk `pcm` [S, n, ch] through `enc`'s host prep and the eager
    analysis program (`encode_batch._analysis_fn`) on `device`, with the
    two scans' wrappers recording what they are given and return: ({
    "spread": (args, out), "rate_cost": (args, out)}, the analysis's
    outputs).  The wrappers are restored before it returns."""
    import torch

    from aacjax_torch import encode_batch as EB
    from aacjax_torch.kernels import enc_scans
    _, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(pcm)
    fn = EB._analysis_fn(enc._si, enc._cutoff_bin, EB.FRAME, nF,
                         enc._psy_key(), torch.device(device))
    seen: dict = {}
    wrappers = {name: getattr(enc_scans, name)
                for name in ("spread", "rate_cost")}

    def recording(name):
        def call(*args):
            seen[name] = (args, wrappers[name](*args))
            return seen[name][1]
        return call

    try:
        for name in wrappers:
            setattr(enc_scans, name, recording(name))
        outs = fn(*(torch.from_numpy(a).to(device) for a in (
            pcm_i16, w_idx.astype(np.int64), is_short)))
    finally:
        for name, fn_ in wrappers.items():
            setattr(enc_scans, name, fn_)
    return seen, outs
