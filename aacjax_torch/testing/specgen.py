"""Random valid ChannelSpec/CPESpec generation for property-based tests.

Generates syntactically valid, spec-conformant raw_data_block contents
covering: all window sequences and shapes, short-window grouping, every
spectral codebook (incl. book-11 escapes), PNS noise bands, intensity
bands, M/S masks, TNS filters (both directions, both resolutions), and
pulse data.
"""
from __future__ import annotations

import numpy as np

from aacjax_torch.host.asc import StreamConfig
from aacjax_torch.testing.encoder import (
    BOOK_LAV, ChannelSpec, CPESpec, INTENSITY, INTENSITY2, NOISE,
    TnsFilterSpec, ZERO,
)

FRAME = 1024


def legal_sequence_chain(rng, n: int, start: int = 0) -> list[int]:
    """A window-sequence chain obeying the encoder transition rules
    (ONLY_LONG->{OL,LS}, LONG_START->{ES,STOP}, EIGHT_SHORT->{ES,STOP},
    LONG_STOP->{OL,LS}).  Decoders may legitimately differ on illegal
    chains (FFmpeg adapts the overlap to the previous frame's sequence),
    so conformance corpora must stay legal."""
    legal = {0: (0, 1), 1: (2, 3), 2: (2, 3), 3: (0, 1)}
    seqs = []
    cur = start
    for _ in range(n):
        seqs.append(cur)
        cur = int(rng.choice(legal[cur]))
    return seqs


def random_grouping(rng) -> list[int]:
    """Random partition of 8 windows into contiguous groups."""
    groups = []
    left = 8
    while left:
        g = int(rng.integers(1, left + 1))
        groups.append(g)
        left -= g
    return groups


def random_quant_for_book(rng, book: int, width: int) -> np.ndarray:
    lav = BOOK_LAV[book]
    if book == 11:
        vals = rng.integers(-40, 41, size=width)
        # sprinkle some large escape values
        mask = rng.random(width) < 0.1
        vals = np.where(mask, rng.integers(-4000, 4001, size=width), vals)
        return vals
    return rng.integers(-lav, lav + 1, size=width)


def random_channel_spec(rng, config: StreamConfig, *,
                        window_sequence: int | None = None,
                        grouping: list[int] | None = None,
                        max_sfb: int | None = None,
                        window_shape: int | None = None,
                        allow_intensity: bool = False,
                        allow_noise: bool = True,
                        allow_tns: bool = True,
                        allow_pulse: bool = True,
                        force_tns: bool = False) -> ChannelSpec:
    seq = int(rng.integers(0, 4)) if window_sequence is None else window_sequence
    short = seq == 2
    shape = int(rng.integers(0, 2)) if window_shape is None else window_shape
    if short and grouping is None:
        grouping = random_grouping(rng)
    if not short:
        grouping = None
    swb_count = config.swb_count_short if short else config.swb_count_long
    if max_sfb is None:
        max_sfb = int(rng.integers(1, min(swb_count, 15 if short else 63) + 1))
    gcount = len(grouping) if grouping else 1
    n_idx = gcount * max_sfb

    offsets = config.swb_offsets_short if short else config.swb_offsets_long

    global_gain = int(rng.integers(80, 180))
    books = np.zeros(n_idx, np.int64)
    sfs = np.zeros(n_idx, np.int64)
    quant = np.zeros(FRAME, np.int64)

    choices = [ZERO, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    if allow_noise:
        choices.append(NOISE)
    if allow_intensity:
        choices += [INTENSITY, INTENSITY2]

    sf_track = global_gain
    noise_track = global_gain - 90
    is_track = 0
    group_off = 0
    idx = 0
    for g in range(gcount):
        glen = grouping[g] if grouping else 1
        for sfb in range(max_sfb):
            book = int(rng.choice(choices))
            books[idx] = book
            if book == ZERO:
                pass
            elif book == NOISE:
                noise_track = int(np.clip(noise_track + rng.integers(-5, 6),
                                          -90, 150))
                sfs[idx] = noise_track
            elif book in (INTENSITY, INTENSITY2):
                is_track = int(np.clip(is_track + rng.integers(-10, 11),
                                       -100, 100))
                sfs[idx] = is_track
            else:
                sf_track = int(np.clip(sf_track + rng.integers(-8, 9), 10, 250))
                sfs[idx] = sf_track
                a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                width = b - a
                for w in range(glen):
                    base = group_off + w * config.short_length + a
                    quant[base:base + width] = random_quant_for_book(
                        rng, book, width)
            idx += 1
        group_off += (glen if grouping else 1) * config.short_length

    spec = ChannelSpec(window_sequence=seq, window_shape=shape,
                       max_sfb=max_sfb, grouping=grouping,
                       global_gain=global_gain, band_books=books,
                       band_sf=sfs, quant=quant)

    if allow_tns and (force_tns or rng.random() < 0.5):
        n_windows = 8 if short else 1
        tns = []
        for w in range(n_windows):
            filts = []
            if rng.random() < (0.8 if not short else 0.3):
                coef_res = int(rng.integers(0, 2))
                nfilt = int(rng.integers(1, 2 if short else 4))
                for _ in range(nfilt):
                    order = int(rng.integers(0, (7 if short else 12) + 1))
                    compress = int(rng.integers(0, 2))
                    coef_len = coef_res + 3 - compress
                    filts.append(TnsFilterSpec(
                        length_bands=int(rng.integers(0, max_sfb + 1)),
                        order=order,
                        direction=int(rng.integers(0, 2)),
                        coef_res=coef_res,
                        coef_compress=compress,
                        coef_indices=[int(rng.integers(0, 1 << coef_len))
                                      for _ in range(order)],
                    ))
            tns.append(filts)
        if any(tns):
            spec.tns = tns

    if allow_pulse and not short and rng.random() < 0.2 and max_sfb > 1:
        pulse_swb = int(rng.integers(0, max_sfb - 1))
        count = int(rng.integers(1, 5))
        offs = [int(rng.integers(0, 32)) for _ in range(count)]
        base = int(offsets[pulse_swb]) + offs[0]
        total = base + sum(offs[1:])
        if total <= 1023:
            amps = [int(rng.integers(0, 16)) for _ in range(count)]
            spec.pulse = (pulse_swb, offs, amps)

    return spec


def random_cpe_spec(rng, config: StreamConfig,
                    common: bool | None = None) -> CPESpec:
    if common is None:
        common = bool(rng.random() < 0.8)
    if common:
        left = random_channel_spec(rng, config)
        # shared ICSInfo: identical window sequence/shape/grouping/max_sfb
        right = random_channel_spec(
            rng, config, window_sequence=left.window_sequence,
            grouping=left.grouping, max_sfb=left.max_sfb,
            window_shape=left.window_shape, allow_intensity=True)
        n_idx = left.group_count * left.max_sfb
        ms_type = int(rng.choice([0, 1, 2]))
        ms_used = (rng.random(n_idx) < 0.5).astype(np.int64) \
            if ms_type == 1 else None
        return CPESpec(left=left, right=right, common_window=True,
                       ms_type=ms_type, ms_used=ms_used)
    left = random_channel_spec(rng, config)
    right = random_channel_spec(rng, config, allow_intensity=True)
    return CPESpec(left=left, right=right, common_window=False, ms_type=0)
