"""The port's spectral decode (aacjax_torch/native/aacparse.cc: scale-factor
gains from a table, one loop per codebook kind that writes each bin's
inverse_quant(q) * gain straight into the f32 row, the general path of
quantised values and finalize_spec for pulse data, coupling channels and
q/sf chunks) against the JAX package's unchanged library
(native/libaacparse.so: a generic decode, libm pow for every gain and a
second pass over the bins), on every output plane, bit for bit (floats
compared by their bits, so a -0 for a +0 fails):

- synthetic chunks that between them use every spectral codebook in long
  and eight-short windows, escapes up to and past |q| = 8191, PNS,
  intensity of both signs with and without M/S, pulse data, coupling
  channels, Main, LTP, ER-LC, LD and ELD, and scale factors at both ends
  of the gain table and below it, under 1 and 4 parse threads, each with
  and without the q/sf planes;
- mutated and truncated frames (the seeds of tests/test_torch_fuzz.py),
  where the per-band bounds check decides: the same statuses, messages,
  consumed bits and concealed rows;
- the parse's band counts, as `BatchDecoder._parse_native` records them
  when tracing."""
import contextlib

import numpy as np
import pytest

import aacjax_torch
from aacjax.host import native as jax_native
from aacjax_torch import testing as TI
from aacjax_torch.host import huffman, native
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.runtime.stats import Trace
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import (random_channel_spec,
                                          random_cpe_spec,
                                          random_quant_for_book)
from aacjax_torch.testing.streams import make_lc_payload_chunks

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")

# escape values: the smallest, the LUT's last entry, past it (libm pow),
# and the longest escape the syntax allows (24 bits)
ESCAPES = [16, -17, 8191, -8191, 8192, -8193, 65537, -(2 ** 24 + 3),
           2 ** 25 - 1]
PLANES = ("spec", "meta", "tns_lpc", "tns_range", "cce_post_idx",
          "cce_post_gain", "cce_time_idx", "cce_time_gain", "cce_counts",
          "consumed_bits", "fil_sbr", "fil_drc")


def _lc(ch=2):
    return parse_asc(make_asc(2, 4, ch))


def _frame(*elements, cfg) -> bytes:
    w = BitWriter()
    for kind, spec in elements:
        if kind == "CPE":
            enc.write_cpe(w, spec, cfg)
        elif kind == "CCE":
            enc.write_cce(w, spec, cfg)
        else:
            enc.write_sce(w, spec, cfg)
    return enc.end_frame(w)


def _cover_books(rng, spec: enc.ChannelSpec, cfg, start: int = 0):
    """Give the spectrum bands of `spec` the books 1..11 in turn (from
    `start`), with fresh values; book 11 bands lead with ESCAPES."""
    short = spec.window_sequence == 2
    offsets = cfg.swb_offsets_short if short else cfg.swb_offsets_long
    n, idx, group_off = start, 0, 0
    for glen in spec.group_lengths():
        for sfb in range(spec.max_sfb):
            if 1 <= int(spec.band_books[idx]) <= 11:
                book = 1 + n % 11
                n += 1
                spec.band_books[idx] = book
                a, b = int(offsets[sfb]), int(offsets[sfb + 1])
                for w in range(glen):
                    base = group_off + w * cfg.short_length + a
                    q = random_quant_for_book(rng, book, b - a)
                    if book == 11:
                        k = min(len(ESCAPES), b - a)
                        q[:k] = np.roll(ESCAPES, n + w)[:k]
                    spec.quant[base:base + b - a] = q
            idx += 1
        group_off += glen * cfg.short_length
    return spec


def _books_frames(seq: int, n: int, seed: int) -> list[bytes]:
    """CPE frames of one window sequence whose bands run through every
    spectral book, PNS on the left, intensity on the right, M/S of each
    type."""
    rng = np.random.default_rng(seed)
    cfg = _lc()
    out = []
    for f in range(n):
        left = random_channel_spec(rng, cfg, window_sequence=seq,
                                   allow_pulse=False)
        right = random_channel_spec(
            rng, cfg, window_sequence=seq, grouping=left.grouping,
            max_sfb=left.max_sfb, window_shape=left.window_shape,
            allow_intensity=True, allow_pulse=False, allow_noise=False)
        _cover_books(rng, left, cfg, f)
        _cover_books(rng, right, cfg, f + 5)
        ms_type = f % 3
        n_idx = left.group_count * left.max_sfb
        ms_used = ((rng.random(n_idx) < 0.5).astype(np.int64)
                   if ms_type == 1 else None)
        out.append(_frame(("CPE", enc.CPESpec(
            left=left, right=right, common_window=True, ms_type=ms_type,
            ms_used=ms_used)), cfg=cfg))
    return out


def _random_frames(n: int, seed: int) -> list[bytes]:
    """random_cpe_spec frames: PNS, intensity, M/S, TNS, pulse data, every
    window sequence, shared and separate windows."""
    rng = np.random.default_rng(seed)
    cfg = _lc()
    return [_frame(("CPE", random_cpe_spec(rng, cfg)), cfg=cfg)
            for _ in range(n)]


def _pulse_frames(n: int, seed: int) -> list[bytes]:
    """Mono frames with pulse data on escape-book bands (some pulses on a
    zero band), long windows."""
    rng = np.random.default_rng(seed)
    cfg = _lc(1)
    out = []
    for f in range(n):
        s = random_channel_spec(rng, cfg, window_sequence=0, max_sfb=40,
                                allow_pulse=False)
        _cover_books(rng, s, cfg, f)
        offs = [int(rng.integers(0, 32)) for _ in range(4)]
        s.pulse = (int(rng.integers(0, 20)), offs,
                   [int(rng.integers(1, 16)) for _ in range(4)])
        out.append(_frame(("SCE", s), cfg=cfg))
    return out


def _intensity_frames(n: int, seed: int) -> list[bytes]:
    """CPE frames whose right channel alternates intensity books 14 and 15
    over positions from -160 to 105 (clipped to -155..100 by the decoder),
    under M/S off, per band and everywhere."""
    rng = np.random.default_rng(seed)
    cfg = _lc()
    positions = [-60, -120, -160, -110, -50, 10, 70, 105, 45, 0]
    out = []
    for f in range(n):
        left = random_channel_spec(rng, cfg, window_sequence=0, max_sfb=30,
                                   allow_pulse=False, allow_noise=False)
        right = random_channel_spec(
            rng, cfg, window_sequence=0, max_sfb=30,
            window_shape=left.window_shape, allow_pulse=False,
            allow_noise=False)
        for i, pos in enumerate(positions):
            right.band_books[10 + i] = enc.INTENSITY if i % 2 else \
                enc.INTENSITY2
            right.band_sf[10 + i] = pos
        ms_type = f % 3
        out.append(_frame(("CPE", enc.CPESpec(
            left=left, right=right, common_window=True, ms_type=ms_type,
            ms_used=((rng.random(30) < 0.5).astype(np.int64)
                     if ms_type == 1 else None))), cfg=cfg))
    return out


def _edge_channel(rng, cfg, sfs, books, global_gain):
    """A long-window channel with the given scale factors and books."""
    n = len(books)
    quant = np.zeros(1024, np.int64)
    offsets = cfg.swb_offsets_long
    for sfb, book in enumerate(books):
        if 1 <= book <= 11:
            a, b = int(offsets[sfb]), int(offsets[sfb + 1])
            q = random_quant_for_book(rng, book, b - a)
            q[0] = -max(1, abs(int(q[0])))       # a negative value per band
            quant[a:b] = q
    return enc.ChannelSpec(window_sequence=0, max_sfb=n,
                           global_gain=global_gain,
                           band_books=np.array(books, np.int64),
                           band_sf=np.array(sfs, np.int64), quant=quant)


def _sf_edge_frames(n: int, seed: int) -> list[bytes]:
    """Scale factors at both ends of the table's valid range: spectrum 0
    and 255 (gains 2^-25 and 2^38.75), noise offsets past both clips
    (-100 and 155), on mono frames."""
    rng = np.random.default_rng(seed)
    cfg = _lc(1)
    sfs = [0, 0, 40, 100, 160, 220, 255, 255, -130, -100, -40, 20, 80, 140,
           190, 200, 255]
    books = [11, 3, 5, 11, 9, 1, 11, 7] + [enc.NOISE] * 8 + [11]
    return [_frame(("SCE", _edge_channel(rng, cfg, sfs, books, 60)), cfg=cfg)
            for _ in range(n)]


def _write_scale_factors_unchecked(w: BitWriter, spec) -> None:
    """enc.write_scale_factors without its range checks: scale factors
    below 0, which a conforming encoder never writes and the parser takes."""
    offset = [spec.global_gain, spec.global_gain - 90, 0]
    first_noise = True
    for book, sf in zip(spec.band_books, spec.band_sf):
        book, sf = int(book), int(sf)
        if book == enc.ZERO:
            continue
        k = 2 if book in (enc.INTENSITY, enc.INTENSITY2) else \
            1 if book == enc.NOISE else 0
        delta = sf - offset[k]
        if k == 1 and first_noise:
            w.write(delta + 256, 9)
            first_noise = False
        else:
            huffman.encode_scalefactor(w, delta + 60)
        offset[k] = sf


@contextlib.contextmanager
def _unchecked_scale_factors():
    saved = enc.write_scale_factors
    enc.write_scale_factors = _write_scale_factors_unchecked
    try:
        yield
    finally:
        enc.write_scale_factors = saved


def _sf_below_table_frames(n: int, seed: int) -> list[bytes]:
    """Spectrum scale factors that fall by 60 a band from global gain 0 to
    -660: table indices below 0 take libm pow, and from -501 on the gain
    is +0, so a negative value's product is -0 (+0 in the row)."""
    rng = np.random.default_rng(seed)
    cfg = _lc(1)
    sfs = [-60 * (i + 1) for i in range(11)] + [-660] * 3
    books = [1 + i % 11 for i in range(14)]
    with _unchecked_scale_factors():
        return [_frame(("SCE", _edge_channel(rng, cfg, sfs, books, 0)),
                       cfg=cfg) for _ in range(n)]


T = 6


def _case(name: str):
    """(configs, payload lists, slots a stream, parse options)."""
    lc2, lc1 = _lc(), _lc(1)
    if name == "books_long":
        return [lc2] * 3, [_books_frames(0, T, s) for s in range(3)], 2, {}
    if name == "books_short":
        return [lc2] * 3, [_books_frames(2, T, 10 + s) for s in range(3)], \
            2, {}
    if name == "random":
        return [lc2] * 4, [_random_frames(T, 20 + s) for s in range(4)], \
            2, {}
    if name == "intensity":
        return [lc2] * 2, [_intensity_frames(T, 30 + s) for s in range(2)], \
            2, {}
    if name == "pulse":
        return [lc1] * 2, [_pulse_frames(T, 40 + s) for s in range(2)], 1, {}
    if name == "sf_edges":
        return [lc1, lc1], [_sf_edge_frames(T, 50), _sf_below_table_frames(
            T, 51)], 1, {}
    if name == "cce":
        # BEFORE_TNS, AFTER_TNS (host-fused and onto TNS'd targets) and
        # AFTER_IMDCT coupling, each with a slot of its own
        return [lc2] * 4, [TI.cce_stereo_payloads(T, 60, 0),
                           TI.cce_stereo_payloads(T, 61, 1),
                           TI.cce_stereo_payloads(T, 62, 1, target_tns=True),
                           TI.cce_stereo_payloads(T, 63, 2)], 3, {}
    if name == "multichannel":
        cfg = TI.multichannel_config(6)
        return [cfg] * 2, [TI.multichannel_payloads(6, T, 70 + s,
                                                    coupling=True)
                           for s in range(2)], 8, {}
    if name == "main":
        return [TI.main_config()] * 2, [TI.main_stereo_payloads(T, 80 + s)
                                        for s in range(2)], 2, \
            {"want_pred": True}
    if name == "ltp":
        cfg = parse_asc(make_asc(4, 4, 2))
        return [cfg] * 2, [TI.adts_payloads(TI.ltp_adts(
            T, 90 + s, channels=2, tns=True, short_frames=(3,)))
            for s in range(2)], 2, {"want_ltp": True}
    profile, F = {"er_lc_960": (17, 960), "ld_480": (23, 480),
                  "eld_512": (39, 512)}[name]
    cfg = TI.er_config(profile, F, 2)
    return [cfg] * 2, [TI.er_payloads(cfg, T, 100 + s) for s in range(2)], \
        2, {}


CASES = ("books_long", "books_short", "random", "intensity", "pulse",
         "sf_edges", "cce", "multichannel", "main", "ltp", "er_lc_960",
         "ld_480", "eld_512")


def _parse(mod, configs, chunk, n_slots, T, want_qsf=False, counts=None,
           **opts):
    """One chunk through `mod`'s library: (status, has_tns, message,
    the planes).  The JAX package's int16 spectra come from its separate
    pass, the port's from its parse threads."""
    F = configs[0].frame_length
    slots = np.full(len(configs), n_slots, np.int32)
    base = np.concatenate([[0], np.cumsum(slots)[:-1]]).astype(np.int32)
    out = mod.SpecBatchArrays(int(slots.sum()), T, F)
    args = ([list(p) if p else None for p in chunk],
            np.array([c.sample_index for c in configs], np.int32),
            np.array([c.chan_config for c in configs], np.int32), base,
            slots, np.zeros(int(slots.sum()), np.int32), out)
    kw = dict(tables_pack=mod.stream_tables(configs), want_qsf=want_qsf,
              **opts)
    if mod is native:
        kw.update(want_i16=True)
        if counts is not None:
            kw.update(counts=counts)
    status, has_tns, msg = mod.parse_batch_spec(*args, **kw)
    if mod is jax_native:
        mod.compact_spec(out)
    planes = {k: np.array(getattr(out, k)) for k in PLANES + (
        "spec_i16", "spec_scale")}
    if want_qsf:
        planes.update(spec_q=out.spec_q.copy(), spec_sf=out.spec_sf.copy(),
                      qsf_ok=out.qsf_ok.copy())
    if opts.get("want_pred"):
        planes.update(pred_meta=out.pred_meta.copy(),
                      pred_used=out.pred_used.copy())
    if opts.get("want_ltp"):
        planes.update(ltp_meta=out.ltp_meta.copy(),
                      ltp_used=out.ltp_used.copy())
    planes["prev_shapes"] = args[5]
    return status, has_tns, msg, planes


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same(got, want, what):
    status, has_tns, msg, planes = got
    j_status, j_has_tns, j_msg, j_planes = want
    np.testing.assert_array_equal(status, j_status, err_msg=what)
    assert (has_tns, msg) == (j_has_tns, j_msg), what
    assert planes.keys() == j_planes.keys()
    for k, v in planes.items():
        assert v.shape == j_planes[k].shape, (what, k)
        assert np.array_equal(_bits(v), _bits(j_planes[k])), (what, k)


def _compare(configs, chunk, n_slots, T, **opts):
    got = _parse(native, configs, chunk, n_slots, T, **opts)
    want = _parse(jax_native, configs, chunk, n_slots, T, **opts)
    _assert_same(got, want, opts)
    return got


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("case", CASES)
def test_planes_bit_identical(case, threads, monkeypatch):
    """Every plane of the port's parse equals the JAX package's library's,
    bit for bit, with the q/sf planes asked for and not; the chunk holds
    what the case names (and each stream ran without error)."""
    monkeypatch.setenv("AACJAX_PARSE_THREADS", threads)
    configs, chunk, n_slots, opts = _case(case)
    for want_qsf in (False, True):
        status, _, _, planes = _compare(configs, chunk, n_slots, T,
                                        want_qsf=want_qsf, **opts)
        assert (status == 0).all(), (case, status)
        assert (planes["meta"][:, :, 5].sum(1) > 0).all()
    short = (planes["meta"][:, :, 4] != 0).any()
    if case == "books_short":
        assert short
    elif case in ("books_long", "intensity", "pulse", "sf_edges"):
        assert not short
    if case in ("cce", "multichannel"):
        assert planes["cce_counts"].any()
    if case == "books_long":
        # the escape values reach the rows: |q|^(4/3) past the LUT
        assert np.abs(planes["spec"]).max() > 8193 ** (4 / 3)


def _valid_frame(rng, cfg) -> bytes:
    """A CPE frame through every book and escapes, PNS, intensity, M/S."""
    left = random_channel_spec(rng, cfg, allow_pulse=False)
    right = random_channel_spec(
        rng, cfg, window_sequence=left.window_sequence,
        grouping=left.grouping, max_sfb=left.max_sfb,
        window_shape=left.window_shape, allow_intensity=True)
    _cover_books(rng, left, cfg, int(rng.integers(11)))
    _cover_books(rng, right, cfg, int(rng.integers(11)))
    n_idx = left.group_count * left.max_sfb
    return _frame(("CPE", enc.CPESpec(
        left=left, right=right, common_window=True, ms_type=1,
        ms_used=(rng.random(n_idx) < 0.5).astype(np.int64))), cfg=cfg)


def _flip(data: bytes, rng, n: int, lo: int) -> bytes:
    out = bytearray(data)
    for _ in range(n):
        out[int(rng.integers(lo, len(out)))] ^= 1 << int(rng.integers(8))
    return bytes(out)


def _overlong_escape_frame(rng, cfg) -> bytes:
    """A mono frame whose escape value 2^25 takes a prefix of 21 ones: the
    parser's "escape too long"."""
    s = _edge_channel(rng, cfg, [100, 100, 100], [11, 11, 11], 100)
    s.quant[int(cfg.swb_offsets_long[1]) + 1] = 2 ** 25
    return _frame(("SCE", s), cfg=cfg)


@pytest.mark.parametrize("seed", range(15))
def test_corrupt_frames_end_the_same(seed, monkeypatch):
    """Mutated frames (bit flips past the side info) and truncated ones,
    between good frames of the same streams: the port's statuses, error
    message, consumed bits, concealed rows and every other plane are the
    JAX library's."""
    monkeypatch.setenv("AACJAX_PARSE_THREADS", "4" if seed % 2 else "1")
    rng = np.random.default_rng(2000 + seed)
    cfg, mono = _lc(), _lc(1)
    streams, configs = [], []
    for k in range(8):
        good = [_valid_frame(rng, cfg) for _ in range(3)]
        frame = good[1]
        if k < 4:
            bad = _flip(frame, rng, int(rng.integers(1, 6)),
                        lo=len(frame) // 4)
        else:
            bad = frame[:int(rng.integers(1, len(frame)))]
        streams.append([good[0], bad, good[2]])
        configs.append(cfg)
    for n_slots, extra in ((2, None), (1, _overlong_escape_frame(rng, mono))):
        if extra is None:
            status, _, _, planes = _compare(configs, streams, n_slots, 3)
            assert (status[4:] != 0).all()   # every truncation fails
            # a failed frame is concealed: silent but present
            bad_rows = planes["spec"][:, 1][np.repeat(status != 0, 2)]
            assert not bad_rows.any()
        else:
            status, _, msg, _ = _compare([mono], [[extra]], n_slots, 1)
            assert status[0] == native.ERR_BITSTREAM
            assert "escape too long" in msg


def test_every_truncation_ends_the_same(monkeypatch):
    """One frame with escapes cut at every byte: the per-band check at the
    end of each band gives the JAX library's outcome at every length."""
    monkeypatch.setenv("AACJAX_PARSE_THREADS", "4")
    rng = np.random.default_rng(2000)
    frame = _valid_frame(rng, _lc())
    cuts = [[frame[:n]] for n in range(1, len(frame) + 1)]
    status, _, _, _ = _compare([_lc()] * len(cuts), cuts, 2, 1)
    assert status[-1] == 0 and (status[:-1] != 0).all()


def test_traced_parse_counts_bands(monkeypatch):
    """A traced `_parse_native` records the three band counters under the
    chunk: an LC chunk's bands all fused, every gain from the table; PNS
    and intensity count on the general path; an untraced call asks for no
    counts."""
    configs, chunks = make_lc_payload_chunks(n_streams=2, chunk_frames=4)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    dec.trace = Trace()
    dec._parse_native(chunks[0], compact=True, chunk_id=0)
    c = dec.trace.counters
    assert c[("parse_fused_bands", 0)] > 0
    assert c[("parse_general_bands", 0)] == 0
    assert c[("parse_gain_table_misses", 0)] == 0

    mixed = [_intensity_frames(4, 1), _random_frames(4, 2)]
    dec = aacjax_torch.BatchDecoder([_lc()] * 2, chunk_frames=4,
                                    device="cpu")
    dec.trace = Trace()
    dec._parse_native(mixed, compact=True, chunk_id=3)
    assert dec.trace.counters[("parse_general_bands", 3)] > 0
    assert dec.trace.counters[("parse_fused_bands", 3)] > 0

    seen = []
    parse = native.parse_batch_spec

    def spy(*args, **kw):
        seen.append("counts" in kw)
        return parse(*args, **kw)
    monkeypatch.setattr(native, "parse_batch_spec", spy)
    dec.trace = None
    dec._parse_native(mixed, compact=True)
    assert seen == [False]


@pytest.mark.parametrize("case,want", [
    ("books_long", "fused"), ("pulse", "general"), ("cce", "both"),
    ("sf_edges", "misses")])
def test_counts_by_path(case, want, monkeypatch):
    """The counts of a direct parse: the same under 1 and 4 threads; a
    channel with pulse data and a coupling channel decode on the general
    path, and so does every channel of a stream while it rides q/sf;
    scale factors below the table miss it."""
    configs, chunk, n_slots, opts = _case(case)
    got = []
    for threads in ("1", "4"):
        monkeypatch.setenv("AACJAX_PARSE_THREADS", threads)
        counts = np.zeros(3, np.int64)
        _parse(native, configs, chunk, n_slots, T, counts=counts, **opts)
        got.append(counts)
    np.testing.assert_array_equal(got[0], got[1])
    fused, general, misses = got[0]
    assert {"fused": fused > 0 and misses == 0,
            "general": fused == 0 and general > 0,
            "both": fused > 0 and general > 0,
            "misses": misses > 0}[want]
    qsf = np.zeros(3, np.int64)
    _parse(native, configs, chunk, n_slots, T, want_qsf=True, counts=qsf,
           **opts)
    assert qsf[0] + qsf[1] == fused + general and qsf[2] == misses
    assert qsf[0] < fused if fused else qsf[0] == 0
