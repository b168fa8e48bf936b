"""Corrupt input through the port: the cases of tests/test_fuzz.py (random
garbage and bit-flipped streams) on aacjax_torch, on the CPU.

The rule is the reference's: finite PCM, or a clean BitstreamError /
UnsupportedError, never a crash, a NaN or another stream's corruption.  On
top of it the port must end the same way as aacjax on the same bytes:
either both raise an error of the same class, or both return PCM of the
same shape within the tolerances of the port's other tests (2e-4 *
max(1, max|ref|) for the core, HE_ROUTE_TOL = 1e-3 for HE-AAC).  The HE
mutations run through the port on every seed, and through aacjax on only
four of them, in one test: the JAX HE program is what grows an xdist
worker's memory."""
import pathlib
import sys

import numpy as np
import pytest

import aacjax
import aacjax_torch
from aacjax.host import native as j_native
from aacjax.host.bitio import BitReader as JBitReader
from aacjax.host.syntax import decode_frame as j_decode_frame
from aacjax.runtime.batch import BatchDecoder as JBatchDecoder
from aacjax_torch.host import native
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.host.bitio import BitReader, BitWriter
from aacjax_torch.host.syntax import decode_frame
from aacjax_torch.runtime.batch import BatchDecoder
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import random_channel_spec, random_cpe_spec

CORE_TOL = 2e-4
HE_ROUTE_TOL = 1e-3
CLEAN = ("BitstreamError", "BitstreamUnderflow", "UnsupportedError")


def _cfg(si=4, ch=2):
    return parse_asc(make_asc(2, si, ch))


def _outcome(fn):
    """('ok', result) or ('raise', the error's class name)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return "raise", type(e).__name__


def _same_end(got, want, tol: float, what: str):
    """The port ends as the reference does: the same error class, or PCM of
    the same shape within tol * max(1, max|ref|), finite."""
    assert got[0] == want[0], (what, got, want)
    if got[0] == "raise":
        assert got[1] == want[1], what
        assert got[1] in CLEAN, what
        return
    (pcm, rate), (ref, ref_rate) = got[1], want[1]
    assert rate == ref_rate and pcm.shape == ref.shape, what
    assert np.isfinite(pcm).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= tol * scale, what


def _flip(data: bytes, rng, n: int, lo: int = 0) -> bytes:
    out = bytearray(data)
    for _ in range(n):
        out[int(rng.integers(lo, len(out)))] ^= 1 << int(rng.integers(8))
    return bytes(out)


@pytest.mark.parametrize("seed", range(20))
def test_python_parser_survives_garbage(seed):
    """Random bytes through the port's parser: a parsed frame or a clean
    error, the same class as the reference's parser on the same bytes."""
    rng = np.random.default_rng(seed)
    si = int(rng.integers(0, 12))
    data = rng.integers(0, 256, size=int(rng.integers(4, 600))).astype(
        np.uint8).tobytes()
    got = _outcome(lambda: decode_frame(BitReader(data), _cfg(si), [0, 0]))
    want = _outcome(lambda: j_decode_frame(
        JBitReader(data), aacjax.parse_asc(make_asc(2, si, 2)), [0, 0]))
    assert got[0] == want[0]
    if got[0] == "raise":
        assert got[1] == want[1] and got[1] in CLEAN


def _native_parse(mod, payloads, si):
    out = mod.SpecBatchArrays(2, len(payloads))
    status, _, _err = mod.parse_batch_spec(
        [payloads], np.array([si], np.int32), np.array([2], np.int32),
        np.array([0], np.int32), np.array([2], np.int32),
        np.zeros(2, np.int32), out)
    return np.asarray(status), out


def _lc_step(payloads, config, cls, **kw):
    dec = cls([config], chunk_frames=len(payloads), use_native=True, **kw)
    pcm = np.asarray(dec.step_raw([payloads], out_int16=False))
    return pcm, dec.streams[0].failed


@pytest.mark.skipif(not native.available(), reason="native parser not built")
@pytest.mark.parametrize("seed", range(20))
def test_native_parser_survives_garbage(seed):
    """Garbage payloads through the port's copy of the native binding: the
    same status and finite planes as the reference's binding; through the
    port's BatchDecoder, finite PCM and the same failed flag as aacjax's,
    with PCM within the core tolerance."""
    rng = np.random.default_rng(1000 + seed)
    si = int(rng.integers(0, 12))
    config = _cfg(si)
    payloads = [rng.integers(0, 256, size=int(rng.integers(4, 600))).astype(
        np.uint8).tobytes() for _ in range(3)]
    status, out = _native_parse(native, payloads, si)
    j_status, j_out = _native_parse(j_native, payloads, si)
    np.testing.assert_array_equal(status, j_status)
    assert np.isfinite(out.spec).all()
    np.testing.assert_array_equal(out.spec, j_out.spec)
    pcm, failed = _lc_step(payloads, config, BatchDecoder, device="cpu")
    ref, ref_failed = _lc_step(payloads, aacjax.parse_asc(make_asc(2, si, 2)),
                               JBatchDecoder)
    assert failed == ref_failed and np.isfinite(pcm).all()
    assert pcm.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= CORE_TOL * scale


@pytest.mark.skipif(not native.available(), reason="native parser not built")
@pytest.mark.parametrize("seed", range(15))
def test_native_parser_survives_mutations(seed):
    """Random bit flips in a valid CPE frame: the port's parse and decode
    stay finite and end as the reference's do on the same bytes."""
    rng = np.random.default_rng(2000 + seed)
    config = _cfg()
    w = BitWriter()
    enc.write_cpe(w, random_cpe_spec(rng, config), config)
    payload = _flip(enc.end_frame(w), rng, int(rng.integers(1, 6)))
    status, out = _native_parse(native, [payload], 4)
    j_status, j_out = _native_parse(j_native, [payload], 4)
    np.testing.assert_array_equal(status, j_status)
    assert np.isfinite(out.spec).all() and np.isfinite(out.tns_lpc).all()
    pcm, failed = _lc_step([payload], config, BatchDecoder, device="cpu")
    ref, ref_failed = _lc_step([payload], aacjax.parse_asc(make_asc(2, 4, 2)),
                               JBatchDecoder)
    assert failed == ref_failed and np.isfinite(pcm).all()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pcm - ref).max()) <= CORE_TOL * scale


@pytest.mark.skipif(not native.available(), reason="native parser not built")
def test_corrupt_stream_cannot_poison_batch():
    """Garbage streams decode beside a good stream in the same chunk; the
    good stream's PCM equals its solo decode bit for bit on the CPU, and
    the garbage streams fail alone."""
    rng = np.random.default_rng(3)
    config = _cfg()
    good = []
    for _ in range(2):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, config), config)
        good.append(enc.end_frame(w))
    garbage = [rng.integers(0, 256, size=200).astype(np.uint8).tobytes()
               for _ in range(2)]
    both = BatchDecoder([config] * 2, chunk_frames=2, use_native=True,
                        device="cpu")
    pcm = both.step_raw([good, garbage])
    solo = BatchDecoder([config], chunk_frames=2, use_native=True,
                        device="cpu")
    want = solo.step_raw([good])
    np.testing.assert_array_equal(pcm[:2], want[:2])
    assert [st.failed for st in both.streams] == [False, True]


def _he_mutant(seed: int) -> bytes:
    """The reference's HE/PS mutation case for `seed`: an HE-AAC v1 mono or
    a PS stream with a few bits flipped in its back half (the SBR FIL
    extension rides at a frame's tail)."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_ps import PSSpec, make_ps_stream
    from test_sbr import make_he_stream
    rng = np.random.default_rng(seed)
    if seed % 2:
        stream = make_he_stream(ch=1, n_frames=4, seed=seed)
    else:
        stream = make_ps_stream(PSSpec(
            iid_mode=0, iid_par=rng.integers(-7, 8, (1, 10))), n_frames=4,
            seed=seed)
    out = bytearray(stream)
    for _ in range(4):
        pos = int(rng.integers(len(out) // 2, len(out)))
        out[pos] ^= 1 << int(rng.integers(8))
    return bytes(out)


@pytest.mark.parametrize("seed", range(12))
def test_he_aac_survives_mutations(seed):
    """Bit-flipped HE-AAC v1 / v2 streams through the port's decode_adts
    (on_error='skip'): finite PCM or a clean error."""
    got = _outcome(lambda: aacjax_torch.decode_adts(
        _he_mutant(seed), chunk_frames=4, on_error="skip", device="cpu"))
    if got[0] == "raise":
        assert got[1] in CLEAN
    else:
        assert np.isfinite(got[1][0]).all()


def test_he_mutations_match_reference():
    """Four of the HE / PS mutation cases (two of each) end the same way in
    the port and in aacjax, PCM within HE_ROUTE_TOL."""
    for seed in (0, 1, 2, 7):
        data = _he_mutant(seed)
        got = _outcome(lambda: aacjax_torch.decode_adts(
            data, chunk_frames=4, on_error="skip", device="cpu"))
        want = _outcome(lambda: aacjax.decode_adts(data, chunk_frames=4,
                                                   on_error="skip"))
        _same_end(got, want, HE_ROUTE_TOL, f"seed {seed}")


def test_ps_parser_survives_garbage():
    """Random bytes through the port's read_ps_data: a parsed struct or a
    clean error, as the reference's parser ends on the same bytes."""
    from aacjax.host.bitio import BitReader as JR
    from aacjax.host.ps import PSContext as JCtx
    from aacjax.host.ps import read_ps_data as j_read
    from aacjax_torch.host.ps import PSContext, read_ps_data
    for seed in range(50):
        rng = np.random.default_rng(1000 + seed)
        data = rng.integers(0, 256, size=int(rng.integers(2, 40))).astype(
            np.uint8).tobytes()
        ctx, j_ctx = PSContext(), JCtx()
        ctx.header_seen = j_ctx.header_seen = bool(seed % 2)
        got = _outcome(lambda: read_ps_data(BitReader(data), ctx,
                                            len(data) * 8))
        want = _outcome(lambda: j_read(JR(data), j_ctx, len(data) * 8))
        assert got[0] == want[0], seed
        if got[0] == "raise":
            assert got[1] == want[1] and got[1] in (
                "BitstreamError", "BitstreamUnderflow"), seed


@pytest.mark.parametrize("seed", range(10))
def test_loas_survives_mutations(seed):
    """Bit-flipped LOAS streams: the port's decode_loas (on_error='skip')
    ends as aacjax's does on the same bytes."""
    rng = np.random.default_rng(2000 + seed)
    config = _cfg()
    payloads = []
    for _ in range(5):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, config, common=True), config)
        payloads.append(enc.end_frame(w))
    stream = _flip(enc.loas_stream(payloads, config,
                                   subframes=1 if seed % 2 else 5), rng, 3)
    got = _outcome(lambda: aacjax_torch.decode_loas(stream, on_error="skip",
                                                    device="cpu"))
    want = _outcome(lambda: aacjax.decode_loas(stream, on_error="skip"))
    _same_end(got, want, CORE_TOL, f"seed {seed}")


@pytest.mark.parametrize("seed", range(10))
def test_eld_survives_mutations(seed):
    """Bit-flipped AAC-ELD LOAS streams (tagless ER layout, low-delay
    filterbank): the port ends as aacjax does on the same bytes."""
    rng = np.random.default_rng(7000 + seed)
    config = parse_asc(make_asc(39, 4, 1,
                                frame_length=480 if seed % 2 else 512))
    payloads = [enc.write_eld_frame(
        [("SCE", random_channel_spec(rng, config, window_sequence=0,
                                     allow_pulse=False,
                                     allow_noise=False))], config)
        for _ in range(4)]
    stream = _flip(enc.loas_stream(payloads, config), rng, 3)
    got = _outcome(lambda: aacjax_torch.decode_loas(stream, on_error="skip",
                                                    device="cpu"))
    want = _outcome(lambda: aacjax.decode_loas(stream, on_error="skip"))
    _same_end(got, want, CORE_TOL, f"seed {seed}")
