"""The port's mesh (aacjax_torch/runtime/mesh.py) on the CPU: the cases of
tests/test_sharding.py and more, over make_mesh(..., devices=[cpu] * 8),
each holding the sharded result (a) to the port's own unsharded call and
(b) to aacjax's single-device call on the same bytes, in-process.

Tolerances: core f32 PCM within 5e-5 * max(1, max|ref|), int16 within 1 LSB
on < 2% of samples (testing.assert_pcm_close); HE and PS PCM within
HE_ROUTE_TOL = 1e-3 * max(1, max|ref|) (the SBR program amplifies a
last-bit core difference about a hundredfold, tests/test_torch_he_bound.py,
and on the CPU a shard's matrix products may round differently from the
whole batch's); the encoder byte-identical to its unsharded run, and held
to aacjax's as tests/test_torch_encode_batch.py holds it (decoded SNR within
0.5 dB).  Shapes are picked so that a shard takes the route the unsharded
chunk takes where the route depends on the slot count (the fused tail needs
C % 8 == 0): 4 stereo streams a stream shard where a case allows it.
"""
import numpy as np
import pytest
import torch

import aacjax
from aacjax.host import native
from aacjax.runtime.batch import BatchDecoder as JaxDecoder
from aacjax_torch import graft_entry as G
from aacjax_torch import testing as TI
from aacjax_torch.host import adts
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.runtime.batch import BatchDecoder
from aacjax_torch.runtime.pack import pack_frames
from aacjax_torch.testing import assert_pcm_close
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import random_channel_spec, random_cpe_spec
from aacjax_torch.testing.streams import make_lc_payload_chunks

CPU = torch.device("cpu")
HE_ROUTE_TOL = 1e-3
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native parser not built")


@pytest.fixture(scope="module", autouse=True)
def _free_xla_programs():
    """Drop aacjax's compiled XLA programs when the module is done, and
    hand the freed heap back: a test worker keeps every program it
    compiled, and the HE ones are large (scripts/test_rss.py measures what
    the module leaves to the tests after it)."""
    yield
    import ctypes
    import gc

    import jax
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)   # hand the freed heap back
    except OSError:                               # not glibc
        pass


def mesh(n_stream, n_frame=1):
    return meshlib.make_mesh(n_stream, n_frame, devices=[CPU] * 8)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _he_close(got, want, what):
    err = _rel(got, want)
    assert err <= HE_ROUTE_TOL, f"{what}: {err:.3g} * max(1, max|ref|)"
    assert np.abs(np.asarray(want)).max() > 0, f"{what}: silent reference"


def _payloads(stream):
    return [stream[s:e] for _, s, e in adts.split_frames(stream)]


def _config(stream):
    return parse_asc(adts.synthesize_cookie(adts.split_frames(stream)[0][0]))


# -- the python packer's decode_step ------------------------------------------
def test_sharded_matches_single_device():
    """4x2 decode_step on graft_entry's example chunk (stereo CPE, M/S,
    window switching, TNS): the PCM and the carry equal the port's
    unsharded step and aacjax's jitted step on the same frames."""
    import __graft_entry__ as graft
    from aacjax.kernels.pipeline import jitted_decode_step
    batch, overlap, flags = G._example_chunk(n_streams=4, T=4)
    ref_pcm, ref_ov = P.decode_step(
        {k: meshlib.packed_tensor(k, v, CPU) for k, v in batch.items()},
        torch.from_numpy(overlap), flags)
    m = mesh(4, 2)
    lay = meshlib.layout(m, [2] * 4, 4)
    pcm, ov = meshlib.sharded_decode_step(flags, m)(
        meshlib.shard_batch(m, batch, lay), torch.from_numpy(overlap))
    pcm, ov = meshlib.gather(pcm, CPU), meshlib.gather(ov, CPU)
    assert_pcm_close(pcm, ref_pcm, False, "pcm against the port")
    assert _rel(ov, ref_ov) <= 5e-5
    jb, jov, jflags = graft._example_chunk(n_streams=4, T=4)
    j_pcm, j_ov = jitted_decode_step(jflags)(jb, jov.copy())
    assert_pcm_close(pcm, np.asarray(j_pcm), False, "pcm against aacjax")
    assert _rel(ov, np.asarray(j_ov)) <= 5e-5


@pytest.mark.parametrize("profile,frame_length", [(23, 512), (39, 512)])
def test_sharded_ld_eld_matches_single_device(profile, frame_length):
    """LD and ELD on 4x2 through the python packer: two frames a frame
    shard, so the ELD halo (three frames back) reaches the chunk's start and
    the carry in; a carry of random values makes that count."""
    from aacjax.kernels.pipeline import jitted_decode_step
    from aacjax.runtime.pack import pack_frames as jax_pack
    rng = np.random.default_rng(41)
    cfg = parse_asc(make_asc(profile, 4, 1, frame_length=frame_length))
    payloads = []
    for _ in range(4):
        spec = random_channel_spec(rng, cfg, window_sequence=0,
                                   allow_pulse=False, allow_noise=False)
        payloads.append(enc.write_eld_frame([("SCE", spec)], cfg)
                        if profile == 39
                        else enc.write_er_frame([("SCE", spec)], cfg))
    eld = profile == 39
    dec = BatchDecoder([cfg] * 4, chunk_frames=4, use_native=False,
                       device="cpu")
    jdec = JaxDecoder([cfg] * 4, chunk_frames=4, use_native=False)
    per_slot, j_slot = [], []
    for i in range(4):
        per_slot.append((i, dec.parse_stream_frames(i, payloads)))
        j_slot.append((i, jdec.parse_stream_frames(i, payloads)))
    batch, flags = pack_frames(per_slot, 4, 4, frame_len=frame_length,
                               eld=eld)
    ov_len = 3 * frame_length if eld else frame_length
    overlap = (np.random.default_rng(3).standard_normal((4, ov_len))
               * 100).astype(np.float32)
    ref = P.decode_step({k: meshlib.packed_tensor(k, v, CPU)
                         for k, v in batch.items()},
                        torch.from_numpy(overlap), flags)
    m = mesh(4, 2)
    lay = meshlib.layout(m, [1] * 4, 4, halo=3 if eld else 1)
    got = meshlib.sharded_decode_step(flags, m)(
        meshlib.shard_batch(m, batch, lay), torch.from_numpy(overlap))
    jb, jflags = jax_pack(j_slot, 4, 4, frame_len=frame_length, eld=eld)
    want = jitted_decode_step(jflags)(jb, overlap.copy())
    for name, g, r, w in zip(("pcm", "overlap"), got, ref, want):
        g = meshlib.gather(g, CPU)
        assert _rel(g, r) <= 5e-5, name
        assert _rel(g, np.asarray(w)) <= 5e-5, name


# -- the native spec path -----------------------------------------------------
def _cpe_chunks(n_streams, T, n_chunks, seed):
    rng = np.random.default_rng(seed)
    config = parse_asc(make_asc(2, 4, 2))
    chunks = []
    for _ in range(n_chunks):
        per_stream = []
        for _ in range(n_streams):
            pays = []
            for _ in range(T):
                w = BitWriter()
                enc.write_cpe(w, random_cpe_spec(rng, config, common=True),
                              config)
                pays.append(enc.end_frame(w))
            per_stream.append(pays)
        chunks.append(per_stream)
    return config, chunks


@needs_native
def test_sharded_spec_path_matches_single_device():
    """The production spec path (compact int16 spectra, TNS, concealment)
    on 4x2 over two chunks, with a corrupt stream whose frames from the
    second on conceal: 4 stereo streams, as in the reference's case (on the
    card the whole chunk would take the fused tail and its 2-slot shards
    the synthesis kernel; here both are the plain version)."""
    config, chunks = _cpe_chunks(4, 4, 2, seed=5)
    chunks[0][2][1] = b"\x00\x41"          # SCE element truncated mid-header

    def run(make, mesh=None):
        dec = make([config] * 4, chunk_frames=4, use_native=True)
        outs = []
        for c in chunks:
            batch = dec._parse_native(c, compact=True)
            pcm = (dec._device_step(batch, out_int16=False) if mesh is None
                   else dec._device_step(batch, mesh=mesh))
            outs.append(np.asarray(dec.finalize_step(pcm)).copy())
        assert dec.streams[2].failed
        return outs

    def port(*a, **kw):
        return BatchDecoder(*a, device="cpu", **kw)

    want = run(port)
    jax_want = run(JaxDecoder)
    got = run(port, mesh(4, 2))
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        assert_pcm_close(g, w, False, f"chunk {k} against the port")
        assert_pcm_close(g, j, False, f"chunk {k} against aacjax")


@needs_native
def test_sharded_qsf_spec_path_matches_single_device():
    """The exact q/sf spectra (the HE core's transfer) on 4x2: 4 mono
    streams (no shard, and not the whole chunk, takes the fused tail)."""
    rng = np.random.default_rng(11)
    config = parse_asc(make_asc(2, 4, 1))
    per_stream = []
    for _ in range(4):
        pays = []
        for _ in range(4):
            w = BitWriter()
            enc.write_sce(w, random_channel_spec(rng, config,
                                                 allow_noise=False), config)
            pays.append(enc.end_frame(w))
        per_stream.append(pays)
    outs = []
    for make, m in ((BatchDecoder, None), (JaxDecoder, None),
                    (BatchDecoder, mesh(4, 2))):
        kw = dict(device="cpu") if make is BatchDecoder else {}
        dec = make([config] * 4, chunk_frames=4, use_native=True, **kw)
        batch = dec._parse_native(per_stream, qsf=True, compact=False)
        assert batch["_spec_qsf"]
        pcm = (dec._device_step(batch, out_int16=False) if m is None
               else dec._device_step(batch, mesh=m))
        outs.append(np.asarray(dec.finalize_step(pcm)))
    assert_pcm_close(outs[2], outs[0], False, "against the port")
    assert_pcm_close(outs[2], outs[1], False, "against aacjax")


@needs_native
def test_decode_pipelined_sharded_matches_single_device():
    """The whole serving loop on 4x2 with int16 PCM, with a slot recycled
    through request_reset after the first chunk (it waits for the chunk
    boundary)."""
    configs, chunks = make_lc_payload_chunks(n_streams=4, chunk_frames=4,
                                             n_chunks=3, seed=7)

    def run(dec, m=None):
        out = []
        kw = {} if m is None else dict(mesh=m)
        for k, pcm in enumerate(dec.decode_pipelined(
                iter(chunks), out_int16=True, compact=True, **kw)):
            out.append(np.asarray(pcm).copy())
            if k == 0:
                dec.request_reset(1, configs[1])
        return out

    want = run(BatchDecoder(configs, chunk_frames=4, device="cpu"))
    jax_want = run(JaxDecoder(configs, chunk_frames=4, use_native=True))
    got = run(BatchDecoder(configs, chunk_frames=4, device="cpu"), mesh(4, 2))
    assert len(got) == len(want) == len(jax_want) == 3
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        assert_pcm_close(g, w, True, f"chunk {k} against the port")
        assert_pcm_close(g, j, True, f"chunk {k} against aacjax")


def _chunks_of(corpus, n_streams, T, n_chunks):
    per = [corpus[i % len(corpus)] for i in range(n_streams)]
    return [[p[k * T:(k + 1) * T] for p in per] for k in range(n_chunks)]


@needs_native
@pytest.mark.parametrize("kind", ["main", "coupling"])
def test_frame_sharded_main_and_coupling(kind):
    """2x2 on the frame axis: Main-profile streams (the predictor's state
    handed from frame shard to frame shard, bit for bit the unsharded
    state) and 5.1 streams with two coupling slots whose entries after TNS
    and on the PCM select and rebase per shard (2 coupling slots x 2
    streams x 4 frames x 2 targets = 32 entries, within the reference's
    post_cap of 64).  f32 PCM over two chunks of 2 streams, one a stream
    shard."""
    if kind == "main":
        config, corpus = TI.main_serving_corpus(2, 8)
        kw = {}
    else:
        config = TI.multichannel_config(6)
        corpus = [TI.multichannel_payloads(6, 8, seed=i, coupling=True)
                  for i in range(2)]
        kw = dict(cce_slots=2)
    chunks = _chunks_of(corpus, 2, 4, 2)

    def run(dec, m=None):
        extra = {} if m is None else dict(mesh=m)
        return [np.asarray(p).copy() for p in dec.decode_pipelined(
            iter(chunks), out_int16=False, compact=True, **extra)], dec

    want, d0 = run(BatchDecoder([config] * 2, chunk_frames=4, device="cpu",
                                **kw))
    jax_want, _ = run(JaxDecoder([config] * 2, chunk_frames=4,
                                 use_native=True, **kw))
    got, d1 = run(BatchDecoder([config] * 2, chunk_frames=4, device="cpu",
                               **kw), mesh(2, 2))
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        assert np.abs(w).max() > 0
        assert_pcm_close(g, w, False, f"{kind} chunk {k} against the port")
        assert_pcm_close(g, j, False, f"{kind} chunk {k} against aacjax")
    if kind == "main":
        assert torch.equal(d1._pred_state, d0._pred_state)
    assert _rel(d1.overlap, d0.overlap) <= 5e-5


# -- HE-AAC -------------------------------------------------------------------
@pytest.fixture(scope="module")
def he():
    stream = TI.he_stream(n_frames=6)
    return _config(stream), _payloads(stream)


@pytest.mark.parametrize("use_native,shape,chunk", [
    pytest.param(True, (4, 1), 3, marks=needs_native),
    (False, (4, 1), 3),
    pytest.param(True, (2, 2), 2, marks=needs_native)])
def test_sharded_he_sbr_matches_single_device(he, use_native, shape, chunk):
    """step_he_raw on 4 stereo HE streams over the mesh (the core sharded,
    then each stream shard's SBR program; on 2x2 the core's frame shards
    gather on their row's device first) across chunk boundaries."""
    config, payloads = he
    los = range(0, 6, chunk)

    def run(make, m=None, **kw):
        dec = make([config] * 4, chunk_frames=chunk, use_native=use_native,
                   **kw)
        extra = {} if m is None else dict(mesh=m)
        return [np.asarray(dec.step_he_raw(
            [payloads[lo:lo + chunk]] * 4, compact=True, **extra))
            for lo in los]

    want = run(BatchDecoder, device="cpu")
    jax_want = run(JaxDecoder)
    got = run(BatchDecoder, mesh(*shape), device="cpu")
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        _he_close(g, w, f"chunk {k} against the port")
        _he_close(g, j, f"chunk {k} against aacjax")


@needs_native
def test_sharded_he_ps_matches_single_device():
    """HE-AAC v2 on 4x1: 4 mono PS streams with a spare slot each (the
    right channel, routed inside the shard), IPD/OPD in 5 bands, the PS
    state carried across the chunk boundary."""
    stream = TI.ps_stream(TI.ps_specs()["20-band"], n_frames=6)
    config, payloads = _config(stream), _payloads(stream)

    def run(make, m=None, **kw):
        dec = make([config] * 4, chunk_frames=3, cce_slots=1, **kw)
        extra = {} if m is None else dict(mesh=m)
        return [np.asarray(dec.step_he_raw([payloads[lo:lo + 3]] * 4,
                                           compact=True, **extra))
                for lo in (0, 3)]

    want = run(BatchDecoder, device="cpu")
    jax_want = run(JaxDecoder)
    got = run(BatchDecoder, mesh(4, 1), device="cpu")
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        _he_close(g, w, f"chunk {k} against the port")
        _he_close(g, j, f"chunk {k} against aacjax")
        assert np.abs(g[1::2]).max() > 0          # the right channels


@needs_native
def test_decode_he_pipelined_sharded_matches_single_device(he):
    config, payloads = he
    chunks = [[payloads[lo:lo + 3]] * 4 for lo in (0, 3)]

    def run(make, m=None, **kw):
        dec = make([config] * 4, chunk_frames=3, use_native=True, **kw)
        extra = {} if m is None else dict(mesh=m)
        return [np.asarray(p).copy() for p in dec.decode_he_pipelined(
            iter(chunks), out_int16=False, compact=True, **extra)]

    want = run(BatchDecoder, device="cpu")
    jax_want = run(JaxDecoder)
    got = run(BatchDecoder, mesh(4, 1), device="cpu")
    assert len(got) == len(want) == len(jax_want) == 2
    for k, (g, w, j) in enumerate(zip(got, want, jax_want)):
        _he_close(g, w, f"chunk {k} against the port")
        _he_close(g, j, f"chunk {k} against aacjax")


# -- one decoder across meshes, resets and checkpoints ------------------------
# (tests/conftest.py makes aacjax's transfer exact by default; the calls here
# ask both packages for the compact one)
def _lc_calls(n_chunks):
    configs, chunks = make_lc_payload_chunks(n_streams=8, chunk_frames=4,
                                             n_chunks=n_chunks, seed=3)
    return configs, chunks


def _step(dec, chunk, m, kind):
    """One chunk through the decoder with mesh `m` (None: none)."""
    if kind == "he":
        return np.asarray(dec.step_he_raw(chunk, mesh=m)).copy()
    if m is None:
        return dec.step_raw(chunk)
    return dec.finalize_step(dec._device_step(
        dec._parse_native(chunk, compact=True), mesh=m)).copy()


def _he_chunks(n_chunks):
    """4 HE streams whose every frame carries the SBR header (a stream
    reset mid-way restarts from any frame)."""
    from aacjax_torch.host import sbr
    hdr = sbr.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    stream = TI.he_stream(n_frames=2 * n_chunks,
                          header_at={f: hdr for f in range(2 * n_chunks)})
    payloads = _payloads(stream)
    return ([_config(stream)] * 4,
            [[payloads[lo:lo + 2]] * 4 for lo in range(0, 2 * n_chunks, 2)])


@needs_native
@pytest.mark.parametrize("kind", ["lc", "he"])
def test_state_across_mesh_changes(kind):
    """One decoder takes chunks on a 4x2 mesh, then none, then a 2x1 mesh,
    then another: its carried state (overlap, SBR state) is gathered and
    re-split between calls, and every chunk equals the unsharded decoder's
    and aacjax's."""
    configs, chunks = (_lc_calls if kind == "lc" else _he_chunks)(4)
    if kind == "he":
        meshes = [mesh(4, 1), None, mesh(2, 1), mesh(2, 2)]
        chunk_frames = 2
    else:
        meshes = [mesh(4, 2), None, mesh(2, 1), mesh(4, 1)]
        chunk_frames = 4
    dec = BatchDecoder(configs, chunk_frames=chunk_frames, device="cpu")
    ref = BatchDecoder(configs, chunk_frames=chunk_frames, device="cpu")
    jax_ref = JaxDecoder(configs, chunk_frames=chunk_frames)
    for k, (c, m) in enumerate(zip(chunks, meshes)):
        got = _step(dec, c, m, kind)
        want = _step(ref, c, None, kind)
        j = (np.asarray(jax_ref.step_he_raw(c, compact=True))
             if kind == "he" else jax_ref.step_raw(c, compact=True))
        if kind == "he":
            _he_close(got, want, f"chunk {k} against the port")
            _he_close(got, j, f"chunk {k} against aacjax")
        else:
            assert_pcm_close(got, want, False, f"chunk {k} against the port")
            assert_pcm_close(got, j, False, f"chunk {k} against aacjax")
    assert isinstance(dec._ov, meshlib.RowBlocks)
    assert _rel(dec.overlap, ref.overlap) <= 5e-5
    assert isinstance(dec._ov, torch.Tensor)


@needs_native
@pytest.mark.parametrize("kind", ["lc", "he"])
def test_reset_and_checkpoint_between_sharded_chunks(kind):
    """Between sharded chunks: reset_stream(1) zeroes stream 1's rows where
    they lie (in their row block), and save_state after the second chunk,
    restored into a fresh decoder, replays the third chunk sharded as the
    original does; all against the unsharded decoder and aacjax doing the
    same."""
    configs, chunks = (_lc_calls if kind == "lc" else _he_chunks)(3)
    T = 4 if kind == "lc" else 2
    m = mesh(4, 2) if kind == "lc" else mesh(4, 1)

    def drive(dec, m, jax=False):
        outs = []
        for k, c in enumerate(chunks):
            if jax:
                outs.append(np.asarray(dec.step_he_raw(c, compact=True))
                            if kind == "he" else dec.step_raw(c, compact=True))
            else:
                outs.append(_step(dec, c, m, kind))
            if k == 0:
                dec.reset_stream(1)
            if k == 1:
                saved = dec.save_state()
        return outs, saved

    got, saved = drive(BatchDecoder(configs, chunk_frames=T, device="cpu"),
                       m)
    want, _ = drive(BatchDecoder(configs, chunk_frames=T, device="cpu"),
                    None)
    jax_want, _ = drive(JaxDecoder(configs, chunk_frames=T), None, jax=True)
    fresh = BatchDecoder(configs, chunk_frames=T, device="cpu")
    fresh.restore_state(saved)
    again = _step(fresh, chunks[2], m, kind)
    for k, (g, w, j) in enumerate(zip(got + [again], want + [want[2]],
                                      jax_want + [jax_want[2]])):
        if kind == "he":
            _he_close(g, w, f"chunk {k} against the port")
            _he_close(g, j, f"chunk {k} against aacjax")
        else:
            assert_pcm_close(g, w, False, f"chunk {k} against the port")
            assert_pcm_close(g, j, False, f"chunk {k} against aacjax")
    np.testing.assert_array_equal(again, got[2])


# -- the encoder --------------------------------------------------------------
def _dryrun_pcm(S, n, ch=2):
    """The reference dry run's encoder signal: two tones a stream and
    noise (which keeps the rate-choice estimates off exact ties)."""
    t = np.arange(n) / 44100.0
    rng = np.random.default_rng(7)
    pcm = np.zeros((S, n, ch))
    for s in range(S):
        pcm[s, :, 0] = 7000 * np.sin(2 * np.pi * 300.0 * (s + 1) * t)
        pcm[s, :, 1] = 7000 * np.sin(2 * np.pi * 450.0 * (s + 1) * t)
    return pcm + 300 * rng.standard_normal(pcm.shape)


def _snr_db(ref, got):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((got - ref) ** 2),
                                                1e-9))


def _hold_to_aacjax(outs_t, outs_j, pcm, config):
    """The port's sharded streams decoded by the port within 0.5 dB SNR of
    aacjax's single-device streams decoded by aacjax (the bar of
    tests/test_torch_encode_batch.py); the share of byte-identical frames is
    printed."""
    import aacjax_torch
    same = total = 0
    for s in range(pcm.shape[0]):
        pt = [p for o in outs_t for p in o[s]]
        pj = [p for o in outs_j for p in o[s]]
        same += sum(a == b for a, b in zip(pt, pj))
        total += len(pj)
        got, _ = aacjax_torch.decode_adts(
            b"".join(enc.adts_frame(p, config) for p in pt), device="cpu")
        want, _ = aacjax.decode_adts(
            b"".join(enc.adts_frame(p, config) for p in pj))
        end = min(len(got), len(want)) - 2048
        ref = pcm[s, 1024:end]
        d = abs(_snr_db(ref, got[2048:1024 + end] * 32768)
                - _snr_db(ref, want[2048:1024 + end] * 32768))
        assert d <= 0.5, (s, d)
    print(f"{same} of {total} frames byte-identical to aacjax's")


def test_sharded_encoder_matches_single_device():
    """encode_chunk on an 8x1 mesh (one channel row a shard), two chunks
    with a transient across the boundary: byte-identical to the unsharded
    port, held to aacjax's single-device encoder; uneven rows raise."""
    from aacjax.encode_batch import BatchEncoder as JaxEncoder
    from aacjax_torch.encode_batch import BatchEncoder
    S, ch, n = 4, 2, 1024 * 4
    pcm = _dryrun_pcm(S, 2 * n)
    pcm[1, n + 900: n + 1100] += 15000            # straddles chunk 2's frames

    def run(make, **kw):
        e = make(44100, ch, 96_000, n_streams=S, **kw)
        return [e.encode_chunk(pcm[:, :n]), e.encode_chunk(pcm[:, n:])], e

    want, _ = run(BatchEncoder, device="cpu")
    got, e = run(BatchEncoder, device="cpu", mesh=mesh(8, 1))
    assert got == want
    jax_want, _ = run(JaxEncoder)
    _hold_to_aacjax(got, jax_want, pcm, e.config)
    with pytest.raises(ValueError, match="do not split"):
        BatchEncoder(44100, 1, 96_000, n_streams=3, device="cpu",
                     mesh=mesh(8, 1))


def test_sharded_encode_pipelined_matches_single_device():
    """encode_pipelined on a 4x1 mesh: byte-identical to sequential
    unsharded encode_chunk, and held to aacjax's."""
    from aacjax.encode_batch import BatchEncoder as JaxEncoder
    from aacjax_torch.encode_batch import BatchEncoder
    S, ch, n = 4, 2, 1024 * 3
    pcm = _dryrun_pcm(S, 3 * n)
    pcm[2, n + 500: n + 600] += 15000
    chunks = [pcm[:, k * n:(k + 1) * n] for k in range(3)]
    seq = BatchEncoder(44100, ch, 96_000, n_streams=S, device="cpu")
    want = [seq.encode_chunk(c) for c in chunks]
    pipe = BatchEncoder(44100, ch, 96_000, n_streams=S, device="cpu",
                        mesh=mesh(4, 1))
    got = list(pipe.encode_pipelined(iter(chunks)))
    assert got == want
    jenc = JaxEncoder(44100, ch, 96_000, n_streams=S)
    _hold_to_aacjax(got, [jenc.encode_chunk(c) for c in chunks], pcm,
                    pipe.config)


# -- the mesh itself ----------------------------------------------------------
def test_make_mesh_refuses_more_shards_than_devices():
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        meshlib.make_mesh(3, 3, devices=[CPU] * 8)
    m = mesh(2, 4)
    assert m.shape == {"stream": 2, "frame": 4}
    assert m.row_devices == (CPU, CPU) and m.device_set == (CPU,)
    assert m == mesh(2, 4) and hash(m) == hash(mesh(2, 4))
    if not torch.cuda.is_available():
        # no silent fallback onto the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.make_mesh(2)


@needs_native
def test_uneven_splits_raise():
    """Whole streams must split evenly over the stream shards and the chunk's
    frames over the frame shards; the encoder's rows likewise."""
    configs, chunks = make_lc_payload_chunks(n_streams=3, chunk_frames=4,
                                             n_chunks=1, seed=1)
    dec = BatchDecoder(configs, chunk_frames=4, device="cpu")
    with pytest.raises(ValueError, match="3 streams do not split over 2"):
        list(dec.decode_pipelined(iter(chunks), mesh=mesh(2, 1)))
    with pytest.raises(ValueError, match="4 frames a chunk do not split "
                       "over 3"):
        dec.step_he_raw(chunks[0], mesh=mesh(1, 3))
    with pytest.raises(ValueError, match="6 channel rows"):
        meshlib._row_sharding(mesh(4, 1), 6)
    assert meshlib.split_streams([2, 1, 2, 3], 2) == ((0, 3), (3, 8))
    lay = meshlib.Layout(((0, 4),), ((0, 2), (2, 4)), halo=3)
    assert (lay.lead(0), lay.lead(1)) == (0, 0)


def test_row_blocks_round_trip():
    """scatter / gather / blocks: rows land in their blocks, a block on the
    whole's device is a view, and a reset through blocks() zeroes exactly
    the rows asked for."""
    x = torch.arange(24.0).reshape(8, 3)
    rb = meshlib.scatter(x, ((0, 3), (3, 8)), (CPU, CPU))
    assert rb.parts[1].data_ptr() == x[3:].data_ptr()
    assert torch.equal(meshlib.gather(rb, CPU), x)
    for part, a, b in meshlib.blocks(rb, 2, 5):
        part[a:b] = -1
    assert (meshlib.gather(rb, CPU)[2:5] == -1).all()
    assert torch.equal(meshlib.row_of(rb, 6), x[6])
    assert meshlib.scatter(rb, rb.bounds, rb.devices) is rb


def test_device_caches_key_indexed_devices(monkeypatch):
    """A bare "cuda" keys the constant caches as the current device's index,
    so a change of the current device takes other tables."""
    current = {"i": 0}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["i"])
    assert _build.indexed(torch.device("cuda")) == torch.device("cuda", 0)
    assert _build.indexed("cuda:2") == torch.device("cuda", 2)
    assert _build.indexed("cpu") == CPU
    calls = []

    @_build.per_device
    def table(device, n):
        calls.append((device, n))
        return object()

    a = table(torch.device("cuda"), 3)
    assert table(torch.device("cuda", 0), 3) is a
    current["i"] = 1
    b = table(torch.device("cuda"), 3)
    assert b is not a and table(torch.device("cuda", 1), 3) is b
    assert calls == [(torch.device("cuda", 0), 3),
                     (torch.device("cuda", 1), 3)]
    assert P.consts(CPU) is P.consts(torch.device("cpu"))
