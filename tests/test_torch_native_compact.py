"""The block-scaled int16 spectra written inside the port's native parse
threads (`parse_batch_spec(want_i16=True)`, aacjax_torch/native) against
the separate pass they replace, as the JAX package's unchanged library
(native/libaacparse.so) runs it: its `aacparse_batch_spec`, then its
scalar `aacjax_spec_to_i16` over the whole buffer, and against a float32
NumPy model of the arithmetic; bit for bit, on the frozen benchmark corpus
and on the parse's edge cases; which chunks of
`BatchDecoder._parse_native` take which path; and the two libraries'
versions."""
import ctypes
import json
import pathlib
import shutil

import numpy as np
import pytest

import aacjax_torch
from aacjax.host import native as jax_native
from aacjax_torch import testing as TI
from aacjax_torch.host import native
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.runtime.stats import Trace
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import random_cpe_spec
from aacjax_torch.testing.streams import make_lc_payload_chunks

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "portbench" / "corpus"


class _Route:
    """One stream set parsed chunk after chunk into one SpecBatchArrays
    (rows a chunk leaves unwritten keep the previous chunk's spectra, as
    in a decoder's parse buffer), fused in the port's library or by the
    JAX package's parse and separate pass."""

    def __init__(self, configs, T, fused):
        self.configs, self.fused = configs, fused
        slots = [c.channels for c in configs]
        self.base = np.cumsum([0] + slots[:-1]).astype(np.int32)
        self.n_slots = np.array(slots, np.int32)
        self.out = native.SpecBatchArrays(sum(slots), T,
                                          configs[0].frame_length)
        self.prev = np.zeros(sum(slots), np.int32)
        self.tables = native.stream_tables(configs)

    def parse(self, chunk):
        cfgs = self.configs
        args = (chunk, np.array([c.sample_index for c in cfgs], np.int32),
                np.array([c.chan_config for c in cfgs], np.int32),
                self.base, self.n_slots, self.prev, self.out)
        if self.fused:
            status, _, _ = native.parse_batch_spec(
                *args, tables_pack=self.tables, want_i16=True)
        else:
            status, _, _ = jax_native.parse_batch_spec(
                *args, tables_pack=self.tables)
            jax_native.compact_spec(self.out)
        return status


def _assert_same(a: native.SpecBatchArrays, b: native.SpecBatchArrays):
    """a fused, b by the separate pass; a's int16 also the model's."""
    np.testing.assert_array_equal(a.meta, b.meta)
    np.testing.assert_array_equal(a.spec, b.spec)
    present = a.meta[:, :, 5] != 0
    # the rows the device reads, then the whole buffer (every slot is a
    # stream's)
    assert np.array_equal(a.spec_i16[present], b.spec_i16[present])
    assert np.array_equal(a.spec_scale[present].view(np.uint32),
                          b.spec_scale[present].view(np.uint32))
    assert np.array_equal(a.spec_i16, b.spec_i16)
    assert np.array_equal(a.spec_scale.view(np.uint32),
                          b.spec_scale.view(np.uint32))
    q, scale = _model_i16(a.spec.reshape(-1, a.F))
    assert np.array_equal(a.spec_i16.reshape(-1, a.F), q)
    assert np.array_equal(a.spec_scale.reshape(q.shape[0], -1)
                          .view(np.uint32), scale.view(np.uint32))


def _compare(configs, chunks, T):
    """Both routes over the chunks; returns each chunk's statuses and the
    present rows' short-window count."""
    fused, sep = _Route(configs, T, True), _Route(configs, T, False)
    statuses, n_short = [], 0
    for chunk in chunks:
        s1 = fused.parse(chunk)
        s2 = sep.parse(chunk)
        np.testing.assert_array_equal(s1, s2)
        _assert_same(fused.out, sep.out)
        statuses.append(s1.copy())
        n_short += int((fused.out.meta[:, :, 4] != 0).sum())
    return statuses, n_short


def _random_lc(F: int, n: int, seed: int) -> list[bytes]:
    """AAC-LC stereo frames of random legal CPEs at frame length F: every
    window sequence, TNS, PNS, intensity, M/S."""
    cfg = parse_asc(make_asc(2, 4, 2, frame_length=F))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, cfg, common=True), cfg)
        out.append(enc.end_frame(w))
    return out


@pytest.fixture(scope="module")
def corpus_streams():
    """The LC configuration's streams (the four-card configuration's
    corpus shares their files and adds its own beside them)."""
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "aac-lc-256k-stereo-44k.json").read_text())
    paths = [REPO / f["file"] for f in cfg["corpus"]["files"]]
    assert len(paths) == 16 and all(p.parent == CORPUS for p in paths)
    return [TI.adts_payloads(p.read_bytes()) for p in paths]


@pytest.mark.parametrize("threads", [None, "1", "4"])
def test_corpus_chunks_bit_identical(corpus_streams, threads, monkeypatch):
    """The frozen lc256k corpus, 16 streams at staggered starts, chunk
    after chunk of 16 frames, the last chunk short (stale rows past the
    frames), under the parse's own thread count and 1 and 4 threads."""
    if threads is None:
        monkeypatch.delenv("AACJAX_PARSE_THREADS", raising=False)
    else:
        monkeypatch.setenv("AACJAX_PARSE_THREADS", threads)
    T = 16
    cfg = parse_asc(make_asc(2, 4, 2))
    chunks = []
    for k in range(6):
        chunk = []
        for i, frames in enumerate(corpus_streams):
            lo = 37 * i + T * k
            chunk.append(frames[lo:lo + (T if k < 5 else 5 + i % 7)])
        chunks.append(chunk)
    statuses, n_short = _compare([cfg] * 16, chunks, T)
    assert all((s == 0).all() for s in statuses)
    assert n_short > 0


@pytest.mark.parametrize("threads", ["1", "4"])
def test_edge_cases_bit_identical(threads, monkeypatch):
    """Short windows, a corrupt frame concealed mid-stream, a stream with
    no payloads, a stream stopped at ERR_FALLBACK (a coupling channel with
    no slot), and chunks of different lengths in one buffer."""
    monkeypatch.setenv("AACJAX_PARSE_THREADS", threads)
    T = 8
    cfg = TI.lc_stereo_config()
    rand = [_random_lc(1024, 2 * T, seed) for seed in range(4)]
    corrupt = list(rand[1][:T])
    corrupt[3] = corrupt[3][:6]
    cce = TI.cce_stereo_payloads(T, seed=5, point=2)
    _, lc = make_lc_payload_chunks(n_streams=2, chunk_frames=T, n_chunks=2)
    chunks = [
        [rand[0][:T], corrupt, None, cce, lc[0][0], rand[2][:T]],
        [rand[0][T:T + 3], rand[1][T:], rand[3][:T], None, lc[1][1],
         rand[2][T:T + 1]],
    ]
    statuses, n_short = _compare([cfg] * 6, chunks, T)
    first = statuses[0]
    assert first[0] == 0 and first[2] == 0 and first[4] == 0
    assert first[1] not in (0, native.ERR_FALLBACK, native.ERR_DELEGATE)
    assert first[3] == native.ERR_FALLBACK
    assert n_short > 0


@pytest.mark.parametrize("profile,F", [(2, 960), (17, 960), (23, 480)])
def test_frame_lengths_bit_identical(profile, F, monkeypatch):
    """960 (60 blocks a row, short windows of 120 on the LC route) and 480
    (30 blocks a row, AAC-LD)."""
    monkeypatch.setenv("AACJAX_PARSE_THREADS", "2")
    T = 6
    if profile == 2:
        cfg = parse_asc(make_asc(2, 4, 2, frame_length=F))
        streams = [_random_lc(F, 2 * T, seed) for seed in range(3)]
    else:
        cfg = TI.er_config(profile, F, 2)
        streams = [TI.er_payloads(cfg, 2 * T, seed) for seed in range(3)]
    assert cfg.frame_length == F
    chunks = [[s[:T] for s in streams], [s[T:T + 2 + i]
                                         for i, s in enumerate(streams)]]
    statuses, _ = _compare([cfg] * 3, chunks, T)
    assert all((s == 0).all() for s in statuses)


def _separate_pass(monkeypatch):
    """Route the decoder's parse through the separate pass of the JAX
    package's library: its parse, then its compact_spec over the whole
    buffer."""
    def separate(*args, want_i16=False, **kw):
        got = jax_native.parse_batch_spec(*args, **kw)
        if want_i16:
            jax_native.compact_spec(args[6])
        return got
    monkeypatch.setattr(native, "parse_batch_spec", separate)


def test_decode_pipelined_pcm_as_separate_pass(monkeypatch):
    """decode_pipelined(out_int16=True, compact=True) on the CPU gives the
    int16 PCM of the separate pass, chunk for chunk."""
    configs, chunks = make_lc_payload_chunks(n_streams=3, chunk_frames=8,
                                             n_chunks=3, seed=7)

    def run():
        dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
        return [np.array(p) for p in dec.decode_pipelined(
            iter(chunks), out_int16=True, compact=True)]
    fused = run()
    _separate_pass(monkeypatch)
    sep = run()
    assert len(fused) == len(sep) == 3
    for a, b in zip(fused, sep):
        assert a.dtype == np.int16
        np.testing.assert_array_equal(a, b)


def _compact_counters(trace: Trace) -> dict:
    return {k: n for k, n in trace.counters.items()
            if k[0].startswith("compact_")}


def test_lc_chunk_counts_fused():
    """An LC chunk: `compact_fused` 1 and no `parse.compact` span."""
    configs, chunks = make_lc_payload_chunks(n_streams=2, chunk_frames=4)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    dec.trace = Trace()
    batch = dec._parse_native(chunks[0], compact=True, chunk_id=0)
    assert batch["_spec_i16"]
    assert _compact_counters(dec.trace) == {("compact_fused", 0): 1}
    assert "parse.compact" not in {s.name for s in dec.trace.spans}


def _drc_stream_payloads():
    cfg = TI.lc_stereo_config()
    t = np.arange(1024 * 6)[:, None] / 44100.0
    x = np.repeat(6000 * np.sin(2 * np.pi * 500 * t)
                  + 3000 * np.sin(2 * np.pi * 9000 * t), 2, axis=1)
    drc = enc.drc_payload([-18.0, 4.0], band_tops=[128, 1024],
                          excluded=[False, True])
    payloads = enc.encode_pcm_frames(x, cfg, target_sf=110,
                                     fil_payloads=[drc])
    return cfg, payloads[:6]


def test_drc_chunk_counts_separate(monkeypatch):
    """A chunk whose DRC gains fold into the f32 spectra after the parse
    converts them in a pass of its own (`compact_separate`, a
    `parse.compact` span), and its int16 spectra are the separate pass's;
    the fold moved them off what the parse threads wrote."""
    cfg, payloads = _drc_stream_payloads()

    def parse(trace):
        dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=6,
                                        drc_scale=0.5, device="cpu")
        dec.trace = trace
        batch = dec._parse_native([payloads], compact=True, chunk_id=0)
        return (np.array(batch["spec_i16"]), np.array(batch["spec_scale"]),
                dec)
    got_q, got_s, dec = parse(Trace())
    assert (dec._last_status == 0).all()
    assert _compact_counters(dec.trace) == {("compact_separate", 0): 1}
    assert "parse.compact" in {s.name for s in dec.trace.spans}
    with monkeypatch.context() as m:
        _separate_pass(m)
        want_q, want_s, _ = parse(None)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s.view(np.uint32),
                                  want_s.view(np.uint32))
    # the parse threads' own int16 (before the fold) differ from these
    fused = native.SpecBatchArrays(dec.C, dec.T, dec.F)
    native.parse_batch_spec(
        [payloads], dec._sample_indices, dec._chan_configs, dec._base_slots,
        dec._n_slots, np.zeros(dec.C, np.int32), fused,
        tables_pack=dec._tables_pack, want_i16=True)
    assert not np.array_equal(fused.spec_i16, want_q)


def test_main_profile_and_he_core_count_neither(monkeypatch):
    """A Main-profile batch ships f32 spectra and the HE core parse asks
    for q/sf: neither compacts, so neither counts."""
    cfg = TI.main_config()
    dec = aacjax_torch.BatchDecoder([cfg], chunk_frames=4, device="cpu")
    dec.trace = Trace()
    calls = []
    parse = native.parse_batch_spec

    def spy(*args, **kw):
        calls.append(kw.get("want_i16"))
        return parse(*args, **kw)
    monkeypatch.setattr(native, "parse_batch_spec", spy)
    batch = dec._parse_native([TI.main_stereo_payloads(4, seed=2)],
                              compact=True, chunk_id=0)
    assert not batch["_spec_i16"]
    assert not _compact_counters(dec.trace)
    config, streams = TI.he_serving_corpus(2, 0.5, 4)
    he = aacjax_torch.BatchDecoder([config] * 2, chunk_frames=4,
                                   device="cpu")
    he.trace = Trace()
    chunks = [[s[k * 4:(k + 1) * 4] for s in streams] for k in range(2)]
    assert len(list(he.decode_he_pipelined(iter(chunks)))) == 2
    assert not any(k[0].startswith("compact_") for k in he.trace.counters)
    assert "parse.compact" not in {s.name for s in he.trace.spans}
    assert calls and not any(calls)


def _model_i16(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The compaction's arithmetic in float32 NumPy: per 16 bins m = the
    largest |x| (NaN left out), scale m / 32767, x * (32767 / m) clamped
    to +-32767 and rounded half to even; a silent block 0; NaN bins 0."""
    R, F = x.shape
    b = x.reshape(R, F // 16, 16)
    a = np.abs(b)
    m = np.where(np.isnan(a), np.float32(0), a).max(-1)
    scale = m / np.float32(32767)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(m == 0, np.float32(0), np.float32(32767) / m)
        v = np.clip(b * inv[..., None], np.float32(-32767),
                    np.float32(32767))
    q = np.rint(v)
    q = np.where(np.isnan(q), 0, q).astype(np.int16)
    return q.reshape(R, F), scale.astype(np.float32)


def _edge_rows(F: int) -> np.ndarray:
    """Rows of ties, silent blocks, huge and tiny values, inf and NaN."""
    rng = np.random.default_rng(F)
    R = 64
    x = (rng.standard_normal((R, F))
         * 10.0 ** rng.uniform(-6, 8, (R, 1))).astype(np.float32)
    x[1] = np.round(x[1] * 2) / 2              # halves: ties at 32767 / m
    x[2, :F // 2] = 0                          # silent blocks
    x[3, 5], x[4, 17], x[5, 33] = np.nan, np.inf, -np.inf
    x[6, 40:56] = 0
    x[6, 44] = np.nan                          # silent but for a NaN
    x[7, :16] = [-0.0] * 16
    x[8, 3], x[8, 4] = 3e38, -1e-38
    return x


def _to_i16(lib, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    R, F = x.shape
    q = np.zeros((R, F), np.int16)
    s = np.zeros((R, F // 16), np.float32)
    lib.aacjax_spec_to_i16(x.ctypes.data_as(ctypes.c_void_p), R, F,
                           q.ctypes.data_as(ctypes.c_void_p),
                           s.ctypes.data_as(ctypes.c_void_p))
    return q, s


@pytest.mark.parametrize("F", [1024, 960, 512, 480])
def test_libraries_versions_and_separate_pass(F):
    """The JAX package's library still loads at version 9 and the port's
    reads 11; the port's aacjax_spec_to_i16 (the DRC chunks' pass) gives
    the JAX library's scalar results and the model's on edge rows; the
    port's fused parse gives the JAX library's spectra and int16."""
    lib, jlib = native._load(), jax_native._load()
    assert jlib is not None and jlib.aacparse_version() == 9
    assert lib.aacparse_version() == native._ABI_VERSION == 11
    x = _edge_rows(F)
    q, s = _to_i16(lib, x)
    j_q, j_s = _to_i16(jlib, x)
    want_q, want_s = _model_i16(x)
    np.testing.assert_array_equal(q, j_q)
    np.testing.assert_array_equal(s.view(np.uint32), j_s.view(np.uint32))
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(s.view(np.uint32), want_s.view(np.uint32))

    cfg = (parse_asc(make_asc(2, 4, 2, frame_length=F)) if F >= 960
           else TI.er_config(23, F, 2))
    payloads = (_random_lc(F, 6, seed=F) if F >= 960
                else TI.er_payloads(cfg, 6, seed=F))
    args = ([payloads], np.array([cfg.sample_index], np.int32),
            np.array([cfg.chan_config], np.int32), np.array([0], np.int32),
            np.array([2], np.int32))
    j_out = jax_native.SpecBatchArrays(2, 6, F)
    j_status, _, _ = jax_native.parse_batch_spec(
        *args, np.zeros(2, np.int32), j_out,
        tables_pack=jax_native.stream_tables([cfg]))
    j_q, j_s = jax_native.compact_spec(j_out)
    out = native.SpecBatchArrays(2, 6, F)
    status, _, _ = native.parse_batch_spec(
        *args, np.zeros(2, np.int32), out,
        tables_pack=native.stream_tables([cfg]), want_i16=True)
    np.testing.assert_array_equal(status, j_status)
    np.testing.assert_array_equal(out.spec, j_out.spec)
    np.testing.assert_array_equal(out.meta, j_out.meta)
    np.testing.assert_array_equal(out.spec_i16, j_q)
    np.testing.assert_array_equal(out.spec_scale.view(np.uint32),
                                  j_s.view(np.uint32))


def test_binding_refuses_other_abi(monkeypatch, tmp_path):
    """A library of another ABI version, such as the JAX package's copy
    (9, whose parse takes no int16 outputs and no counts), is not
    loaded."""
    stale = tmp_path / "libaacparse.so"
    shutil.copyfile(jax_native._LIB_PATH, stale)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", stale)
    assert native._load() is None
    assert not native.available()
