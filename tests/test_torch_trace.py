"""The port's own measurements on the CPU (aacjax_torch/runtime/stats.py):
the spans and counters a `Trace` records at the serving layers'
boundaries, with tracing off and on; the chunk ids of the two pipelined
entries and of direct calls; the SBR loop's counters against a counting
dict in the cache's place; the workers' thread labels; and
`DecodeStats.realtime_x` against the wall clock."""
import threading
import time

import numpy as np
import pytest

import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.host import adts, native
from aacjax_torch.host import sbr as S
from aacjax_torch.host.asc import parse_asc
from aacjax_torch.runtime.stats import Trace
from aacjax_torch.testing.streams import make_lc_payload_chunks

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")

T_LC, T_HE = 8, 4
PARSE_PARTS = ("parse.wait_h2d", "parse.native")
HE_PARTS = ("he.begin", "parse", "he.sbr", "he.stage")


def _lc(n_chunks=3):
    configs, chunks = make_lc_payload_chunks(n_streams=4, chunk_frames=T_LC,
                                             n_chunks=n_chunks)
    return aacjax_torch.BatchDecoder(configs, chunk_frames=T_LC,
                                     device="cpu"), chunks


@pytest.fixture(scope="module")
def he_corpus():
    """Two HE-AAC v1 streams of 5 chunks, one SBR extension a frame."""
    return TI.he_serving_corpus(2, 1.0, T_HE)


def _he(corpus, n_streams=3):
    """Stream i is corpus stream i mod 2: with three, the third repeats
    the first frame for frame."""
    config, streams = corpus
    per = [streams[i % len(streams)] for i in range(n_streams)]
    chunks = [[p[k * T_HE:(k + 1) * T_HE] for p in per]
              for k in range(len(per[0]) // T_HE)]
    return aacjax_torch.BatchDecoder([config] * n_streams, chunk_frames=T_HE,
                                     device="cpu"), chunks


def _serve(dec, chunks, route):
    fn = dec.decode_pipelined if route == "lc" else dec.decode_he_pipelined
    return [np.array(p) for p in fn(iter(chunks))]


def _by_chunk(trace, name):
    out = {}
    for s in trace.spans:
        if s.name == name:
            assert s.chunk not in out, (name, s.chunk)
            out[s.chunk] = s
    return out


def _ns(span):
    return span.t1_ns - span.t0_ns


def _inside(child, parent):
    assert child.parent is parent, (child.name, parent.name)
    assert parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


class _CountingCache(dict):
    def __init__(self):
        super().__init__()
        self.lookups = self.hits = self.misses = self.inserts = 0

    def get(self, key, default=None):
        found = super().get(key, default)
        self.lookups += 1
        self.hits += found is not None
        self.misses += found is None
        return found

    def __setitem__(self, key, value):
        self.inserts += 1
        super().__setitem__(key, value)


@pytest.mark.parametrize("route", ["lc", "he"])
def test_tracing_off_records_nothing(route, he_corpus, monkeypatch):
    """With `trace` None no site reaches a recorder, and the PCM is bit
    for bit the traced run's."""
    dec, chunks = _lc() if route == "lc" else _he(he_corpus)
    traced = Trace()
    dec.trace = traced
    want = _serve(dec, chunks, route)
    assert traced.spans and (route == "lc" or traced.counters)

    def refuse(*args, **kw):
        raise AssertionError("recorded with tracing off")
    for name in ("open", "close", "count"):
        monkeypatch.setattr(Trace, name, refuse)
    dec, chunks = _lc() if route == "lc" else _he(he_corpus)
    assert dec.trace is None
    got = _serve(dec, chunks, route)
    assert len(got) == len(want) == len(chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_lc_pipelined_spans_per_chunk():
    """Each chunk of decode_pipelined has one span of each kind under its
    id, the parse's parts inside the parse; the parse threads wrote the
    compact spectra (`compact_fused`), so no chunk has a `parse.compact`
    pass; every chunk's bands were decoded straight into the f32 rows,
    every gain from the table."""
    dec, chunks = _lc()
    dec.trace = Trace()
    _serve(dec, chunks, "lc")
    ids = set(range(len(chunks)))
    spans = {n: _by_chunk(dec.trace, n) for n in (
        "parse", *PARSE_PARTS, "upload_dispatch", "download", "wait.upload",
        "wait.download")}
    for name, per in spans.items():
        assert set(per) == ids, name
    for k in ids:
        parse = spans["parse"][k]
        assert parse.parent is None
        for part in PARSE_PARTS:
            _inside(spans[part][k], parse)
        # the worker's span holds the main thread's wait on it
        assert spans["upload_dispatch"][k].t1_ns >= \
            spans["wait.upload"][k].t0_ns
    assert all(s.t1_ns >= s.t0_ns > 0 for s in dec.trace.spans)
    assert not dec._pending_steps
    assert not _by_chunk(dec.trace, "parse.compact")
    counters = dec.trace.counters
    assert {key: n for key, n in counters.items()
            if key[0].startswith("compact_")} == {
                ("compact_fused", k): 1 for k in ids}
    for k in ids:
        assert counters[("parse_fused_bands", k)] > 0
        assert counters[("parse_gain_table_misses", k)] == 0


def test_he_pipelined_spans_and_counters(he_corpus):
    """decode_he_pipelined: every SBR extension counted once, the cache's
    lookups, hits and inserts as a counting dict in its place sees them,
    the loop's parse and pack inside `he.sbr` and the host phase's parts
    inside `he_host`."""
    dec, chunks = _he(he_corpus)
    dec.trace = Trace()
    dec._sbr_init()
    cache = dec._sbr_parse_cache = _CountingCache()
    _serve(dec, chunks, "he")
    tr = dec.trace
    ids = range(len(chunks))

    def counted(name):
        per = {k: tr.counters[(name, k)] for k in ids}
        assert len(per) == sum(n == name for n, _ in tr.counters)
        return per
    payloads = counted("sbr_payloads")
    assert payloads == {k: len(chunks[k]) * T_HE for k in ids}
    assert counted("sbr_cache_lookups") == payloads
    lookups = sum(payloads.values())
    hits = sum(counted("sbr_cache_hits").values())
    assert (lookups, hits, sum(counted("sbr_cache_inserts").values())) == (
        cache.lookups, cache.hits, cache.inserts)
    assert lookups == cache.hits + cache.misses
    host = _by_chunk(tr, "he_host")
    parts = {n: _by_chunk(tr, n) for n in HE_PARTS}
    native_ = _by_chunk(tr, "parse.native")
    parse_ns, pack_ns = counted("sbr_parse_ns"), counted("sbr_pack_ns")
    for k in ids:
        for n in HE_PARTS:
            _inside(parts[n][k], host[k])
        _inside(native_[k], parts["parse"][k])
        assert 0 < parse_ns[k] + pack_ns[k] <= _ns(parts["he.sbr"][k])
        assert sum(_ns(parts[n][k]) for n in HE_PARTS) <= _ns(host[k])


@pytest.mark.parametrize("n_streams,hits_per_chunk", [(2, 0), (3, T_HE)])
def test_repeated_payloads_hit_the_sbr_cache(he_corpus, n_streams,
                                             hits_per_chunk):
    """Distinct streams repeat no payload; a third stream that repeats the
    first finds each of its payloads in the cache."""
    dec, chunks = _he(he_corpus, n_streams)
    dec.trace = Trace()
    _serve(dec, chunks, "he")
    assert [dec.trace.counters[("sbr_cache_hits", k)]
            for k in range(len(chunks))] == [hits_per_chunk] * len(chunks)


@pytest.mark.parametrize("call", ["pipelined", "step_raw"])
def test_realtime_x_is_audio_over_wall(call):
    """realtime_x is the audio decoded over the wall seconds the calls
    took: a pipelined call from its first hand-over to its last yield,
    a direct call from its parse to its PCM."""
    dec, chunks = _lc(n_chunks=6)
    t0 = time.perf_counter()
    if call == "pipelined":
        for _ in dec.decode_pipelined(iter(chunks)):
            t1 = time.perf_counter()
        wall = t1 - t0
    else:
        wall = 0.0
        for chunk in chunks:
            t0 = time.perf_counter()
            dec.step_raw(chunk)
            wall += time.perf_counter() - t0
    st = dec.stats
    assert st.steps == len(chunks)
    assert st.stream_frames == len(chunks) * 4 * T_LC
    assert st.wall_seconds <= wall
    assert st.realtime_x == pytest.approx(st.audio_seconds / wall, rel=0.01)


def test_worker_spans_carry_thread_labels(he_corpus):
    """The upload and download workers' spans say so; the parse, the host
    phase and the waits are the caller's thread's."""
    want = {"upload_dispatch": "upload", "core_step": "upload",
            "sbr_upload": "upload", "sbr_dispatch": "upload",
            "download": "download"}
    for dec, chunks, route in (_lc() + ("lc",), _he(he_corpus) + ("he",)):
        dec.trace = Trace()
        _serve(dec, chunks, route)
        seen = {(s.name, s.thread) for s in dec.trace.spans}
        assert seen == {(n, want.get(n, "main"))
                        for n, _ in seen}, route
        assert {n for n, _ in seen} >= (
            {"upload_dispatch", "download"} if route == "lc" else
            {"core_step", "sbr_upload", "sbr_dispatch", "download"})


def test_sticky_replay_is_a_download_span():
    """An SBR header change mid-chunk replays that slot's chunk on the
    float64 path inside the chunk's download."""
    h1 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    h2 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0,
                     limiter_gains=1)
    stream = TI.he_stream(8, ch=1, seed=5, header=h1, header_at={4: h2})
    frames = adts.split_frames(stream)
    config = parse_asc(adts.synthesize_cookie(frames[0][0]))
    payloads = [stream[s:e] for _, s, e in frames]
    dec = aacjax_torch.BatchDecoder([config], chunk_frames=3, device="cpu")
    dec.trace = Trace()
    list(dec.decode_he_pipelined([payloads[i:i + 3]]
                                 for i in range(0, len(payloads), 3)))
    replay = [s for s in dec.trace.spans if s.name == "download.replay"]
    assert [s.chunk for s in replay] == [1]
    _inside(replay[0], _by_chunk(dec.trace, "download")[1])
    assert replay[0].thread == "download"


def test_direct_calls_record_under_no_chunk(he_corpus):
    """step_raw and step_he_raw record their spans under chunk None and
    complete their stats record."""
    dec, chunks = _lc(n_chunks=1)
    dec.trace = Trace()
    dec.step_raw(chunks[0])
    hdec, hchunks = _he(he_corpus)
    hdec.trace = Trace()
    hdec.step_he_raw(hchunks[0])
    for d, top in ((dec, "parse"), (hdec, "he_host")):
        assert {s.chunk for s in d.trace.spans} == {None}
        assert [s.name for s in d.trace.spans if s.parent is None] == [top]
        assert not d._pending_steps and d.stats.steps == 1
    assert {k for _, k in hdec.trace.counters} == {None}


def test_trace_nests_per_thread():
    """A span's parent is the innermost span open on its own thread; a
    span left open inside one that closes leaves that thread's stack."""
    tr = Trace()
    outer = tr.open("outer", 0)
    seen = {}

    def worker():
        seen["w"] = tr.open("w", 0)
        tr.close(seen["w"])
    th = threading.Thread(target=worker, name="upload_0")
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    stale = tr.open("stale", 0)
    tr.close(outer)
    after = tr.open("after", 1)
    tr.close(after)
    assert seen["w"].parent is None and seen["w"].thread == "upload"
    assert stale.parent is outer and stale.t1_ns == 0
    assert after.parent is None and outer.thread == "main"
    tr.count("n", 1)
    tr.count("n", 1, 2)
    assert tr.counters == {("n", 1): 3}
