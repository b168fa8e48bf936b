"""The mesh's own spans in the port's recorder
(`aacjax_torch/runtime/stats.py` `Trace`, set as `BatchDecoder.trace`) on a
mesh of four CPU shards: `decode_pipelined` over it gives, traced or not,
the PCM of the same streams decoded without a mesh bit for bit; traced,
every chunk has one `mesh.dispatch` span inside the pipeline's
`upload_dispatch` (no `mesh.h2d`: on the CPU the shards are the host's
tensors, no copy is issued); untraced, or traced without a mesh, nothing
of the mesh is recorded.  On the card (marked `cuda`), the four-shard
decode is the whole decode's bit for bit and every shard's copies up are
a `mesh.h2d` span.

Without a mesh here means one decoder a shard's streams: on the CPU the
kernels' plain IMDCT is a dense `torch.matmul` over all the call's rows,
whose rounding depends on their count (a shard of 2 streams against 8 in
one call flips a round() in 0.07% of the int16 samples), so the sharding
is held to calls of the same shapes, and to the whole decode within the
plain route's 1 LSB (`testing.assert_pcm_close`)."""
import numpy as np
import pytest
import torch

import aacjax_torch
from aacjax_torch.host import native
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.runtime.stats import Trace
from aacjax_torch.testing import assert_pcm_close
from aacjax_torch.testing.streams import make_lc_payload_chunks

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")

T, N_STREAMS, N_CHUNKS, SHARDS = 4, 8, 3, 4
CPU = torch.device("cpu")
MESH_SPANS = ("mesh.h2d", "mesh.dispatch")


@pytest.fixture(scope="module")
def corpus():
    return make_lc_payload_chunks(n_streams=N_STREAMS, chunk_frames=T,
                                  n_chunks=N_CHUNKS, seed=20)


def _serve(corpus, devices=None, trace=None, device="cpu"):
    """decode_pipelined (int16 PCM, compact spectra) over every chunk,
    on a 4x1 mesh of `devices` (None: no mesh)."""
    configs, chunks = corpus
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=T, device=device)
    dec.trace = trace
    kw = {} if devices is None else dict(
        mesh=meshlib.make_mesh(SHARDS, 1, devices=devices))
    out = [np.array(p) for p in dec.decode_pipelined(
        iter(chunks), out_int16=True, compact=True, **kw)]
    assert len(out) == N_CHUNKS
    return dec, out


@pytest.fixture(scope="module")
def unsharded(corpus):
    """Each shard's streams decoded by a decoder of their own, no mesh,
    the PCM rows put back in order; and the whole decode."""
    configs, chunks = corpus
    per = N_STREAMS // SHARDS
    parts = [_serve((configs[i:i + per], [c[i:i + per] for c in chunks]))[1]
             for i in range(0, N_STREAMS, per)]
    return [np.concatenate(rows) for rows in zip(*parts)], _serve(corpus)[1]


@pytest.mark.parametrize("traced", [False, True])
def test_four_cpu_shards_give_the_unsharded_pcm(corpus, unsharded, traced):
    by_shard, whole = unsharded
    _, got = _serve(corpus, [CPU] * SHARDS, Trace() if traced else None)
    for k, (g, w, a) in enumerate(zip(got, by_shard, whole)):
        assert g.dtype == np.int16 and g.shape == a.shape
        np.testing.assert_array_equal(g, w, err_msg=f"chunk {k}")
        assert_pcm_close(g, a, True, f"chunk {k} against the whole decode")


def _mesh_spans(trace, name, chunk):
    """The chunk's spans `name`, each checked to lie inside the upload
    worker's `upload_dispatch` of the same chunk."""
    mine = [s for s in trace.spans if s.name == name and s.chunk == chunk]
    for s in mine:
        assert s.parent is not None and s.parent.name == "upload_dispatch"
        assert s.parent.chunk == chunk and s.thread == "upload"
        assert s.parent.t0_ns <= s.t0_ns <= s.t1_ns <= s.parent.t1_ns
    return mine


def test_every_chunk_has_its_mesh_dispatch_span(corpus):
    """One `mesh.dispatch` a chunk (every stream shard's step issued in
    it); the CPU's shards are not copied, so no `mesh.h2d`."""
    dec, _ = _serve(corpus, [CPU] * SHARDS, Trace())
    for k in range(N_CHUNKS):
        assert len(_mesh_spans(dec.trace, "mesh.dispatch", k)) == 1, k
        assert not _mesh_spans(dec.trace, "mesh.h2d", k), k


def test_a_traced_call_without_a_mesh_records_no_mesh_span(corpus):
    dec, _ = _serve(corpus, trace=Trace())
    assert any(s.name == "upload_dispatch" for s in dec.trace.spans)
    assert not [s for s in dec.trace.spans if s.name in MESH_SPANS]


def test_untraced_mesh_records_nothing(corpus, unsharded, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("recorded with tracing off")
    for name in ("open", "close", "count"):
        monkeypatch.setattr(Trace, name, refuse)
    dec, got = _serve(corpus, [CPU] * SHARDS)
    assert dec.trace is None
    for g, w in zip(got, unsharded[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_four_card_shards_give_the_whole_decode(corpus):
    """On the card(s): four shards over the CUDA devices there are (each
    a card when there are four); the PCM, traced, is the unsharded card
    decode's bit for bit (the kernels are row-local), and every chunk has
    a `mesh.h2d` span a shard and one `mesh.dispatch`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i % n) for i in range(SHARDS)]
    want = _serve(corpus, device="cuda")[1]
    dec, got = _serve(corpus, devices, Trace(), device="cuda")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k in range(N_CHUNKS):
        assert len(_mesh_spans(dec.trace, "mesh.h2d", k)) == SHARDS, k
        assert len(_mesh_spans(dec.trace, "mesh.dispatch", k)) == 1, k
