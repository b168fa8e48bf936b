"""AAC-LC on a host of several cards through the program's serving entry
for it, `BatchDecoder.decode_pipelined` on the native route with compact
spectra up and int16 PCM down, as routes/lc.py drives it, given
`mesh=runtime.mesh.make_mesh(n_stream, n_frame)` from the configuration's
`mesh`: one decoder of every stream on the first card, each card holding
its stream shard's slots and their carried overlap; one host parse and
one upload worker fan every chunk out to the cards, one download worker
brings their PCM back.  On the CPU the mesh's shards are all the CPU.
The mesh is made once per decoder."""
from __future__ import annotations

import weakref

from portbench.routes import lc
from portbench.routes.lc import CHECK, KEY_FLAGS, OUT_SAMPLES, SBR  # noqa: F401

FANOUT = ("mesh.h2d", "mesh.dispatch")   # the program's fan-out spans

_meshes = weakref.WeakKeyDictionary()    # decoder -> the mesh it serves on


def decoder(cell, device):
    """routes/lc.py's decoder of every stream on `device`, and its mesh:
    the configuration's `mesh` over the CUDA cards, or over the CPU."""
    import torch

    from aacjax_torch.runtime.mesh import make_mesh
    dec = lc.decoder(cell, device)
    n_stream, n_frame = (cell.config["mesh"][k] for k in ("stream", "frame"))
    dev = torch.device(device)
    _meshes[dec] = make_mesh(n_stream, n_frame, devices=(
        None if dev.type == "cuda" else [dev] * (n_stream * n_frame)))
    return dec


def serve(dec, chunks):
    return dec.decode_pipelined(chunks, out_int16=True, compact=True,
                                mesh=_meshes[dec])


def _span_ns(trace, names) -> int | None:
    """The closed spans of `names` in the program's trace, their ns summed
    (None where the program records none of them)."""
    spans = [s for s in list(trace.spans) if s.name in names]
    if not spans:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans if s.t1_ns)


def _closed(trace, name: str) -> int:
    return sum(1 for s in list(trace.spans) if s.name == name and s.t1_ns)


def instrument(dec, tracer) -> None:
    """The benchmark's spans as routes/lc.py's: parse (main thread),
    upload_dispatch (upload worker), download (download worker); and the
    program's own recorder (`dec.trace`, runtime/stats.py Trace), read as
    counters when the window opens and closes: mesh.fanout_ns, the upload
    worker's mesh.h2d and mesh.dispatch spans summed; mesh.chunks_up, its
    closed upload_dispatch spans.  A program that records no mesh span
    reads None."""
    from aacjax_torch.runtime.stats import Trace
    lc.instrument(dec, tracer)
    tr = dec.trace = Trace()
    tracer.count("mesh.fanout_ns", lambda: _span_ns(tr, FANOUT))
    tracer.count("mesh.chunks_up", lambda: _closed(tr, "upload_dispatch"))
