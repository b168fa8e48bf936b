"""HE-AAC v1 through the program's serving entry for it:
`BatchDecoder.decode_he_pipelined` (native core parse, the Python SBR
parse and pack, the core step, the SBR program), int16 PCM at twice the
core's rate."""
from __future__ import annotations

from portbench.corpus import FLAG_NOT_QSF, FLAG_SHORT, FLAG_TNS

CHECK = "slots"     # the output check's sample (portbench/check.py)
SBR = True
OUT_SAMPLES = 2048
KEY_FLAGS = FLAG_TNS | FLAG_SHORT | FLAG_NOT_QSF


def decoder(cell, device):
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.runtime.batch import BatchDecoder
    c = cell.config
    cfg = parse_asc(make_asc(c["profile"], c["sample_index"], c["channels"]))
    return BatchDecoder([cfg] * cell.traffic["streams"],
                        chunk_frames=cell.traffic["chunk_frames"],
                        use_native=True, device=device)


def serve(dec, chunks):
    return dec.decode_he_pipelined(chunks, out_int16=True, compact=True)


class CountingCache(dict):
    """The SBR parse cache (`BatchDecoder._sbr_parse_cache`, keyed by a
    payload's bytes) counting its lookups, the lookups that found an entry
    and its inserts."""

    def __init__(self, *args):
        super().__init__(*args)
        self.lookups = self.hits = self.inserts = 0

    def get(self, key, default=None):
        self.lookups += 1
        found = super().get(key, default)
        self.hits += found is not None
        return found

    def __setitem__(self, key, value):
        self.inserts += 1
        super().__setitem__(key, value)


def _count_cache(dec, tracer) -> None:
    """Put a CountingCache in the place of the program's SBR parse cache,
    which `_sbr_init` makes at the first HE chunk."""
    init = dec._sbr_init
    cache = CountingCache()

    def counted_init():
        init()
        if dec._sbr_parse_cache is not cache:
            cache.update(dec._sbr_parse_cache)
            dec._sbr_parse_cache = cache
    dec._sbr_init = counted_init
    for n in ("lookups", "hits", "inserts"):
        tracer.count(f"sbr_cache_{n}", lambda n=n: getattr(cache, n))


def instrument(dec, tracer) -> None:
    """he_host: the chunk's host phase (core parse, SBR parse with its
    payload cache, pack; main thread); core_step: the core's copies up and
    its step's dispatch, and sbr_dispatch: the SBR program's dispatch
    (both on the upload worker), with sbr_device its device time on the
    compute stream; download: the PCM's copy to the host (download
    worker); the counters sbr_cache_lookups, _hits and _inserts of the SBR
    parse cache."""
    _count_cache(dec, tracer)
    tracer.wrap(dec, "_he_host_phase", "he_host")
    tracer.wrap(dec, "_sbr_dispatch", "sbr_dispatch")
    tracer.wrap_device(dec, "_sbr_dispatch", "sbr_device",
                       getattr(dec, "_compute_stream", None))
    tracer.wrap(dec, "_device_step", "core_step")
    tracer.wrap(dec, "_sbr_download", "download")
