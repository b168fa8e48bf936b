"""AAC-LC through the program's serving entry for it:
`BatchDecoder.decode_pipelined` on the native route, compact (block-scaled
int16) spectra up, int16 PCM down."""
from __future__ import annotations

from portbench.corpus import FLAG_SHORT, FLAG_TNS

CHECK = "pairs"     # the output check's sample (portbench/check.py)
SBR = False
OUT_SAMPLES = 1024
KEY_FLAGS = FLAG_TNS | FLAG_SHORT


def decoder(cell, device):
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.runtime.batch import BatchDecoder
    c = cell.config
    cfg = parse_asc(make_asc(c["profile"], c["sample_index"], c["channels"]))
    return BatchDecoder([cfg] * cell.traffic["streams"],
                        chunk_frames=cell.traffic["chunk_frames"],
                        use_native=True, device=device)


def serve(dec, chunks):
    return dec.decode_pipelined(chunks, out_int16=True, compact=True)


def instrument(dec, tracer) -> None:
    """parse: the native parse of a chunk (main thread); upload_dispatch:
    the copies up and the step's dispatch (upload worker); download: the
    copy of the PCM to the host (download worker)."""
    tracer.wrap(dec, "_parse_native", "parse")
    tracer.wrap(dec, "_device_step", "upload_dispatch")
    tracer.wrap(dec, "finalize_step", "download")
