"""The four-card AAC-LC cell's chunks (`lc256k.mesh4`: 2048 streams of the
benchmark's frozen corpus, chunks of 16 frames) through
`BatchDecoder.decode_pipelined` on `make_mesh(4, 1)` against the same
decoder without a mesh, bit for bit, untraced and traced; then the traced
mesh call's spans a chunk, the host's cores and the native parse's thread
count.  Prints one JSON line; exits 1 where a chunk differs.
Needs four CUDA cards on one host:

    python3 scripts/lc_mesh_equal.py --chunks 4
"""
import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from aacjax_torch.host.asc import make_asc, parse_asc  # noqa: E402
from aacjax_torch.kernels import _build  # noqa: E402
from aacjax_torch.runtime.batch import BatchDecoder  # noqa: E402
from aacjax_torch.runtime.mesh import make_mesh  # noqa: E402
from aacjax_torch.runtime.stats import Trace  # noqa: E402
from portbench import registry  # noqa: E402
from portbench.corpus import Feed, assign_slots, load  # noqa: E402

SPANS = ("parse", "upload_dispatch", "mesh.h2d", "mesh.dispatch", "download")
MESH = ("mesh.h2d", "mesh.dispatch")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2020)
    args = ap.parse_args()
    _build.build()
    cell = registry.cell(registry.benchmark(), "lc256k.mesh4")
    S, T = cell.traffic["streams"], cell.traffic["chunk_frames"]
    corpus = load(cell.config, registry.ROOT)
    feed = Feed(corpus, assign_slots(args.seed, [len(p) for p in
                                                 corpus.payloads], S, T), T)
    chunks = [feed.chunk(k) for k in range(args.chunks)]
    conf = parse_asc(make_asc(2, 4, 2))

    def run(mesh, trace=None):
        dec = BatchDecoder([conf] * S, chunk_frames=T, use_native=True,
                           device="cuda")
        dec.trace = trace
        kw = {} if mesh is None else {"mesh": mesh}
        t0 = time.perf_counter()
        out = [np.array(p) for p in dec.decode_pipelined(
            iter(chunks), out_int16=True, compact=True, **kw)]
        return dec, out, time.perf_counter() - t0

    _, want, t_one = run(None)
    mesh = make_mesh(4, 1)
    _, got, t_mesh = run(mesh)
    dec, traced, t_traced = run(mesh, Trace())
    tr, ks = dec.trace, range(args.chunks)
    res = {"devices": [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())],
           "cpu_count": os.cpu_count(),
           "parse_threads": min(os.cpu_count(), S // 4, 16),
           "streams": S, "chunks": args.chunks, "mesh": repr(mesh),
           "bit_equal": [bool(np.array_equal(a, b))
                         for a, b in zip(want, got)],
           "bit_equal_traced": [bool(np.array_equal(a, b))
                                for a, b in zip(want, traced)],
           "wall_s": {"one_card": t_one, "mesh": t_mesh,
                      "traced": t_traced},
           "spans_per_chunk": {n: [sum(1 for s in tr.spans if s.name == n
                                       and s.chunk == k) for k in ks]
                               for n in MESH},
           "span_ms": {n: [round(sum(s.t1_ns - s.t0_ns for s in tr.spans
                                     if s.name == n and s.chunk == k) / 1e6,
                                 3) for k in ks] for n in SPANS}}
    print(json.dumps(res), flush=True)
    return 0 if all(res["bit_equal"] + res["bit_equal_traced"]) else 1


if __name__ == "__main__":
    sys.exit(main())
