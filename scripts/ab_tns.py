#!/usr/bin/env python3
"""Time the TNS route of one tree of the port on one CUDA GPU.

    python3 scripts/ab_tns.py --tree DIR

DIR holds the `aacjax_torch` under test (this repository's root, or an
archive of another commit).  The inputs and the timing helpers always come
from the repository this script lies in, so that two trees are read on the
same data: `scripts/ab_tns.sh PARENT_TREE` runs parent, change, change,
parent in one call.  Printed, one line each, tagged with the tree:

  - the TNS wrapper at 256, 4096 and 16384 rows of whole-spectrum
    order-2/12/20 filters in both directions (`random_tns_chunk`): ms per
    call (CUDA events, median of 20 runs of 10 back-to-back calls) and the
    TNS kernels' device time per call (torch.profiler);
  - the TNS route at 16384 rows of the serving mix (`serving_tns_chunk`),
    from compact int16 spectra and the parser's packed planes to filtered
    f32 spectra: `tns.tns_packed` where the tree has it, else
    decompress_i16 + the plane copies of unpack_spec_batch + `tns.tns`;
  - the stages of one LC-512-tns chunk (512 streams of
    `tns_serving_corpus`, 16 frames, f32 PCM), medians of 5.

Each TNS line carries sum|out|, which two trees that compute the same
function print alike.
"""
from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    CS = load("ab_chip_smoke", REPO / "chip_smoke.py")
    gen = load("ab_inputs", REPO / "aacjax_torch" / "testing" / "__init__.py")
    import aacjax_torch
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import tns
    if pathlib.Path(aacjax_torch.__file__).resolve().parents[1] != tree:
        sys.exit(f"aacjax_torch was not imported from {tree}")
    dev = torch.device("cuda")
    tag = f"[{tree.name or tree}]"

    def on_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def report(name, fn):
        out = fn()
        torch.cuda.synchronize()
        ms = CS.time_ms(torch, fn, reps=CS.REPS)
        dms = CS.device_ms(torch, fn, "tns_")
        print(f"{tag} tns {name}: {ms:.4f} ms per call, TNS kernels "
              f"{CS.fmt(dms)} on the device; sum|out| "
              f"{float(out.double().abs().sum())!r}", flush=True)

    for C, T in ((4, 64), (256, 16), (1024, 16)):
        args = on_dev(gen.random_tns_chunk(5 + C, C, T))
        report(f"B={C * T} orders 2/12/20", lambda: tns.tns(*args))

    q, sc, lpc, rng = on_dev(gen.serving_tns_chunk(7, 1024, CS.CHUNK))
    if hasattr(tns, "tns_packed"):
        def route():
            return tns.tns_packed(q, sc, lpc, rng)
    else:
        def route():
            return tns.tns(
                P.decompress_i16(q, sc), lpc[:, :, 0].contiguous(),
                rng[:, :, 0, :, 0].contiguous(),
                rng[:, :, 0, :, 1].contiguous(), lpc[:, :, 1].contiguous(),
                rng[:, :, 1, :, 0].contiguous(),
                rng[:, :, 1, :, 1].contiguous())
    report("B=16384 serving mix, compact i16 + packed planes -> f32", route)

    config, streams = gen.tns_serving_corpus()
    corpus = [gen.adts_payloads(d) for d in streams]
    per_stream = [corpus[i % len(corpus)] for i in range(CS.N_STREAMS)]
    chunks = [[p[k * CS.CHUNK:(k + 1) * CS.CHUNK] for p in per_stream]
              for k in range(2)]
    dec = aacjax_torch.BatchDecoder([config] * CS.N_STREAMS,
                                    chunk_frames=CS.CHUNK)
    dec.step_raw(chunks[0], out_int16=False)                # warm-up chunk
    torch.cuda.synchronize()
    before = tns.launches
    parse_s, h2d_s, comp_s, d2h_s = CS.stage_split(torch, dec, chunks[1],
                                                   False)
    print(f"{tag} LC-512-tns per-chunk stages: parse {parse_s:.4f} s, h2d "
          f"{h2d_s:.4f} s, compute {comp_s:.6f} s, d2h {d2h_s:.4f} s "
          f"(TNS launches {tns.launches - before} in 5 chunks)", flush=True)


if __name__ == "__main__":
    main()
