#!/usr/bin/env python3
"""The batched encoder of one tree on one CUDA GPU, for parent-against-change
comparisons.

    python3 scripts/ab_encoder.py --tree DIR

DIR holds a checkout of the repository (this one, or an archive of another
commit).  The script builds DIR's kernels and runs DIR's own chip_smoke.py
on ENC-512 (512 AAC-LC stereo streams at 44.1 kHz and 128 kbps, chunks of
16 frames): `phase_encode_serving` (encode_aggregate_realtime_x over two
runs, the stage split, the analysis program's device time, launches and
costliest ops from a torch.profiler trace) and `graph_case` on the analysis
program (eager and CUDA graph side by side: the host's launches, host ms,
device ms, ms by CUDA events) and `phase_enc_scans_kernels` (the encoder's
two scan kernels against their plain versions on an ENC-512 chunk's
intermediates: ms a call by events, device ms, bound, plain ms).  It prints
their `ENC-512:`, `graphs:` and `kernel enc_` lines, each tagged with the
tree (`[parent]` or `[change]`).
`scripts/ab_encoder.sh PARENT_TREE` runs parent, change, change, parent in
one call.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    import aacjax_torch
    from aacjax_torch.kernels import _build
    from aacjax_torch.testing import encode_serving_pcm
    tag = "parent" if tree != REPO else "change"
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _build.build()
            smoke.phase_encode_serving(torch)
            enc = aacjax_torch.BatchEncoder(44100, 2, smoke.ENC_BITRATE,
                                            n_streams=smoke.ENC_STREAMS)
            pcm = encode_serving_pcm(smoke.ENC_STREAMS, smoke.ENC_CHUNK * 1024)
            _, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(pcm)
            ins = tuple(torch.from_numpy(a).to("cuda") for a in (
                pcm_i16, w_idx.astype(np.int64), is_short))
            smoke.graph_case(torch, "encode analysis ENC-512",
                             enc._analysis_for(nF), ins, smoke.exact_tol)
            smoke.phase_enc_scans_kernels(torch, torch.device("cuda"), {})
    except BaseException:
        print(out.getvalue()[-4000:])
        raise
    for line in out.getvalue().splitlines():
        if line.startswith(("ENC-512:", "graphs:", "kernel enc_")):
            print(f"[{tag}] {line}")


if __name__ == "__main__":
    main()
