#!/usr/bin/env python3
"""Where a PS-512 chunk's time goes on a 4x1 mesh of virtual shards of one
CUDA GPU, against the same chunk unsharded, for one tree of the port.

    python3 scripts/trace_ps_mesh.py --tree DIR

DIR holds the `aacjax_torch` and `chip_smoke.py` under test (this
repository's root, or an archive of another commit, which imports its own
code); `scripts/trace_ps_mesh.sh PARENT_TREE` runs the parent and this
tree in one call.  512 mono HE-AAC v2 streams (chip_smoke's PS-512 corpus,
`cce_slots=1`, C = 1024, chunks of 8 frames), one decoder per layout, each
warmed on one chunk.  Printed per layout, one line each, tagged with the
tree and the layout:

  - the stages of one chunk run one after the other: the host phase
    (`_he_host_phase`: the core parse, the Python SBR and PS packers),
    the host's time to enqueue the device half (`_device_step` and
    `_sbr_upload` + `_sbr_dispatch`: the core step and the SBR + PS
    program of every shard), and the device's time from the first of that
    work to the last (CUDA events);
  - a torch.profiler trace of that enqueue and its device work: the
    runtime's kernel launches, graph launches and copies, the device time
    summed over its activities and the device's busy share of the traced
    wall;
  - the wall per chunk of decode_he_pipelined over 3 chunks.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import aacjax_torch
    import chip_smoke as CS
    from aacjax_torch.runtime import mesh as meshlib
    tag = f"[{tree.name}]"
    config, corpus = CS.he_corpus(True)
    chunks = CS.mesh_serving_chunks(corpus, 5, CS.HE_CHUNK)
    dev = torch.device("cuda", 0)
    # the first trace of a process pays the profiler's start-up: not here
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    layouts = (("unsharded", None),
               ("4x1", meshlib.make_mesh(4, 1, devices=[dev] * 4)))
    for name, mesh in layouts:
        dec = aacjax_torch.BatchDecoder([config] * CS.N_STREAMS,
                                        chunk_frames=CS.HE_CHUNK, cce_slots=1)
        list(dec.decode_he_pipelined(iter(chunks[:1]), mesh=mesh))
        torch.cuda.synchronize()

        def host_phase(k):
            return dec._he_host_phase(chunks[k], compact=True, buf_slot=k & 1)

        def dispatch(host):
            parsed, dense, ctx = host
            m = dec._mesh(mesh)
            core = dec._device_step(parsed, mesh=m)
            return dec._sbr_dispatch(core, *dec._sbr_upload(dense, ctx, m),
                                     ctx, True, m)

        host_s, enqueue_s, device_ms = [], [], []
        for k in (1, 2):
            t0 = time.perf_counter()
            host = host_phase(k)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record(dec._compute_stream)
            t2 = time.perf_counter()
            pcm2, _ = dispatch(host)
            t3 = time.perf_counter()
            b.record(dec._compute_stream)
            b.synchronize()
            dec.finalize_step(pcm2)
            host_s.append(t1 - t0)
            enqueue_s.append(t3 - t2)
            device_ms.append(a.elapsed_time(b))
        print(f"{tag} {name}: host phase {np.round(host_s, 4).tolist()} s, "
              f"enqueue of the device half {np.round(enqueue_s, 4).tolist()}"
              f" s, device (first to last of it, CUDA events) "
              f"{np.round(device_ms, 3).tolist()} ms", flush=True)

        host = host_phase(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pcm2, _ = dispatch(host)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        dec.finalize_step(pcm2)
        n = dict(kernels=0, graphs=0, copies=0)
        spans = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
            elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx"):
                n["kernels"] += 1
            elif e.name == "cudaGraphLaunch":
                n["graphs"] += 1
            elif e.name.startswith(("cudaMemcpy", "cudaMemset")):
                n["copies"] += 1
        busy, end = 0.0, None
        for s, e in sorted(spans):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        total = sum(e - s for s, e in spans)
        print(f"{tag} {name}: traced enqueue + device work of one chunk: "
              f"{n['kernels']} kernel launches, {n['graphs']} graph "
              f"launches, {n['copies']} copies; device activity "
              f"{total / 1e3:.3f} ms summed, busy {busy / 1e3:.3f} ms of the "
              f"{wall_us / 1e3:.3f} ms traced wall "
              f"({100 * busy / wall_us:.1f}%)", flush=True)

        walls = []
        for _ in range(2):
            d2 = aacjax_torch.BatchDecoder([config] * CS.N_STREAMS,
                                           chunk_frames=CS.HE_CHUNK,
                                           cce_slots=1)
            list(d2.decode_he_pipelined(iter(chunks[:1]), mesh=mesh))
            t0 = time.perf_counter()
            list(d2.decode_he_pipelined(iter(chunks[1:4]), mesh=mesh))
            walls.append((time.perf_counter() - t0) / 3)
        print(f"{tag} {name}: decode_he_pipelined wall per chunk over 3 "
              f"chunks (2 runs, each after a warm-up chunk) "
              f"{np.round(walls, 4).tolist()} s", flush=True)


if __name__ == "__main__":
    main()
