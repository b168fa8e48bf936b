#!/usr/bin/env python3
"""Drive the port's serving paths once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. environment (GPU, power limit, torch, nvcc, triton, native parser),
     the build of the CUDA kernels from aacjax_torch/kernels/csrc and what
     ptxas reported for each kernel (registers, spills), and for the
     encoder's two scan kernels the conversion and leading-zero
     instructions (FRND, F2I, I2F, FLO) in their SASS (cuobjdump);
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes and a few others, with its time beside the plain
     version's, the least time the card could take for the same work
     (its bound) and a PyTorch library call as a yardstick where one
     exists (CUDA events, median of 20 runs of 10 back-to-back calls for
     the kernels and the library calls, of 1 call for the plain versions;
     the plain TNS, a Python loop over the bins that takes seconds, is
     timed over the one call that makes the reference), and each kernel's
     own device time per call from a torch.profiler trace of 10 calls.
     TNS runs at 256, 4096 and 16384 rows of whole-spectrum order-2/12/20
     filters in both directions, and at 16384 rows (the serving chunk) of
     a serving-like mix read from compact int16 spectra and the parser's
     packed filter planes.  The Main-profile predictor runs at C = 1024,
     T = 16 (the serving chunk) and C = 8, T = 64 on inputs with every
     mode and reset, and must equal its plain version bit for bit, as must
     the batched encoder's two scan kernels (the psy spread and the
     rate-cost grid) on the intermediates of one ENC-512 chunk (N = 16384)
     and of a mono 32 kHz chunk with an odd N;
  3. the serving slice at full width: 512 concurrent AAC-LC stereo streams
     (44.1 kHz, ~200 kbps; the reference's headline corpus),
     chunk_frames=16, through BatchDecoder.decode_pipelined, five runs --
     launch counts, every chunk of every stream of every run against the
     plain route (and the share of int16 samples that differ), the host's
     cores and parse threads, aggregate realtime x (median of the runs),
     stage split; then the same width over a corpus whose chunks carry TNS
     (LC-512-tns: random legal frames with M/S, short windows and TNS, f32
     PCM delivered because its synthetic audio is far outside the int16
     range), two runs -- TNS and tail launches, every chunk against the
     plain route, stage split; then Main-512, 512 Main-profile stereo
     streams (C = 1024 slots) of random legal frames with prediction, reset
     groups, short windows, M/S and TNS, 3 chunks, two runs, f32 PCM -- per
     chunk one predictor, one synthesis (B = 16384) and one TNS launch and
     no tail launch, every chunk against the plain route; then MC-128-cce,
     128 5.1 streams with two coupling slots each (C = 1024) whose frames
     carry a dependent AFTER_TNS coupling element onto TNS'd targets and an
     independent one, 2 chunks, against the plain route;
  4. decode_adts on a stream with short windows and TNS (synthesis and TNS
     kernels) and on a mono stream in chunks of 5 frames (synthesis at
     C*T = 15), each against the plain route on the CPU, and the round-trip
     SNR of an encoded tone; then the other routes, each against the same
     call on the CPU: Main with intensity stereo (delegated to the python
     parser and packer, decode_step on the card), ELD-512 and LD-480 through
     decode_loas, 960-sample frames through AACDecoder, frames of three
     raw_data_blocks, and AAC-LTP;
  5. HE-AAC v1 (SBR; PyTorch on the card, as the reference's SBR program is
     plain XLA): right after phase 2, the QMF banks at B = 1024, S = 256 and
     one sbr_apply at the HE-512 chunk's shape (f32 and int16) against the
     same calls on the CPU, its time, peak memory and ten costliest device
     ops (torch.profiler); after phase 4, HE-512 -- 512 HE-AAC v1 stereo
     streams (C = 1024; 22.05 kHz core, 44.1 kHz out; bench_he's corpus),
     chunk_frames=8, decode_he_pipelined with int16 PCM, 2 runs of 4
     chunks: launch counts (1 tail a chunk on the q/sf core), peak memory,
     every chunk against the same route's step, its core against the plain
     core route and its int16 PCM against the plain core's, held to the HE
     bound (HE_I16_ONSET / HE_I16_STEADY, derived beside HE_ROUTE_TOL),
     he_aac_aggregate_realtime_x per run, the stage split (host phase, the
     copies up, core and SBR compute, the copy down) and a cProfile of one
     host phase; then decode_adts on an HE stream whose core carries TNS,
     the streaming AACDecoder, and step_he_raw over a mid-chunk SBR header
     change (float64 replay, re-adoption), each against the CPU;
  6. HE-AAC v2 (Parametric Stereo): in phase 2 the fused PS decorrelator
     kernel at C = 1024, T = 8 and at B = 3, T = 1 in both band modes,
     bit-equal to its plain version over two calls, with its time, bound,
     the plain version's time and the reference's Toeplitz-product form as
     a yardstick; after the HE checks, one sbr_ps_apply at the PS-512
     chunk's shape on the card against the CPU with its device time and
     costliest ops; after HE-512, PS-512 --
     512 HE-AAC v2 mono streams decoded as stereo (bench_he(ps=True)'s
     corpus, cce_slots=1: C = 1024), as HE-512 (1 tail and 1 decorrelator
     launch a chunk, he_aac_v2_aggregate_realtime_x, stage split with the
     PS planes' copy, the HE bound); then decode_adts on a 20-band and a
     34-band stream, a mixed 20/34 batch, a band-scheme flip, AACDecoder
     and save / restore, each against the CPU;
  7. the user surfaces: decode_m4a on an LC and an HE .m4a against the CPU,
     AACFile ranged reads against a full decode on the card bit for bit and
     an HE seek's convergence, the Aurora pipe against decode_adts, the CLI's
     info and decode by subprocess, and a good stream beside garbage against
     its solo decode;
  8. ENC-512, the batched encoder at serving width: 512 AAC-LC stereo
     streams at 44.1 kHz and 128 kbps (bench.py bench_encode's traffic),
     chunks of 16 frames, a warm-up chunk and 2 runs of encode_pipelined
     over 4 chunks -- encode_aggregate_realtime_x per run and their median,
     the stage split, the pipelined payloads against sequential encode_chunk
     byte for byte, the encoder's scan kernels launched once a chunk each,
     one chunk's analysis and quantize against the CPU, the device
     programs' time, launches, costliest ops and peak memory; then
     every stream decoded on the card through decode_pipelined (the tail
     kernel), its SNR against its source held to 32 of the streams encoded
     and decoded on the CPU route (within 0.5 dB);
  9. the mesh (aacjax_torch/runtime/mesh.py), 4 shards on distinct cards
     where the machine has them, else virtual shards of one card: LC-512 on
     a 4x1 mesh through decode_pipelined(mesh=), every chunk bit-equal to
     the unsharded card run, with its tail launches and realtime_x beside
     the unsharded run's; LC-512 on 2x2 (the frame axis) within 1 LSB on
     < 2% of samples, the carry after each of three chunks within 3e-3;
     Main-512 on 2x2 (the predictor's state handed over frame shards, TNS
     per shard) within 5e-5 * max|ref|; HE-512 and PS-512 on 4x1, 2 chunks,
     f32 within 1e-5 * max(1, max|ref|) and int16 within the HE bound, one
     decorrelator launch a shard a chunk; ENC-512 on 4x1, 2 chunks, every
     frame byte-identical to the unsharded run, one launch of each encoder
     scan kernel a shard a chunk, and each stream's SNR within 0.5 dB of
     the unsharded run's; graft_entry.dryrun_multichip(4).  Its launches
     count into the kernels line;
 10. the compiled programs (aacjax_torch/runtime/graphs.py), which phases 3
     to 9 run as CUDA graphs: every program at its serving shape
     (decode_spec_step at LC-512's and Main-512's chunk, decode_step,
     sbr_apply at HE-512's, sbr_ps_apply 20- and 34-band and the dual
     program at PS-512's, the encoder's analysis and quantize at ENC-512's)
     and the decode step at the small shapes of the tail (C = 8, T = 64)
     and of the synthesis route (B = 256), each captured into a pool of its
     own: a replay held against the eager function on the same inputs (bit
     for bit; a difference is named and held to the program's bound), the
     kernel launches a replay counts against the eager call's, then per
     call, eager and graph side by side, the kernel and graph launches and
     copies the host made and the device ops (a torch.profiler trace of 10
     calls; one graph launch a call), the host's enqueue ms, the device ms,
     the ms by CUDA events (median of 10 runs of 3 calls), and the
     capture ms and pool bytes of the graph;
 11. the port's benchmark (aacjax_torch/bench.py) cut in depth: the LC
     headline by its command line in a process of its own (python -m
     aacjax_torch.bench --lc-only --seconds 2 --repeats 2, 512 streams),
     its JSON line held to the reference's schema, every stage key present,
     every value finite and positive and `device` naming the card; then
     bench_he, bench_he(ps=True) at 512 streams and bench_encode at 128, 2 s
     of audio a stream and 1 rep each, in this process: no mode with an
     error, the stage keys, and the tail, the PS decorrelator and the
     encoder's two scan kernels launched on their modes (these launches
     count into the kernels line).
The last two lines are a JSON object of the kernels' results and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
N_STREAMS = 512
CHUNK = 16
WINDOWS = 5        # pipelined runs over the whole corpus; median reported
TNS_WINDOWS = 2    # pipelined runs of the LC-512-tns pass
MAIN_WINDOWS = 2   # pipelined runs of the Main-512 pass
TIMING_RUNS = 20
REPS = 10          # back-to-back calls per timed run of a kernel
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes/s
# and FP32 FLOP/s outside the tensor cores (an FMA counts 2)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, runs: int = TIMING_RUNS, reps: int = 1) -> float:
    """Median over `runs` of the device time (CUDA events) of `reps`
    back-to-back calls, per call, after a warm-up call.  With reps > 1 the
    host launches the next call while the card runs the last, so a
    kernel's time excludes the host's per-call work unless that is the
    longer of the two."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def device_ms(torch, fn, kernel: str, reps: int = REPS) -> float | None:
    """The device time per call (ms) of the kernels whose name holds
    `kernel`, from a torch.profiler trace of `reps` calls after a warm-up
    call: their summed time over `reps` (a wrapper may launch several).
    None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) or e.cuda_time_total
                for e in evs)
    return total / reps / 1e3 if total else None


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# FP32 operations of one frame through the FFT IMDCT as the kernel
# computes it (kernels/imdct.py): complex multiply 6, the 8-point DFT's
# butterflies 52.  Long: pre- and post-twiddle (512 each), three radix-8
# passes of 64 DFTs with 7 twiddles after each of the first two.  Short:
# 8 x 64 pre- and post-twiddles, two passes, one set of twiddles.
FFT_FLOPS = {False: 6 * 512 * 2 + 3 * 64 * 52 + 2 * 64 * 7 * 6,
             True: 6 * 512 * 2 + 2 * 64 * 52 + 64 * 7 * 6}
DENSE_FLOPS = {False: 2 * 1024 * 2048, True: 8 * 2 * 128 * 256}


def filterbank_flops(is_short, per_sample: int) -> float:
    """Operations of the filterbank over frames with flags `is_short`
    (numpy), with `per_sample` more per output sample (decompression,
    windows, overlap-adds, concealment, scale)."""
    n_short = int((np.asarray(is_short) != 0).sum())
    n_long = np.asarray(is_short).size - n_short
    return (n_long * FFT_FLOPS[False] + n_short * FFT_FLOPS[True]
            + np.asarray(is_short).size * 1024 * per_sample)


def dense_bound_ms(rows: int) -> float:
    """The bound of the same rows under the dense-product algorithm (the
    long product spec @ M_long for every row, FP32 FFMA)."""
    return rows * DENSE_FLOPS[False] / FP32_FLOP_S * 1e3


def tns_flops(args) -> float:
    """Operations the TNS inputs need: per bin inside a filter's region,
    `order` compensated multiply-adds (TwoProd + TwoSum, ~20 operations
    each) and the closing TwoSums (~13)."""
    total = 0.0
    for d in (0, 3):                   # forward, reverse
        lpc, start, end = (np.asarray(a.cpu()) for a in args[1 + d:4 + d])
        nz = lpc != 0
        order = np.where(nz.any(-1), 20 - np.argmax(nz[..., ::-1], -1), 0)
        span = np.maximum(end - start, 0)
        total += float((span * (20 * order + 13) * (order > 0)).sum())
    return total


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel from nvcc's -Xptxas -v output: its registers,
    shared memory and spills (filterbank modes: 0 int16 PCM, 1 f32 PCM,
    2 the synthesis halves)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            k = re.search(r"filterbank_kernelILb(\d)ELi(\d)E", name)
            t = re.search(r"(tns_(?:filter|prepare)_kernel)ILi(\d+)ELb(\d)E",
                          name)
            plain = [n for n in ("pred_kernel", "ps_decorrelate_kernel",
                                 "enc_spread_kernel", "enc_rate_cost_kernel")
                     if n in name]
            kind = (f"filterbank_kernel<spec_i16={k[1]}, mode={k[2]}>" if k
                    else f"{t[1]}<F={t[2] if t[2] != '0' else 'any'}, "
                         f"spec_i16={t[3]}>" if t
                    else plain[0] if plain else name)
            out.append(f"ptxas {kind}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name, spill = None, ""
    return out


SLOW_OPS = ("FRND", "F2I", "I2F", "FLO")


def sass_counts(lib_path, kernels) -> dict:
    """For each kernel named in `kernels`, its SASS instructions in the
    built library (cuobjdump -sass) counted by opcode (the mnemonic before
    its first '.'), over every instantiation whose name holds it."""
    from aacjax_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts = {k: {} for k in kernels}
    current = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((k for k in kernels if k in m.group(1)), None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and current:
            op = m.group(1).split(".")[0]
            counts[current][op] = counts[current].get(op, 0) + 1
    return counts


# -- phase 2: each kernel against its plain version ---------------------------
def phase_kernels(torch, dev) -> dict:
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import synth, tail
    results = {}
    tabs = [P.consts(dev)[k] for k in ("twiddles", "f_table", "s_table",
                                       "rise", "fall")]

    def on_dev(arrays):
        return [None if a is None else torch.from_numpy(a).to(dev)
                for a in arrays]

    def fft_ms(rows):
        z = torch.randn(rows, 512, dtype=torch.complex64, device=dev)
        return time_ms(torch, lambda: torch.fft.fft(z), reps=REPS)

    def tail_case(name, C, T, i16, out16, ragged, short, amp, key=None):
        b = TI.random_tail_chunk(len(name), C, T, i16=i16, has_short=short,
                                 ragged=ragged, amp=amp)
        args = on_dev(b[k] for k in TI.TAIL_ARGS)
        kw = dict(out_int16=out16, has_short=short)
        pcm, ov = tail.decode_tail(*args, **kw)
        ref, ref_ov = tail.decode_tail_ref(*args, **kw)
        torch.cuda.synchronize()
        err = TI.assert_pcm_close(pcm.cpu(), ref.cpu(), out16, name)
        share = float((pcm != ref).float().mean())
        ov_err = float((ov - ref_ov).abs().max())
        check(ov_err <= 3e-3, f"{name}: overlap err {ov_err} > 3e-3")
        line = (f"kernel tail {name}: max err {err} ({share:.5f} of samples "
                f"differ; overlap {ov_err}, max|ref| "
                f"{float(ref.abs().float().max())})")
        if key:
            ms = time_ms(torch, lambda: tail.decode_tail(*args, **kw),
                         reps=REPS)
            dms = device_ms(torch, lambda: tail.decode_tail(*args, **kw),
                            "filterbank_kernel")
            plain = time_ms(torch, lambda: tail.decode_tail_ref(*args, **kw))
            per_sample = (1 if i16 else 0) + 5      # decompress, 2 windows,
            flops = filterbank_flops(b["is_short"], per_sample)  # add, keep, pack
            b_ms, b_by = bound(nbytes(*args, *tabs, pcm, ov), flops)
            lib = fft_ms(C * T)
            results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib)
            line += (f"; {ms:.4f} ms per call (device {fmt(dms)}), plain "
                     f"{plain:.4f} ms, bound {b_ms:.4f} "
                     f"ms ({b_by}; dense-product bound "
                     f"{dense_bound_ms(C * T):.4f} ms), torch.fft.fft "
                     f"[{C * T}, 512] {lib:.4f} ms")
        say(line)

    # spectra scaled so that the PCM spans ~+-5000, inside the int16 range
    tail_case("serving C=1024 T=16 i16->int16 all-long", 1024, 16, True,
              True, False, False, 3000.0, key="tail")
    tail_case("C=1024 T=16 f32->int16 quarter short", 1024, 16, False,
              True, False, True, 3000.0, key="tail_short")
    tail_case("C=8 T=64 f32->f32 ragged short", 8, 64, False, False, True,
              True, 3000.0, key="tail_small")
    for i16 in (True, False):
        for out16 in (True, False):
            tail_case(f"C=8 T=4 ragged short {'i16' if i16 else 'f32'}->"
                      f"{'int16' if out16 else 'f32'}", 8, 4, i16, out16,
                      True, True, 3000.0)

    for B, key in ((256, "synthesis_256"), (16384, "synthesis")):
        np_args = TI.random_synth_batch(4, B)
        args = on_dev(np_args)
        first, second = synth.synthesis(*args)
        rf, rs = synth.synthesis_ref(*args)
        torch.cuda.synchronize()
        scale = max(1.0, float(rf.abs().max()), float(rs.abs().max()))
        err = max(float((first - rf).abs().max()),
                  float((second - rs).abs().max()))
        check(err <= 5e-5 * scale, f"synthesis B={B}: err {err} > "
              f"{5e-5 * scale}")
        ms = time_ms(torch, lambda: synth.synthesis(*args), reps=REPS)
        dms = device_ms(torch, lambda: synth.synthesis(*args),
                        "filterbank_kernel")
        plain = time_ms(torch, lambda: synth.synthesis_ref(*args))
        b_ms, b_by = bound(nbytes(*args, *tabs, first, second),
                           filterbank_flops(np_args[5], 2))
        lib = fft_ms(B)
        results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib)
        say(f"kernel synthesis B={B} mixed sequences: max err {err} (scale "
            f"{scale:.1f}); {ms:.4f} ms per call (device {fmt(dms)}), "
            f"plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; dense-product bound "
            f"{dense_bound_ms(B):.4f} ms), torch.fft.fft [{B}, 512] "
            f"{lib:.4f} ms")

    a = torch.randn(16384, 1024, device=dev)
    m = P.consts(dev)["m_long"]
    mm = time_ms(torch, lambda: torch.matmul(a, m), reps=REPS)
    say(f"yardstick: torch.matmul [16384, 1024] x [1024, 2048] fp32 (the "
        f"dense IMDCT product alone, TF32 "
        f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}): "
        f"{mm:.4f} ms")
    results["_matmul_ms"] = mm

    phase_tns_kernel(torch, dev, results)
    phase_pred_kernel(torch, dev, results)
    phase_ps_decorr_kernel(torch, dev, results)
    phase_enc_scans_kernels(torch, dev, results)
    return results


def phase_tns_kernel(torch, dev, results: dict) -> None:
    """The TNS kernel against its plain version; the serving-mix case at
    the serving chunk's shape is the one `results` keeps."""
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import tns

    def on_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def tns_case(name, np_args, packed, key=None):
        """One TNS input against the plain version: the reference's
        arguments (f32 spectra, planes per direction) through tns.tns, or
        compact int16 spectra and the parser's packed planes through
        tns.tns_packed."""
        args = on_dev(np_args)
        fn, ref_fn = ((tns.tns_packed, tns.tns_packed_ref) if packed
                      else (tns.tns, tns.tns_ref))
        out = fn(*args)
        # the plain version is a Python loop over the bins, ~0.3 M small
        # launches (seconds): one call makes the reference and is timed
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ref = ref_fn(*args)
        b.record()
        torch.cuda.synchronize()
        plain = a.elapsed_time(b)
        if packed:
            q, sc, lpc, rng = args
            xmax = float(P.decompress_i16(q, sc).abs().max())
            planes = (None, lpc[:, :, 0], rng[:, :, 0, :, 0],
                      rng[:, :, 0, :, 1], lpc[:, :, 1], rng[:, :, 1, :, 0],
                      rng[:, :, 1, :, 1])
        else:
            xmax = float(args[0].abs().max())
            planes = args
        err = float((out - ref).abs().max())
        rows = out.shape[0] * out.shape[1]
        check(bool(torch.isfinite(out).all()), f"tns {name}: non-finite output")
        check(err <= 1e-6 * xmax, f"tns {name}: err {err} > {1e-6 * xmax}")
        ms = time_ms(torch, lambda: fn(*args), reps=REPS)
        dms = device_ms(torch, lambda: fn(*args), "tns_")
        b_ms, b_by = bound(nbytes(*args, out), tns_flops(planes))
        if key:
            results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
        say(f"kernel tns B={rows} {name}: max err {err} (max|x| {xmax:.1f}); "
            f"{ms:.4f} ms per call (device {fmt(dms)}), plain {plain:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); no PyTorch call computes TNS")

    for C, T in ((4, 64), (256, 16), (1024, 16)):
        tns_case("orders 2/12/20, whole spectrum, both directions",
                 TI.random_tns_chunk(5 + C, C, T), False)
    tns_case("serving mix (40% of rows, order <= 12, bins < 736), compact "
             "i16 + packed planes", TI.serving_tns_chunk(7, 1024, CHUNK),
             True, key="tns")


def pred_chunk(seed: int, C: int, T: int) -> list[np.ndarray]:
    """Predictor inputs with every mode (0 none, 1 long, 2 short; long the
    most frequent), reset groups on a third of the frames, nbins at and
    below 672 and `used` set in runs of 16 bins on half of them: (spec,
    mode, reset, nbins, used)."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((C, T, 1024), dtype=np.float32) * 300
    mode = rng.choice([0, 1, 1, 1, 1, 2], size=(C, T)).astype(np.int32)
    reset = np.where(rng.random((C, T)) < 0.33,
                     rng.integers(1, 31, (C, T)), 0).astype(np.int32)
    nbins = rng.choice([672, 672, 640, 512], size=(C, T)).astype(np.int32)
    used = np.repeat(rng.random((C, T, 42)) < 0.5, 16, axis=-1).astype(np.uint8)
    return [spec, mode, reset, nbins, used]


def phase_pred_kernel(torch, dev, results: dict) -> None:
    """The predictor kernel against its plain version, bit for bit, over
    two chunks with the state carried; the case at the serving chunk's shape
    is the one `results` keeps."""
    from aacjax_torch.kernels import pred

    def bits_equal(a, b):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    for C, T, key in ((1024, CHUNK, "pred"), (8, 64, None)):
        st_k = st_p = pred.pred_state_init(C, dev)
        err = 0.0
        for k in range(2):
            args = [torch.from_numpy(a).to(dev) for a in pred_chunk(C + k, C, T)]
            out, st_k = pred.apply_prediction(*args, st_k)
            ref, st_p = pred.apply_prediction_ref(*args, st_p)
            torch.cuda.synchronize()
            err = max(err, float((out - ref).abs().max()),
                      float((st_k - st_p).abs().max()))
            check(bits_equal(out, ref) and bits_equal(st_k, st_p),
                  f"pred C={C} T={T} chunk {k}: kernel and plain version "
                  f"differ (max err {err})")
            check(bool(torch.isfinite(out).all()), "pred: non-finite output")
        spec, mode, reset, nbins, used = args
        work = spec.clone()     # timed in place, as the main path calls it

        def run():
            return pred.apply_prediction(work, mode, reset, nbins, used, st_k,
                                         inplace=True)

        ms = time_ms(torch, run, reps=REPS)
        dms = device_ms(torch, run, "pred_kernel")
        plain = time_ms(torch, lambda: pred.apply_prediction_ref(*args, st_k),
                        runs=5)
        # bytes: the 672 predicted bins read and written, `used`, the three
        # planes, the state in and out.  Operations: ~9 per (channel, frame,
        # bin) for the prediction, ~23 more where the state moves
        kk = torch.arange(672, device=dev)
        n_upd = int(((mode == 1)[..., None] & (kk < nbins[..., None])).sum())
        nb = (2 * C * T * 672 * 4 + nbytes(used, mode, reset, nbins)
              + 2 * nbytes(st_k))
        b_ms, b_by = bound(nb, 9.0 * C * T * 672 + 23.0 * n_upd)
        if key:
            results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
        say(f"kernel pred C={C} T={T} every mode, resets: max err {err} on "
            f"spectra and state (bit-equal); {ms:.4f} ms per call (device "
            f"{fmt(dms)}), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nb / 1e6:.1f} MB); no PyTorch call computes it")


def toeplitz_ms(torch, dev, B: int, S: int, is34: bool) -> float:
    """The yardstick of the allpass: the reference's default form of its
    recurrences (AACJAX_PS_SCAN=matmul), per link m (delay d = 3 + m) one
    complex product of the [nap, n, n] lower-triangular Toeplitz matrix
    g^(i-k) (g = a_m q_m, n = ceil(S / d)) with the link's input as
    [nap, n, B d] columns: three torch.matmul calls in complex64, the
    shapes of B rows over S slots.  Per call, CUDA events."""
    from aacjax_torch.kernels import ps_batch as PB
    c = PB.consts_np(is34)
    nap = PB._NAP[is34]
    mats, cols = [], []
    for m in range(3):
        d = m + 3
        n = -(-S // d)
        g = (c["ag"][:, m].astype(np.float64)
             * (c["qf_r"][:, m] + 1j * c["qf_i"][:, m]))
        lag = np.arange(n)[:, None] - np.arange(n)[None, :]
        tm = np.where(lag >= 0, g[:, None, None] ** np.clip(lag, 0, None), 0)
        mats.append(torch.from_numpy(tm.astype(np.complex64)).to(dev))
        cols.append(torch.randn(nap, n, B * d, dtype=torch.complex64,
                                device=dev))

    def run():
        return [torch.matmul(t, w) for t, w in zip(mats, cols)]
    return time_ms(torch, run, reps=REPS)


def ps_decorr_bytes(B: int, S: int, is34: bool) -> int:
    """The bytes the fused decorrelator must move: s_r, s_i read and d_r,
    d_i written once ([B, S, nb] f32 each), the state (delay lines
    [B, nb, 14], allpass lines [B, nap, 3, 5], detector [B, npar], re and
    im where complex) read and written once."""
    from aacjax_torch.kernels import ps_batch as PB
    nb, npar, nap = PB._NB[is34], PB._NPAR[is34], PB._NAP[is34]
    state = 2 * nb * 14 + 2 * nap * 15 + 3 * npar
    return 4 * B * (4 * S * nb + 2 * state)


def ps_decorr_flops(B: int, S: int, is34: bool) -> float:
    """Its FP32 operations: per (slot, band) 3 for the power and 2 for the
    gains; per (slot, parameter band) ~10 for the detector's step (a
    product, a max, two smoothers, the test and the quotient); per (slot,
    allpass band) 6 for the rotation and 14 per link (6 products and 4 sums
    for n, 2 of each for the push)."""
    from aacjax_torch.kernels import ps_batch as PB
    nb, npar, nap = PB._NB[is34], PB._NPAR[is34], PB._NAP[is34]
    return float(B * S * (5 * nb + 10 * npar + 48 * nap))


def phase_ps_decorr_kernel(torch, dev, results: dict) -> None:
    """The fused PS decorrelator kernel against its plain version at PS-512's
    chunk shape (C = 1024 rows, T = 8: S = 256 slots) and at B = 3, T = 1
    (one tile, a batch of few rows), in both band modes, over two calls
    with the state carried, d and every state tensor bit for bit; at the
    serving shape its time per call and device time, its bound, the plain
    version's time (one call, a Python loop over the slots) and the
    Toeplitz-product yardstick.  The 20-band case (PS-512's mode) is the
    one `results` keeps."""
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import ps_decorr

    def bits_equal(a, b):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    B, S = 2 * N_STREAMS, 32 * HE_CHUNK
    for is34 in (False, True):
        npar, nap = PB._NPAR[is34], PB._NAP[is34]
        c, sdb = PB._consts(is34, dev), PB._SDB[is34]
        for rows, slots in ((3, 32), (B, S)):
            s_r, s_i, st = TI.ps_decorr_inputs(3 + is34, rows, slots, is34)
            s_r, s_i = (torch.from_numpy(a).to(dev) for a in (s_r, s_i))
            st_k = st_p = {k: torch.from_numpy(v).to(dev)
                           for k, v in st.items()}
            plain = None
            for k in range(2):
                x = ((s_r, s_i) if k == 0
                     else tuple(a.flip(1).contiguous() for a in (s_r, s_i)))
                got = ps_decorr.decorrelate_chunk(*x, st_k, c, sdb)
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                want = ps_decorr.decorrelate_chunk_ref(*x, st_p, c, sdb)
                b.record()
                torch.cuda.synchronize()
                plain = plain or a.elapsed_time(b)
                pairs = [("d_r", got[0], want[0]), ("d_i", got[1], want[1])]
                pairs += [(n, got[2][n], want[2][n])
                          for n in ps_decorr.STATE_KEYS]
                for n, g, w in pairs:
                    check(bits_equal(g, w), f"ps_decorr {npar}-band B={rows} "
                          f"S={slots} call {k}: {n} differs from the plain "
                          f"version (max err {float((g - w).abs().max())})")
                check(bool(torch.isfinite(got[0]).all()
                           and torch.isfinite(got[1]).all()),
                      "ps_decorr: non-finite output")
                st_k, st_p = got[2], want[2]
            if rows != B:
                say(f"kernel ps_decorr B={rows} S={slots} {npar}-band: "
                    "bit-equal to the plain version over 2 calls (state "
                    "carried)")

        def run():
            return ps_decorr.decorrelate_chunk(s_r, s_i, st_k, c, sdb)
        ms = time_ms(torch, run, reps=REPS)
        dms = device_ms(torch, run, "ps_decorrelate_kernel")
        nb = ps_decorr_bytes(B, S, is34)
        b_ms, b_by = bound(nb, ps_decorr_flops(B, S, is34))
        lib = toeplitz_ms(torch, dev, B, S, is34)
        if not is34:
            results["ps_decorr"] = dict(max_abs_err=0.0, ms=ms,
                                        device_ms=dms, plain_ms=plain,
                                        bound_ms=b_ms, bound_by=b_by,
                                        library_ms=lib)
        say(f"kernel ps_decorr B={B} S={S} {npar}-band: bit-equal to the "
            f"plain version over 2 calls (state carried); {ms:.4f} ms per "
            f"call (device {fmt(dms)}), plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB: s in, d out, the "
            f"state in and out), the reference's default allpass form (3 "
            f"complex Toeplitz torch.matmul, [{nap}, n, n] x [{nap}, n, {B} "
            f"d]) {lib:.4f} ms; no PyTorch call computes the whole "
            "decorrelation")


def phase_enc_scans_kernels(torch, dev, results: dict) -> None:
    """The batched encoder's two scan kernels (kernels/enc_scans.py) against
    their plain versions, bit for bit, on the intermediates of real chunks
    through the eager analysis program: one ENC-512 chunk (512 stereo
    streams of 16 frames at 44.1 kHz and 128 kbps: N = 16384 rows, nb = 36,
    Pe = 544) and a mono 32 kHz chunk at 64 kbps with an odd N (37 streams
    of 3 frames: N = 111, nb = 43, Pe = 768); at ENC-512's shape, the one
    `results` keeps, each kernel's time per call and device time, its
    bound and its plain version's time (one call of the Python loop)."""
    import aacjax_torch
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import enc_scans as ES
    from aacjax_torch.testing import encode_serving_pcm

    def bits_equal(a, b):
        return a.shape == b.shape and bool(torch.equal(
            a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))

    def plain_ms(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    cases = (("ENC-512", aacjax_torch.BatchEncoder(
                 44100, 2, ENC_BITRATE, n_streams=ENC_STREAMS),
              encode_serving_pcm(ENC_STREAMS, ENC_CHUNK * 1024)),
             ("mono 32 kHz, N=111", aacjax_torch.BatchEncoder(
                 32000, 1, 64_000, n_streams=37),
              encode_serving_pcm(37, 3 * 1024)[:, :, :1]))
    for name, enc, pcm in cases:
        seen, _ = TI.enc_scans_inputs(enc, pcm, dev)
        sp_args = seen["spread"][0]
        t34, is_short, regions, base, fit_sf, zero_sf, offsets = \
            seen["rate_cost"][0]
        region = torch.where(is_short[:, None], regions[1], regions[0])
        lut = ES._constants(offsets, dev)["lut"]
        rc_ref = (t34, region, base, fit_sf, zero_sf, lut, offsets)
        (N, nb), (Pe, K) = base.shape, (t34.shape[1], len(offsets))
        for key, run, ref in (
                ("enc_spread", lambda: ES.spread(*sp_args),
                 lambda: ES.spread_ref(*sp_args)),
                ("enc_rate_cost", lambda: ES.rate_cost(*seen["rate_cost"][0]),
                 lambda: ES.rate_cost_ref(*rc_ref))):
            got, want = run(), ref()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bits_equal(got, want), f"{key} {name}: kernel and plain "
                  f"version differ (max err {err})")
            check(bool(torch.isfinite(got).all()), f"{key}: non-finite output")
            line = (f"kernel {key} {name} (N={N}, nb={nb}"
                    + (f", Pe={Pe}, K={K}" if key == "enc_rate_cost" else "")
                    + "): bit-equal to the plain version")
            if name == "ENC-512":
                ms = time_ms(torch, run, reps=REPS)
                dms = device_ms(torch, run, f"{key}_kernel")
                plain = plain_ms(ref)
                if key == "enc_spread":
                    # e in, the spread out; per element two maxima, two
                    # products and the smr product
                    moved = 2 * N * nb * 4
                    ops = 5.0 * N * nb
                else:
                    # t34, the row flags, the maps, three band planes, the
                    # tables in, est out; ~12 operations a bin and offset
                    # (product, add, floor, clamp, sign, escape test, pair
                    # index, sums) and 4 a band and offset
                    moved = nbytes(t34, is_short, regions, base, fit_sf,
                                   zero_sf, lut, got) + 4 * (256 + K)
                    ops = 12.0 * N * Pe * K + 4.0 * N * (nb + 1) * K
                b_ms, b_by = bound(moved, ops)
                results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                                    plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
                line += (f"; {ms:.4f} ms per call (device {fmt(dms)}), plain "
                         f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                         f"{moved / 1e6:.1f} MB, {ops / 1e9:.3f} G "
                         "operations); no PyTorch call computes it")
            say(line)


def parse_threads(n_streams: int) -> int:
    """The thread count the native batch parse resolves to for n_streams
    streams, by the rule of native/aacparse.cc (aacparse_batch):
    AACJAX_PARSE_THREADS if set, else min(online cores, n_streams / 4);
    then at most 16 and at most n_streams, at least 1."""
    env = os.environ.get("AACJAX_PARSE_THREADS")
    n = int(env) if env is not None else min(os.cpu_count() or 1,
                                             n_streams // 4)
    return max(1, min(n, 16, n_streams))


# -- phase 3: the serving slice ----------------------------------------------
def stage_split(torch, dec, chunk, out_int16: bool, runs: int = 5):
    """One chunk's stages on decoder `dec`, medians of `runs`: the parse on
    the host clock, H2D / compute / D2H with CUDA events on their streams.
    Returns seconds (parse, h2d, compute, d2h)."""
    splits = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        p0 = time.perf_counter()
        parsed = dec._parse_native(chunk, compact=True)
        parse_s = time.perf_counter() - p0
        ev[0].record(dec._h2d_stream)
        dev = dec._upload_batch(parsed)
        ev[1].record(dec._h2d_stream)
        ev[2].record(dec._compute_stream)
        pcm = dec._device_step(dev, out_int16=out_int16)
        ev[3].record(dec._compute_stream)
        torch.cuda.synchronize()
        ev[4].record(dec._d2h_stream)
        dec.finalize_step(pcm)
        ev[5].record(dec._d2h_stream)
        torch.cuda.synchronize()
        splits.append((parse_s, ev[0].elapsed_time(ev[1]) / 1e3,
                       ev[2].elapsed_time(ev[3]) / 1e3,
                       ev[4].elapsed_time(ev[5]) / 1e3))
    return tuple(float(v) for v in np.median(np.array(splits), axis=0))


KERNELS = ("tail", "synthesis", "tns", "pred", "ps_decorr", "enc_spread",
           "enc_rate_cost")
ENC_KERNELS = ("enc_spread", "enc_rate_cost")


def _kernel_modules() -> dict:
    """Each kernel's launch counter (`.launches`): its wrapper's module, or
    for the encoder's two scans their counters in kernels/enc_scans.py."""
    from aacjax_torch.kernels import enc_scans, pred, ps_decorr, synth, tail, tns
    return dict(tail=tail, synthesis=synth, tns=tns, pred=pred,
                ps_decorr=ps_decorr, enc_spread=enc_scans.spread_count,
                enc_rate_cost=enc_scans.rate_cost_count)


def reset_launches() -> None:
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {k: mod.launches for k, mod in _kernel_modules().items()}


def serving_pass(torch, name: str, config, corpus, windows: int,
                 out_int16: bool, expect: dict, n_streams: int = N_STREAMS,
                 cce_slots: int = 0, max_chunks: int | None = None,
                 facts_set: tuple = (), quote_rtx: bool = False) -> dict:
    """`windows` pipelined runs of n_streams streams (the corpus's payload
    lists in turn) in chunks of CHUNK frames, each with a fresh decoder
    after one warm-up chunk, the launch counts set to 0 just before the runs
    and read just after; then every chunk of every run against the plain
    route (use_pallas=False, a separate decoder on the same chunks, which
    carries its own overlap and predictor state), and one chunk's stage
    split.  `expect` gives the launches per chunk of each kernel ("tns": 1
    stands for one launch per chunk that carries TNS); `facts_set` names
    parse facts that every chunk must have set.  Returns the launch counts
    of the pipelined runs."""
    import aacjax_torch
    from aacjax_torch.testing import assert_pcm_close

    per_stream = [corpus[i % len(corpus)] for i in range(n_streams)]
    n_chunks = min(len(p) for p in per_stream) // CHUNK
    n_chunks = min(n_chunks, max_chunks or n_chunks)
    chunks = [[p[k * CHUNK:(k + 1) * CHUNK] for p in per_stream]
              for k in range(n_chunks)]

    def decoder():
        return aacjax_torch.BatchDecoder([config] * n_streams,
                                         chunk_frames=CHUNK,
                                         cce_slots=cce_slots)

    say(f"{name}: {n_streams} streams "
        f"({n_streams * (config.channels + cce_slots)} channel slots) x "
        f"{n_chunks} chunks of {CHUNK} frames, "
        f"{'int16' if out_int16 else 'f32'} PCM delivered")
    decoder().step_raw(chunks[0], out_int16=out_int16)      # warm-up chunk
    torch.cuda.synchronize()
    reset_launches()
    walls, runs = [], []
    for _ in range(windows):
        dec = decoder()
        t1 = time.perf_counter()
        outs = list(dec.decode_pipelined(iter(chunks), out_int16=out_int16,
                                         compact=True))
        walls.append(time.perf_counter() - t1)
        check(len(outs) == n_chunks, f"{name}: decode_pipelined lost chunks")
        check(not any(st.failed for st in dec.streams),
              f"{name}: a stream failed: "
              f"{[st.last_error for st in dec.streams if st.failed][:1]}")
        runs.append(outs)
    counts = read_launches()
    say(f"{name}: launches {counts} for {windows} x {n_chunks} chunks")

    # every chunk of every stream of every run against the plain route
    ver = decoder()
    worst, n_diff, n_all, ref_max, n_tns, compact = 0.0, 0, 0, 0.0, 0, None
    for k, chunk in enumerate(chunks):
        parsed = ver._parse_native(chunk, compact=True)
        n_tns += bool(parsed["_has_tns"])
        compact = parsed["_spec_i16"]
        for fact in facts_set:
            check(bool(parsed[fact]), f"{name}: chunk {k} has {fact} unset")
        ref = ver.finalize_step(ver._device_step(
            ver._upload_batch(parsed), out_int16, use_pallas=False)).copy()
        ref_max = max(ref_max, float(np.abs(ref).max()))
        for w, outs in enumerate(runs):
            worst = max(worst, assert_pcm_close(outs[k], ref, out_int16,
                                                f"{name} run {w} chunk {k}"))
            n_diff += int((outs[k] != ref).sum())
            n_all += ref.size
    check(not any(st.failed for st in ver.streams), f"{name}: a stream failed "
          "on the plain route")
    for kernel in KERNELS:
        per = n_tns if kernel == "tns" else n_chunks
        want = windows * per * expect.get(kernel, 0)
        check(counts[kernel] == want, f"{name}: {counts[kernel]} {kernel} "
              f"launches, expected {want} ({windows} runs, {n_chunks} chunks, "
              f"{n_tns} of them with TNS)")
    rule = ("within 1 LSB on < 2% of samples" if out_int16
            else "within 5e-5 * max|ref| of each chunk")
    say(f"{name}: all {n_chunks} chunks ({n_tns} with TNS; "
        f"{'compact i16' if compact else 'exact f32'} spectra uploaded) of "
        f"all {n_streams} streams in all {windows} runs match the plain route "
        f"{rule} (max delta {worst}, max|ref| {ref_max}, "
        f"{n_diff / n_all:.6f} of samples differ)")

    parse_s, h2d_s, comp_s, d2h_s = stage_split(
        torch, decoder(), chunks[min(1, n_chunks - 1)], out_int16)
    chunk_audio = n_streams * CHUNK * config.frame_length / config.sample_rate
    audio_s = chunk_audio * n_chunks
    if quote_rtx:
        rtx = [audio_s / w for w in walls]
        say(f"{name}: aggregate_realtime_x {float(np.median(rtx)):.1f} "
            f"(median of {windows} runs of {audio_s:.1f} s of audio; runs "
            f"{[round(x, 1) for x in rtx]}, walls "
            f"{[round(w, 3) for w in walls]} s)")
    say(f"{name}: wall per chunk "
        f"{[round(w / n_chunks, 4) for w in walls]} s; per-chunk stages "
        f"({chunk_audio:.1f} s of audio): parse {parse_s:.4f} s, h2d "
        f"{h2d_s:.4f} s, compute {comp_s:.4f} s, d2h {d2h_s:.4f} s")
    return counts


@functools.lru_cache(maxsize=None)
def lc_corpus():
    """LC-512's corpus (make_corpus(4, 4.0)), made once for the phases that
    decode it."""
    from aacjax_torch.testing import make_corpus
    return make_corpus(4, 4.0)


@functools.lru_cache(maxsize=None)
def he_corpus(ps: bool):
    """HE-512's or PS-512's corpus, made once for the phases that decode
    it."""
    from aacjax_torch.testing import he_serving_corpus, ps_serving_corpus
    return (ps_serving_corpus if ps else he_serving_corpus)(4, 4.0, HE_CHUNK)


@functools.lru_cache(maxsize=None)
def main_corpus():
    """Main-512's corpus (main_serving_corpus(4, 48)), made once."""
    from aacjax_torch.testing import main_serving_corpus
    return main_serving_corpus(4, 48)


def phase_slice(torch) -> dict:
    """The LC-512 pass: the reference's headline corpus (no TNS, long
    windows), int16 PCM."""
    from aacjax_torch.testing import adts_payloads
    t0 = time.perf_counter()
    config, streams = lc_corpus()
    say(f"slice: corpus of 4 unique streams x 4 s encoded in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"slice: host has {os.cpu_count()} online cores, "
        f"AACJAX_PARSE_THREADS={os.environ.get('AACJAX_PARSE_THREADS')}, "
        f"the native parse uses {parse_threads(N_STREAMS)} threads")
    return serving_pass(torch, "slice", config,
                        [adts_payloads(d) for d in streams], WINDOWS,
                        out_int16=True, expect=dict(tail=1), quote_rtx=True)


def phase_slice_tns(torch) -> dict:
    """The LC-512-tns pass: the same width over random legal frames that
    carry TNS (and M/S and short windows), so that every chunk takes the
    TNS kernel and then the tail kernel on f32 spectra.  f32 PCM: the
    corpus's noise has gains up to 2^20, most of its samples saturate
    int16, and the 1-LSB rule would then test the corpus, not the
    kernels."""
    from aacjax_torch.testing import adts_payloads, tns_serving_corpus
    t0 = time.perf_counter()
    config, streams = tns_serving_corpus()
    say(f"slice-tns: corpus of {len(streams)} unique streams of random "
        f"frames written in {time.perf_counter() - t0:.1f} s")
    return serving_pass(torch, "slice-tns", config,
                        [adts_payloads(d) for d in streams], TNS_WINDOWS,
                        out_int16=False, expect=dict(tail=1, tns=1),
                        facts_set=("_has_tns",))


def phase_slice_main(torch) -> dict:
    """The Main-512 pass: 512 Main-profile stereo streams of random legal
    frames (prediction_used bits, reset groups, runs of EIGHT_SHORT, M/S,
    TNS on part of the frames, no intensity, which would be delegated).
    Prediction keeps a chunk off the fused tail: per chunk the predictor
    kernel, the TNS kernel, the synthesis kernel at B = C*T = 16384 and the
    plain overlap-add.  Exact f32 spectra travel (the predictor is sensitive
    to the last bit); f32 PCM for the reason given for LC-512-tns."""
    t0 = time.perf_counter()
    config, corpus = main_corpus()
    say(f"slice-main: corpus of {len(corpus)} unique Main-profile streams "
        f"of random frames written in {time.perf_counter() - t0:.1f} s")
    return serving_pass(torch, "slice-main", config, corpus, MAIN_WINDOWS,
                        out_int16=False,
                        expect=dict(pred=1, synthesis=1, tns=1),
                        facts_set=("_has_pred",))


def phase_slice_mc(torch) -> dict:
    """The MC-128-cce pass: 128 5.1 streams with two coupling slots each
    (C = 128 * 8 = 1024), every frame with a dependent AFTER_TNS coupling
    element onto a CPE that carries TNS (device entries after the TNS
    kernel) and an independent one (coupled on the PCM through its own
    slot's filterbank).  The coupling lists keep a chunk off the fused
    tail."""
    from aacjax_torch.testing import (multichannel_config,
                                      multichannel_payloads)
    t0 = time.perf_counter()
    corpus = [multichannel_payloads(6, 2 * CHUNK, seed=i, coupling=True)
              for i in range(4)]
    say(f"slice-mc: corpus of {len(corpus)} unique 5.1 streams with coupling "
        f"written in {time.perf_counter() - t0:.1f} s")
    return serving_pass(torch, "slice-mc", multichannel_config(6), corpus, 1,
                        out_int16=False, expect=dict(synthesis=1, tns=1),
                        n_streams=128, cce_slots=2,
                        facts_set=("_has_tns", "_has_cce_post",
                                   "_has_cce_time"))


# -- phase 4: decode_adts ----------------------------------------------------
def phase_decode_adts(torch) -> dict:
    import aacjax_torch
    from aacjax_torch.kernels import synth
    from aacjax_torch.testing import (assert_pcm_close, encode_adts,
                                      tns_short_adts, tone_pcm)

    data = tns_short_adts(12, seed=0)
    reset_launches()
    out, rate = aacjax_torch.decode_adts(data)
    counts = read_launches()
    say(f"decode_adts: TNS + short-window stream, launches {counts}")
    check(counts["synthesis"] > 0 and counts["tns"] > 0,
          "decode_adts did not run the synthesis and TNS kernels")
    ref, _ = aacjax_torch.decode_adts(data, device="cpu")
    err = assert_pcm_close(out, ref, False, "decode_adts vs plain route")
    say(f"decode_adts: {out.shape} at {rate} Hz matches the plain route on "
        f"the CPU (max err {err})")

    n = 1024 * 10
    mono = encode_adts(tone_pcm(n)[:, :1], target_sf=120)
    before = synth.launches
    out, _ = aacjax_torch.decode_adts(mono, chunk_frames=5)
    check(synth.launches > before,
          "decode_adts did not run the synthesis kernel at C*T = 15")
    ref, _ = aacjax_torch.decode_adts(mono, chunk_frames=5, device="cpu")
    err = assert_pcm_close(out, ref, False, "mono decode_adts vs plain route")
    say(f"decode_adts: mono in chunks of 5 frames (C*T = 15), synthesis "
        f"launches {synth.launches - before}, matches the plain route on the "
        f"CPU (max err {err})")

    pcm = tone_pcm(n)
    dec, _ = aacjax_torch.decode_adts(encode_adts(pcm, target_sf=120))
    got = dec[1024:1024 + n] * 32768.0       # undo the encoder's delay
    lo, hi = 2048, n - 2048
    err = got[lo:hi] - pcm[lo:hi]
    snr = 10 * np.log10(np.sum(pcm[lo:hi] ** 2) / np.sum(err ** 2))
    say(f"decode_adts: round-trip SNR {snr:.2f} dB")
    check(bool(np.isfinite(dec).all()) and snr > 60.0, "round-trip SNR <= 60 dB")
    phase_routes()
    return read_launches()


def phase_routes() -> None:
    """The routes beyond LC, small: each call on the card against the same
    call on the CPU (f32 PCM within 5e-5 * max|ref|; LTP, which runs on the
    host either way, exactly)."""
    import aacjax_torch
    from aacjax_torch import testing as TI
    from aacjax_torch.host.asc import make_asc
    from aacjax_torch.kernels import pred, synth, tns

    def both(what, fn, *args, **kw):
        got, rate = fn(*args, **kw)
        want, want_rate = fn(*args, device="cpu", **kw)
        check(rate == want_rate and got.shape == want.shape,
              f"{what}: {got.shape} at {rate} Hz against {want.shape} at "
              f"{want_rate} Hz on the CPU")
        err = TI.assert_pcm_close(got, want, False, what)
        say(f"routes: {what}: {got.shape} at {rate} Hz matches the CPU route "
            f"(max err {err}, max|ref| {float(np.abs(want).max()):.4g})")
        return got, want

    before = (pred.launches, tns.launches, synth.launches)
    both("Main + intensity (delegated to the python packer)",
         aacjax_torch.decode_adts, TI.main_stereo_adts(12, 3, intensity=True),
         chunk_frames=8)
    check(pred.launches > before[0] and tns.launches > before[1]
          and synth.launches > before[2],
          "decode_step on the card did not launch the predictor, TNS and "
          "synthesis kernels")
    both("Main, chunks of 5 frames", aacjax_torch.decode_adts,
         TI.main_stereo_adts(12, 1), chunk_frames=5)
    for profile, frame_length, label in ((39, 512, "ELD-512"),
                                         (23, 480, "LD-480")):
        cfg = TI.er_config(profile, frame_length, 2)
        loas = TI.enc.loas_stream(TI.er_payloads(cfg, 9, seed=frame_length),
                                  cfg)
        both(f"{label} through decode_loas", aacjax_torch.decode_loas, loas,
             chunk_frames=4)
    both("three raw_data_blocks per ADTS frame, with crc_check",
         aacjax_torch.decode_adts, TI.multi_rdb_adts(9, crc=True))
    both("5.1 with coupling", aacjax_torch.decode_adts,
         b"".join(TI.enc.adts_frame(p, TI.multichannel_config(6)) for p in
                  TI.multichannel_payloads(6, 6, 9, coupling=True)))

    def stream_960(device="cuda"):
        cfg = TI.er_config(2, 960, 2)
        t = np.arange(960 * 6) / 44100
        x = 8000 * np.sin(2 * np.pi * 700 * t)
        payloads = TI.enc.encode_pcm_frames(
            np.stack([x, 0.7 * np.roll(x, 31)], axis=1), cfg, target_sf=120)
        dec = aacjax_torch.AACDecoder(
            cookie=make_asc(2, 4, 2, frame_length=960), device=device)
        dec.feed(b"".join(payloads))
        chunks = []
        while (c := dec.read_chunk()) is not None:
            chunks.append(c.reshape(-1, 2))
        return np.concatenate(chunks), dec.output_sample_rate

    both("960-sample frames through AACDecoder", stream_960)
    ltp = TI.ltp_adts(8, seed=5, tns=True)
    got, _ = aacjax_torch.decode_adts(ltp)
    want, _ = aacjax_torch.decode_adts(ltp, device="cpu")
    check(bool(np.array_equal(got, want)) and float(np.abs(got).max()) > 0,
          "LTP: the two calls differ")
    say(f"routes: AAC-LTP (the host's float64 decoder): {got.shape} equal")


# -- HE-AAC v1 ---------------------------------------------------------------
HE_CHUNK = 8         # frames a chunk on the HE path (bench_he's HE-512)
HE_WINDOWS = 2       # pipelined runs of the HE-512 pass
HE_MAX_CHUNKS = 4    # chunks a run
# f32 tolerances of the HE checks, relative to max(1, max|ref|): the SBR
# program and QMF banks against the same calls on the CPU on the same
# inputs (the envelope gains divide by the patched bands' energies, so
# reordered sums grow there); and whole HE decodes on the card against the
# CPU, whose cores differ by the kernels' FFT IMDCT against the plain
# versions' dense product (agreeing to 5e-5 * max(1, max|ref|) in the PCM,
# far less in practice), a difference the same division amplifies
HE_TOL = 2e-4
HE_ROUTE_TOL = 1e-3
# HE int16 PCM through the kernel route's core (the tail kernel, FFT IMDCT)
# against the plain route's (the dense IMDCT), both through the same SBR
# (and PS) program.  The cores differ by float rounding (~5e-7 of full
# scale); the SBR program amplifies that in the first two frames of a
# stream, where the covariance LPC of the patch source bands is solved over
# a window that still holds the zeroed start-up history and the quiet
# onset: a near-singular 2x2 system.  tests/test_torch_he_bound.py measures
# it on the CPU over 2 stereo streams x 4 frames of HE-512's traffic, with
# the port's numpy model of the kernel's FFT against its dense IMDCT: frames
# 0-1 differ by 4 LSB on 12.0% of their samples (low-passed as bench_he
# builds it) and 5 LSB on 16.8% (the same noise unfiltered), frames 2-3 by
# 1 LSB on 0.15% and 0.23%; the reference's SBR program fed the same two
# cores gives 4 LSB on 12.1% / 1 on 0.18% and 5 on 16.8% / 1 on 0.21%, so
# the growth is the SBR math's, in both packages (the two SBR programs on
# one core agree within 1 LSB on <= 0.15%).  Hence the bound per frame of a
# stream: frames 0 and 1 within HE_I16_ONSET (max LSB, share of their
# samples; 8 and 0.40 leave a margin over the measured 5 and 0.168), later
# frames the North-star rule HE_I16_STEADY.
HE_ONSET_FRAMES = 2
HE_I16_ONSET = (8, 0.40)
HE_I16_STEADY = (1, 0.02)


def he_i16_stats(pairs) -> dict:
    """HE int16 PCM of one route against another's: `pairs` holds (got,
    want, first) per chunk, [C, T, 2F] int16 arrays whose frame t is frame
    first + t of its stream.  Returns, for the onset frames and the later
    ones, (max delta in LSB, share of samples that differ, samples)."""
    stats = {}
    for part in ("onset", "steady"):
        d_max, n_diff, n_all = 0, 0, 0
        for got, want, first in pairs:
            t = first + np.arange(got.shape[1])
            sel = (t < HE_ONSET_FRAMES) == (part == "onset")
            if not sel.any():
                continue
            d = np.abs(got[:, sel].astype(np.int32)
                       - want[:, sel].astype(np.int32))
            d_max = max(d_max, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.size
        stats[part] = (d_max, n_diff / max(n_all, 1), n_all)
    return stats


def he_i16_check(pairs, what: str) -> dict:
    """he_i16_stats, held to HE_I16_ONSET and HE_I16_STEADY."""
    stats = he_i16_stats(pairs)
    for part, (limit, share_max) in (("onset", HE_I16_ONSET),
                                     ("steady", HE_I16_STEADY)):
        d_max, share, _ = stats[part]
        check(d_max <= limit and share < share_max,
              f"{what}: {part} frames differ by up to {d_max} LSB on "
              f"{share:.5f} of samples, bound {limit} LSB on < {share_max}")
    return stats


def he_close(got, want, what: str, tol: float = HE_TOL) -> float:
    """HE f32 output (PCM or state) against its reference within
    tol * max(1, max|ref|).  Returns the error relative to max(1, max|ref|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} against "
          f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite output")
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    check(err <= tol, f"{what}: max err {err} * max(1, max|ref|) > {tol}")
    return err


def dev_time(e) -> float:
    return getattr(e, "device_time_total", 0.0) or 0.0


def phase_he_checks(torch, dev) -> None:
    """The QMF banks at B = 1024, S = 256 and one sbr_apply at the HE-512
    chunk's shape (512 stereo streams, C = 1024, T = 8, compact planes),
    f32 and int16, on the card against the same calls on the CPU; then the
    sbr_apply's time and the ten device ops of it that take the most time
    (torch.profiler)."""
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import qmf
    from aacjax_torch.kernels import sbr_batch as SB
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1024, 32 * 256)).astype(
        np.float32) * 3000)
    h = torch.from_numpy(rng.standard_normal((1024, 288)).astype(
        np.float32) * 3000)
    errs = [he_close(g.cpu(), w, f"qmf.analysis {name}") for name, g, w in
            zip(("re", "im", "history"), qmf.analysis(x.to(dev), h.to(dev)),
                qmf.analysis(x, h))]
    xr, xi = (torch.from_numpy(rng.standard_normal((1024, 256, 64)).astype(
        np.float32) * 300) for _ in range(2))
    vh = torch.from_numpy(rng.standard_normal((1024, 9, 128)).astype(
        np.float32) * 30)
    errs += [he_close(g.cpu(), w, f"qmf.synthesis {name}") for name, g, w in
             zip(("pcm", "history"),
                 qmf.synthesis(xr.to(dev), xi.to(dev), vh.to(dev)),
                 qmf.synthesis(xr, xi, vh))]
    say(f"he: qmf.analysis and qmf.synthesis at B=1024, S=256 match the CPU "
        f"(max err {max(errs):.4g} * max(1, max|ref|))")

    t0 = time.perf_counter()
    core, planes, cfg, state = TI.sbr_apply_inputs(N_STREAMS, HE_CHUNK, dev,
                                                   compact=True)
    say(f"he: sbr_apply inputs of one HE-512 chunk made in "
        f"{time.perf_counter() - t0:.1f} s")

    def cpu(d):
        return {k: v.cpu() for k, v in d.items()}
    for out_int16 in (False, True):
        got, got_state = SB.sbr_apply(core, planes, state, cfg, out_int16)
        want, want_state = SB.sbr_apply(core.cpu(), cpu(planes), cpu(state),
                                        cpu(cfg), out_int16)
        if out_int16:
            from aacjax_torch.testing import assert_pcm_close
            err = assert_pcm_close(got.cpu(), want, True, "sbr_apply int16")
            share = float((got.cpu() != want).float().mean())
            what = f"int16 within 1 LSB ({share:.5f} of samples differ)"
        else:
            err = he_close(got.cpu(), want, "sbr_apply f32")
            what = f"f32 max err {err:.4g} * max(1, max|ref|) (max|ref| " \
                   f"{float(want.abs().max()):.4g})"
        serr = max(he_close(got_state[k].cpu(), want_state[k],
                            f"sbr_apply state {k}") for k in want_state)
        say(f"he: sbr_apply C=1024 T=8 on the card matches the CPU: {what}; "
            f"state max err {serr:.4g} * max(1, max|ref|)")

    top_device_ops(torch, "he", "sbr_apply C=1024 T=8 (int16 out)",
                   lambda: SB.sbr_apply(core, planes, state, cfg, True))


def top_device_ops(torch, name: str, what: str, run, top: int = 10) -> None:
    """`run`'s time per call (CUDA events, median of 10), peak memory, and
    the device time and the `top` costliest device ops of one call in a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    ms = time_ms(torch, run, runs=10)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = list(prof.key_averages())
    total = sum(dev_time(e) for e in evs)
    say(f"{name}: {what}: {ms:.4f} ms per call (CUDA events, median of 10), "
        f"device time in the trace {total / 1e3:.4f} ms over "
        f"{sum(e.count for e in evs)} kernels, peak memory {peak:.2f} GiB; "
        f"top {top} device ops:")
    for e in sorted(evs, key=dev_time, reverse=True)[:top]:
        t = dev_time(e)
        say(f"{name}:   {t / 1e3:8.4f} ms {100 * t / max(total, 1e-9):5.1f}% "
            f"x{e.count:<3d} {e.key[:100]}")


def phase_ps_checks(torch, dev) -> None:
    """One sbr_ps_apply at the PS-512 chunk's shape (512 mono streams with
    their pairs, C = 1024, T = 8, compact SBR planes, 20-band PS), f32 and
    int16, on the card against the same call on the CPU, its PCM and both
    states; then its time, peak memory and costliest device ops."""
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import ps_batch as PB
    t0 = time.perf_counter()
    core, planes, ps, cfg, state, ps_state = TI.sbr_ps_apply_inputs(
        N_STREAMS, HE_CHUNK, dev)
    say(f"ps: sbr_ps_apply inputs of one PS-512 chunk made in "
        f"{time.perf_counter() - t0:.1f} s")

    def cpu(d):
        return {k: v.cpu() for k, v in d.items()}
    for out_int16 in (False, True):
        got = PB.sbr_ps_apply(core, planes, ps, state, ps_state, cfg,
                              out_int16)
        want = PB.sbr_ps_apply(core.cpu(), cpu(planes), cpu(ps), cpu(state),
                               cpu(ps_state), cpu(cfg), out_int16)
        if out_int16:
            from aacjax_torch.testing import assert_pcm_close
            assert_pcm_close(got[0].cpu(), want[0], True, "sbr_ps_apply int16")
            share = float((got[0].cpu() != want[0]).float().mean())
            what = f"int16 within 1 LSB ({share:.5f} of samples differ)"
        else:
            err = he_close(got[0].cpu(), want[0], "sbr_ps_apply f32")
            what = (f"f32 max err {err:.4g} * max(1, max|ref|) (max|ref| "
                    f"{float(want[0].abs().max()):.4g})")
        serr = max(he_close(g[k].cpu(), w[k], f"sbr_ps_apply state {k}")
                   for g, w in zip(got[1:], want[1:]) for k in w)
        say(f"ps: sbr_ps_apply C=1024 T=8 on the card matches the CPU: "
            f"{what}; SBR and PS state max err {serr:.4g} * max(1, max|ref|)")
    top_device_ops(torch, "ps-512", "sbr_ps_apply C=1024 T=8 (int16 out)",
                   lambda: PB.sbr_ps_apply(core, planes, ps, state, ps_state,
                                           cfg, True))


def he_stage_split(torch, dec, chunk, runs: int = 3):
    """One HE chunk's stages on `dec`, medians of `runs`: the host phase
    (native core parse, SBR and PS parse and pack, plane compaction) on the
    host clock; the copies to the device of the core, the SBR planes and
    the PS planes (0 without PS), the core step, the SBR (+ PS) step and the
    copy back with CUDA events on their streams.  Returns seconds (host,
    h2d core, h2d SBR planes, h2d PS planes, core, SBR (+ PS), d2h)."""
    splits = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(12)]
        p0 = time.perf_counter()
        parsed, dense, ctx = dec._he_host_phase(chunk, True)
        parse_s = time.perf_counter() - p0
        home, rows = dec._home, ((0, dec.C),)
        ev[0].record(dec._h2d_stream)
        up = dec._upload_batch(parsed)
        ev[1].record(dec._h2d_stream)
        ev[2].record(dec._h2d_stream)
        dev_dense = dec._upload_tree(dense, home, rows, dec._sbr_h2d_done,
                                     ctx["slot"])
        ev[3].record(dec._h2d_stream)
        ev[4].record(dec._h2d_stream)
        ps_dense = (dec._upload_tree(ctx["ps_planes"], home, rows,
                                     dec._ps_h2d_done, ctx["slot"])
                    if ctx["ps_enabled"] else None)
        ev[5].record(dec._h2d_stream)
        ev[6].record(dec._compute_stream)
        core = dec._device_step(up, out_int16=False)
        ev[7].record(dec._compute_stream)
        pcm2, seeds = dec._sbr_dispatch(core, dev_dense, ps_dense, ctx, True,
                                        home)
        ev[8].record(dec._compute_stream)
        torch.cuda.synchronize()
        ev[9].record(dec._d2h_stream)
        dec._sbr_download(pcm2, seeds, ctx, core)
        ev[10].record(dec._d2h_stream)
        torch.cuda.synchronize()
        splits.append((parse_s, *(ev[a].elapsed_time(ev[b]) / 1e3 for a, b in
                                  ((0, 1), (2, 3), (4, 5), (6, 7), (7, 8),
                                   (9, 10)))))
    return tuple(float(v) for v in np.median(np.array(splits), axis=0))


def he_host_profile(name: str, dec, chunk, top: int = 8) -> None:
    """Where one host phase spends its time: cProfile's functions with the
    most own time over one call (after one unprofiled call; the profiler's
    own cost inflates the many small Python calls, so the shares are
    indicative)."""
    import cProfile
    import pstats
    dec._he_host_phase(chunk, True)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    dec._he_host_phase(chunk, True, buf_slot=1)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
    say(f"{name}: host phase under cProfile {wall:.3f} s; own time by "
        "function:")
    for (path, line, fn), (_, ncalls, tottime, cumtime, _) in rows[:top]:
        say(f"{name}:   {tottime:7.3f} s own, {cumtime:7.3f} s cum, "
            f"x{ncalls:<6d} {pathlib.Path(path).name}:{line} {fn}")


def he_serving(torch, name: str, config, corpus, ps: bool) -> dict:
    """One HE serving cell: N_STREAMS streams (the corpus's payload lists in
    turn) in chunks of HE_CHUNK frames through decode_he_pipelined with
    int16 PCM after one warm-up chunk, HE_WINDOWS runs of HE_MAX_CHUNKS
    chunks, each with a fresh decoder; launch counts set to 0 just before
    the runs and read just after, peak device memory over the runs.  Then
    every chunk again on two decoders fed one host phase: the kernel route
    (must give the pipelined runs' PCM within 1 LSB) and the plain core
    route (its int16 PCM held to the HE bound, he_i16_check); then one
    chunk's stage split and a profile of one host phase.  With `ps`, mono
    HE-AAC v2 streams with a spare slot each (cce_slots=1)."""
    import aacjax_torch
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.testing import assert_pcm_close
    per_stream = [corpus[i % len(corpus)] for i in range(N_STREAMS)]
    n_chunks = min(len(corpus[0]) // HE_CHUNK, HE_MAX_CHUNKS)
    chunks = [[p[k * HE_CHUNK:(k + 1) * HE_CHUNK] for p in per_stream]
              for k in range(n_chunks)]

    def decoder():
        return aacjax_torch.BatchDecoder([config] * N_STREAMS,
                                         chunk_frames=HE_CHUNK,
                                         cce_slots=1 if ps else 0)
    decoder().step_he_raw(chunks[0], out_int16=True)       # warm-up chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, runs = [], []
    for _ in range(HE_WINDOWS):
        dec = decoder()
        t1 = time.perf_counter()
        outs = list(dec.decode_he_pipelined(iter(chunks), out_int16=True))
        walls.append(time.perf_counter() - t1)
        check(len(outs) == n_chunks, f"{name}: decode_he_pipelined lost "
              "chunks")
        check(all(o.dtype == np.int16 for o in outs), f"{name}: not int16")
        check(not any(st.failed for st in dec.streams),
              f"{name}: a stream failed: "
              f"{[st.last_error for st in dec.streams if st.failed][:1]}")
        check(not any(dec._sbr_np_sticky), f"{name}: a slot went sticky")
        if ps:
            check(dec._ps_pair[::2] == list(range(1, 2 * N_STREAMS, 2)),
                  f"{name}: the PS pairs are not the spare slots")
        runs.append(outs)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30

    ver, plain = decoder(), decoder()
    plain._sbr_init()
    worst, core_err, n_diff, n_all, n_tns, pairs = 0.0, 0.0, 0, 0, 0, []
    for k, chunk in enumerate(chunks):
        parsed, dense, ctx = ver._he_host_phase(chunk, True)
        check(bool(parsed["_spec_qsf"]), f"{name}: chunk {k} did not send "
              "the q/sf spectra")
        n_tns += bool(parsed["_has_tns"])
        core_k = ver._device_step(ver._upload_batch(dict(parsed)),
                                  out_int16=False)
        core_p = plain._device_step(plain._upload_batch(dict(parsed)),
                                    out_int16=False, use_pallas=False)
        torch.cuda.synchronize()
        core_err = max(core_err, assert_pcm_close(
            *(meshlib.gather(c, "cpu").numpy() for c in (core_k, core_p)),
            False, f"{name} core chunk {k}"))
        out_k = ver._sbr_stage(core_k, dense, ctx, out_int16=True).copy()
        out_p = plain._sbr_stage(core_p, dense, ctx, out_int16=True).copy()
        torch.cuda.synchronize()
        for w, outs in enumerate(runs):
            worst = max(worst, assert_pcm_close(outs[k], out_k, True,
                                                f"{name} run {w} chunk {k}"))
            n_diff += int((outs[k] != out_k).sum())
            n_all += out_k.size
        pairs.append((out_k, out_p, k * HE_CHUNK))
    stats = he_i16_check(pairs, f"{name}: kernel route against the plain "
                         "core route")
    expect = {"tail": HE_WINDOWS * n_chunks, "tns": HE_WINDOWS * n_tns,
              "ps_decorr": HE_WINDOWS * n_chunks if ps else 0}
    for kernel, want in expect.items():
        check(counts[kernel] == want, f"{name}: {counts[kernel]} {kernel} "
              f"launches, expected {want}")
    say(f"{name}: launches {counts} for {HE_WINDOWS} x {n_chunks} chunks "
        f"({n_tns} with TNS); peak device memory {peak:.2f} GiB")
    say(f"{name}: all {n_chunks} chunks of all {N_STREAMS} streams in all "
        f"{HE_WINDOWS} runs equal the same route's step within 1 LSB on < 2% "
        f"of samples (max delta {worst}, {n_diff / n_all:.6f} of samples "
        f"differ); q/sf spectra and compact SBR planes uploaded; the core "
        f"(tail kernel, f32) matches the plain core route within 5e-5 * "
        f"max(1, max|ref|) (max delta {core_err:.4g}); the int16 PCM of the "
        f"plain core route differs by up to {stats['onset'][0]} LSB on "
        f"{stats['onset'][1]:.5f} of the samples of frames 0-1 (bound "
        f"{HE_I16_ONSET}) and by up to {stats['steady'][0]} LSB on "
        f"{stats['steady'][1]:.6f} of the later frames' (bound "
        f"{HE_I16_STEADY})")
    audio_s = N_STREAMS * n_chunks * HE_CHUNK * 2048 / 44100.0
    rtx = [audio_s / w for w in walls]
    metric = ("he_aac_v2_aggregate_realtime_x" if ps
              else "he_aac_aggregate_realtime_x")
    say(f"{name}: {metric} {float(np.median(rtx)):.1f} (median of "
        f"{HE_WINDOWS} runs of {audio_s:.1f} s of audio at 44.1 kHz; runs "
        f"{[round(x, 1) for x in rtx]}, walls {[round(w, 3) for w in walls]} "
        "s)")
    stages = he_stage_split(torch, decoder(), chunks[min(1, n_chunks - 1)])
    he_host_profile(name, decoder(), chunks[0])
    say(f"{name}: wall per chunk {[round(w / n_chunks, 4) for w in walls]} s; "
        f"per-chunk stages ({audio_s / n_chunks:.1f} s of audio): host phase "
        "(core parse, SBR / PS parse and pack, compaction) {:.4f} s, h2d "
        "core {:.4f} s, h2d SBR planes {:.4f} s, h2d PS planes {:.4f} s, core "
        "compute {:.4f} s, SBR{} compute {:.4f} s, d2h {:.4f} s".format(
            *stages[:5], " + PS" if ps else "", *stages[5:]))
    return counts


def phase_he_serving(torch) -> dict:
    """HE-512: 512 HE-AAC v1 stereo streams (C = 1024 slots; 22.05 kHz core,
    44.1 kHz out) from he_serving_corpus(4, 4.0, 8), bench_he's
    construction (he_serving)."""
    t0 = time.perf_counter()
    config, corpus = he_corpus(False)
    say(f"he-512: corpus of {len(corpus)} unique HE-AAC v1 stereo streams x "
        f"{len(corpus[0])} frames encoded in {time.perf_counter() - t0:.1f} s")
    return he_serving(torch, "he-512", config, corpus, ps=False)


def phase_ps_serving(torch) -> dict:
    """PS-512: 512 HE-AAC v2 mono streams from ps_serving_corpus(4, 4.0, 8),
    bench_he(ps=True)'s construction, decoded as stereo with a spare slot
    each (cce_slots=1: C = 1024 slots, 512 sources and 512 pairs): one tail
    and one decorrelator launch a chunk (he_serving)."""
    t0 = time.perf_counter()
    config, corpus = he_corpus(True)
    say(f"ps-512: corpus of {len(corpus)} unique HE-AAC v2 mono streams x "
        f"{len(corpus[0])} frames encoded in {time.perf_counter() - t0:.1f} s")
    return he_serving(torch, "ps-512", config, corpus, ps=True)


def phase_he_routes(torch) -> dict:
    """HE-AAC v1 beyond the serving pass, each on the card against the same
    call on the CPU: decode_adts on a stream whose core carries TNS, the
    streaming AACDecoder, and step_he_raw over a mid-chunk SBR header
    change (the slot replays that chunk on the float64 path and re-adopts
    at the next boundary)."""
    import aacjax_torch
    from aacjax_torch import testing as TI
    from aacjax_torch.host import sbr as S
    stream = TI.he_stream(8, ch=2, tns=True)
    reset_launches()
    got, rate = aacjax_torch.decode_adts(stream, chunk_frames=4)
    counts = read_launches()
    check(counts["tns"] > 0, "he decode_adts did not run the TNS kernel")
    want, _ = aacjax_torch.decode_adts(stream, chunk_frames=4, device="cpu")
    err = he_close(got, want, "he decode_adts", HE_ROUTE_TOL)
    say(f"he routes: decode_adts, core with TNS: {got.shape} at {rate} Hz, "
        f"launches {counts}, matches the CPU (max err {err:.4g} * max(1, "
        f"max|ref|))")

    def streaming(device):
        d = aacjax_torch.AACDecoder(device=device)
        d.feed(TI.he_stream(5, ch=1))
        out = []
        while (c := d.read_chunk()) is not None:
            out.append(c)
        return np.concatenate(out), d.output_sample_rate
    (a, ra), (b, rb) = streaming("cuda"), streaming("cpu")
    check(ra == rb == 44100, "he AACDecoder: output rate")
    err = he_close(a, b, "he AACDecoder", HE_ROUTE_TOL)
    say(f"he routes: AACDecoder {a.shape} at {ra} Hz matches the CPU (max "
        f"err {err:.4g} * max(1, max|ref|))")

    h2 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0,
                     limiter_gains=1)
    payloads = TI.adts_payloads(TI.he_stream(8, ch=1, header_at={4: h2}))
    config = TI.parse_asc(TI.adts.synthesize_cookie(
        TI.adts.split_frames(TI.he_stream(1, ch=1))[0][0]))
    decs = [aacjax_torch.BatchDecoder([config], chunk_frames=3, device=d)
            for d in ("cuda", "cpu")]
    errs = []
    for k in range(3):
        outs = [d.step_he_raw([payloads[3 * k:3 * k + 3]]) for d in decs]
        check([d._sbr_np_sticky[0] for d in decs] == [k == 1] * 2,
              f"he header change: chunk {k} sticky "
              f"{[d._sbr_np_sticky[0] for d in decs]}")
        errs.append(he_close(outs[0], outs[1], f"he header change {k}",
                             HE_ROUTE_TOL))
    check(decs[0]._slot_sbr_hdr[0] == h2, "he header change: row not h2")
    say(f"he routes: step_he_raw over a mid-chunk header change (sticky in "
        f"chunk 1 only, re-adopted) matches the CPU (max err "
        f"{max(errs):.4g} * max(1, max|ref|))")
    return counts


def phase_ps_routes(torch) -> dict:
    """HE-AAC v2 beyond the serving pass, each on the card against the same
    call on the CPU (f32 within HE_ROUTE_TOL): decode_adts on a 20-band and
    a 34-band stream with IPD/OPD, a mixed 20/34 batch through the dual
    program, a band-scheme flip (sticky for one chunk, re-adopted), the
    streaming AACDecoder, and save_state / restore_state mid-stream."""
    import aacjax_torch
    from aacjax_torch import testing as TI
    specs = TI.ps_specs()
    reset_launches()
    for name in ("20-band", "34-band"):
        stream = TI.ps_stream(specs[name])
        got, rate = aacjax_torch.decode_adts(stream, chunk_frames=4)
        want, _ = aacjax_torch.decode_adts(stream, chunk_frames=4,
                                           device="cpu")
        check(rate == 44100 and got.shape[1] == 2, f"ps decode_adts {name}: "
              f"{got.shape} at {rate} Hz")
        err = he_close(got, want, f"ps decode_adts {name}", HE_ROUTE_TOL)
        say(f"ps routes: decode_adts {name} with IPD/OPD: {got.shape} at "
            f"{rate} Hz matches the CPU (max err {err:.4g} * max(1, "
            "max|ref|))")

    def batch(streams, chunk, device, hook=None):
        pays = [TI.adts_payloads(st) for st in streams]
        cfg = TI.parse_asc(TI.adts.synthesize_cookie(
            TI.adts.split_frames(streams[0])[0][0]))
        d = aacjax_torch.BatchDecoder([cfg] * len(streams),
                                      chunk_frames=chunk, cce_slots=1,
                                      device=device)
        outs = []
        for k in range(min(len(p) for p in pays) // chunk):
            outs.append(d.step_he_raw([p[k * chunk:(k + 1) * chunk]
                                       for p in pays]))
            if hook:
                hook(d)
        return np.concatenate(outs, axis=1), d

    mixed = [TI.ps_stream(specs["20-band 2 env"], 6, 1),
             TI.ps_stream(specs["34-band 2 env"], 6, 2)]
    got, d = batch(mixed, 3, "cuda")
    check(not any(d._sbr_np_sticky) and d._ps_slot_is34[:3:2] == [False, True],
          "ps mixed batch: a slot went sticky, or the modes are wrong")
    err = he_close(got, batch(mixed, 3, "cpu")[0], "ps mixed 20/34",
                   HE_ROUTE_TOL)
    say(f"ps routes: a 20-band and a 34-band stream in one batch (the dual "
        f"program, no slot sticky) match the CPU (max err {err:.4g})")
    sticky = []
    flip = [TI.ps_flip_stream([2] * 4 + [1] * 4)]
    got, d = batch(flip, 2, "cuda", lambda d: sticky.append(
        d._sbr_np_sticky[0]))
    check(sticky == [False, False, True, False] and d._ps_slot_is34[0] is
          False, f"ps flip: sticky per chunk {sticky}")
    err = he_close(got, batch(flip, 2, "cpu")[0], "ps flip", HE_ROUTE_TOL)
    say(f"ps routes: a 34 -> 20-band flip (sticky in chunk 2 only, "
        f"re-adopted into the 20-band state) matches the CPU (max err "
        f"{err:.4g})")

    stream = TI.ps_stream(specs["20-band"], 6, 3)

    def streaming(device):
        d = aacjax_torch.AACDecoder(device=device)
        d.feed(stream)
        out = []
        while (c := d.read_chunk()) is not None:
            out.append(c.reshape(-1, d.output_channels))
        return np.concatenate(out)
    got = streaming("cuda")
    err = he_close(got, streaming("cpu"), "ps AACDecoder", HE_ROUTE_TOL)
    say(f"ps routes: AACDecoder {got.shape} matches the CPU (max err "
        f"{err:.4g})")
    pays = TI.adts_payloads(stream)
    cfg = TI.parse_asc(TI.adts.synthesize_cookie(
        TI.adts.split_frames(stream)[0][0]))
    outs = {}
    for device in ("cuda", "cpu"):
        d = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                      device=device)
        d.step_he_raw([pays[:3]])
        d2 = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                       device=device)
        d2.restore_state(d.save_state())
        outs[device] = d2.step_he_raw([pays[3:6]])
        check(np.array_equal(outs[device], d.step_he_raw([pays[3:6]])),
              f"ps save/restore on {device}: the restored decoder differs")
    err = he_close(outs["cuda"], outs["cpu"], "ps after restore",
                   HE_ROUTE_TOL)
    say(f"ps routes: save_state / restore_state mid-stream resumes equal to "
        f"the original, on the card matching the CPU (max err {err:.4g})")
    counts = read_launches()
    check(counts["ps_decorr"] > 0, "ps routes did not run the decorrelator "
          "kernel")
    return counts


# -- surfaces: decode_m4a, AACFile, Aurora, the CLI, batch isolation ----------
def phase_surfaces(torch) -> dict:
    """The user surfaces on the card: decode_m4a on an LC and an HE .m4a
    against the same calls on the CPU; AACFile ranged reads of an LC stream
    against the same slices of a full decode on the card, bit for bit, and
    an HE seek read's convergence (> 60 dB against the full decode); the
    Aurora demuxer piped into AuroraDecoder against decode_adts on the card
    (the reference's 2e-4); `python -m aacjax_torch.cli info` and `decode`
    by subprocess; a good stream's PCM beside garbage streams against its
    solo decode.  Returns the launches of the surfaces' decodes."""
    import tempfile

    import aacjax_torch
    from aacjax_torch import aurora
    from aacjax_torch import testing as TI
    from aacjax_torch.host import sbr as S
    reset_launches()
    pcm = TI.tone_pcm(1024 * 24)

    lc_m4a = aacjax_torch.encode_m4a(pcm, 44100)
    got, rate = aacjax_torch.decode_m4a(lc_m4a)
    want, _ = aacjax_torch.decode_m4a(lc_m4a, device="cpu")
    err = TI.assert_pcm_close(got, want, False, "decode_m4a LC")
    check(got.shape[0] == pcm.shape[0], "decode_m4a LC: the gapless trim "
          f"returned {got.shape[0]} samples, not {pcm.shape[0]}")
    say(f"surfaces: decode_m4a LC {got.shape} at {rate} Hz (gapless trim "
        f"exact) matches the CPU (max err {err})")
    he_m4a = aacjax_torch.HEAACEncoder(44100, 2, 40_000).encode_m4a(pcm)
    got, rate = aacjax_torch.decode_m4a(he_m4a)
    want, _ = aacjax_torch.decode_m4a(he_m4a, device="cpu")
    err = he_close(got, want, "decode_m4a HE", HE_ROUTE_TOL)
    say(f"surfaces: decode_m4a HE (explicit SBR) {got.shape} at {rate} Hz "
        f"matches the CPU (max err {err:.4g} * max(1, max|ref|))")

    stream = TI.encode_adts(pcm, target_sf=120)
    full, _ = aacjax_torch.decode_adts(stream)
    f = aacjax_torch.AACFile(stream)
    cases = ((0, 1024), (5 * 1024, 1024), (5 * 1024 + 137, 2000),
             (22 * 1024 + 512, 4096), (3 * 1024, 1), (9000, 20000))
    for start, n in cases:
        check(np.array_equal(f.read(start, n), full[start:start + n]),
              f"AACFile.read({start}, {n}) on the card differs from the same "
              "slice of a full decode on the card")
    say(f"surfaces: AACFile LC, {len(cases)} ranged reads on the card equal "
        "the full decode on the card bit for bit")
    # an SBR header in every frame: a seek read's first frame must show the
    # SBR extension, as decode_adts finds HE-AAC by the first frame's
    hdr = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    he = TI.he_stream(24, ch=2, header_at=dict.fromkeys(range(24), hdr))
    he_full, _ = aacjax_torch.decode_adts(he, chunk_frames=8)
    start, n = 20 * 2048, 2 * 2048
    seek = aacjax_torch.AACFile(he, chunk_frames=8).read(start, n)
    ref = he_full[start:start + n]
    snr = 10 * np.log10(float(np.sum(ref ** 2)) / max(
        float(np.sum((seek - ref) ** 2)), 1e-30))
    check(snr > 60.0, f"AACFile HE seek: {snr:.1f} dB against the full decode")
    say(f"surfaces: AACFile HE seek read converges: {snr:.1f} dB against the "
        "full decode on the card")

    demux = aurora.ADTSDemuxer()
    dec = demux.pipe(aurora.AuroraDecoder())
    chunks = []
    dec.on("data", chunks.append)
    for off in range(0, len(stream), 1000):
        demux.feed(stream[off:off + 1000])
        dec.decode_all()
    demux.end()
    piped = np.concatenate(chunks).reshape(-1, 2)
    check(piped.shape == full.shape, f"Aurora pipe: {piped.shape} against "
          f"decode_adts's {full.shape}")
    err = float(np.abs(piped - full).max())
    check(err <= 2e-4, f"Aurora pipe on the card: {err} from decode_adts")
    say(f"surfaces: Aurora pipe {piped.shape} matches decode_adts on the card "
        f"(max err {err}, bound 2e-4)")

    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "in.aac"
        src.write_bytes(stream)
        env = dict(os.environ, PYTHONPATH=str(REPO))
        runs = {}
        for cmd in (["info"], ["decode", str(src), str(src) + ".wav"]):
            r = subprocess.run([sys.executable, "-m", "aacjax_torch.cli",
                                *cmd], capture_output=True, text=True,
                               cwd=REPO, env=env, timeout=300)
            check(r.returncode == 0, f"cli {cmd[0]}: {r.stderr[-800:]}")
            runs[cmd[0]] = json.loads(r.stdout.strip().splitlines()[-1])
    info = runs["info"]
    check(info["cuda_device"] == torch.cuda.get_device_name(0)
          and info["native_parser"] and info["native_writer"],
          f"cli info: {info}")
    check(runs["decode"]["samples"] == full.shape[0], f"cli decode: "
          f"{runs['decode']}")
    say(f"surfaces: cli info {info}; cli decode {runs['decode']['samples']} "
        "samples")

    rng = np.random.default_rng(3)
    cfg = TI.lc_stereo_config()
    good = TI.adts_payloads(stream)[:16]
    garbage = [rng.integers(0, 256, size=200).astype(np.uint8).tobytes()
               for _ in range(16)]
    both = aacjax_torch.BatchDecoder([cfg] * 4, chunk_frames=16)
    pcm_b = both.step_raw([good, garbage, garbage, good], out_int16=False)
    solo = aacjax_torch.BatchDecoder([cfg], chunk_frames=16)
    want = solo.step_raw([good], out_int16=False)
    check([st.failed for st in both.streams] == [False, True, True, False],
          f"batch isolation: failed flags {[st.failed for st in both.streams]}")
    peak = max(float(np.abs(want[:2]).max()), 1e-9)
    d = max(float(np.abs(pcm_b[:2] - want[:2]).max()),
            float(np.abs(pcm_b[6:8] - want[:2]).max()))
    check(d / peak <= 1e-5, f"batch isolation: {d / peak} relative > 1e-5")
    say(f"surfaces: a good stream beside garbage equals its solo decode "
        f"{'bit for bit' if d == 0 else f'within {d / peak:.3g} relative'} "
        "on the card")
    return read_launches()


# -- the batched encoder at serving width --------------------------------------
ENC_STREAMS = 512    # bench.py --streams 512
ENC_CHUNK = 16       # frames a chunk (bench.py --chunk 16)
ENC_CHUNKS = 4       # chunks a run
ENC_RUNS = 2         # encode_pipelined runs after the warm-up chunk
ENC_BITRATE = 128_000


def enc_analysis_check(torch, enc, chunk) -> None:
    """One chunk's analysis on the card against the CPU (coefs within
    1e-5 * max|coefs|; base and fit_sf equal on >= 99.9% of entries, never
    more than one step apart; est within 1% of each row's largest), then
    the quantize on both devices fed the CPU's analysis: q equal on
    >= 99.99% of bins and never more than one step apart, sf exact."""
    from aacjax_torch import encode_batch as EB
    seqs, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(chunk)
    psy = (enc._psy.smr_db, enc._psy.spread_up_db, enc._psy.spread_down_db)
    host = [torch.from_numpy(a) for a in (pcm_i16, w_idx.astype(np.int64),
                                          is_short)]
    outs = {}
    for dev in ("cuda", "cpu"):
        fn = EB._analysis_fn(enc._si, enc._cutoff_bin, EB.FRAME, nF, psy,
                             torch.device(dev))
        t0 = time.perf_counter()
        outs[dev] = fn(*(a.to(dev) for a in host))
        torch.cuda.synchronize()
        say(f"ENC-512: one chunk's analysis on the {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    (c, b, f, e, bb), (c0, b0, f0, e0, bb0) = (
        [a.cpu().numpy() for a in outs[d]] for d in ("cuda", "cpu"))
    check(np.array_equal(bb, bb0), "ENC-512 analysis: bin_band differs")
    c_err = float(np.abs(c - c0).max()) / float(np.abs(c0).max())
    check(c_err <= 1e-5, f"ENC-512 analysis: coefs {c_err} * max|coefs|")
    shares = {}
    for name, got, want in (("base", b, b0), ("fit_sf", f, f0)):
        diff = np.abs(got - want)
        shares[name] = float((diff != 0).mean())
        check(shares[name] <= 1e-3 and float(diff.max()) <= 1.0,
              f"ENC-512 analysis: {name} differs on {shares[name]} of "
              f"entries, max step {float(diff.max())}")
    row = np.maximum(np.abs(e0).max(axis=1, keepdims=True), 1.0)
    e_err = float((np.abs(e - e0) / row).max())
    check(e_err <= 0.01, f"ENC-512 analysis: est {e_err} of a row's largest")
    off, _ = EB.BatchEncoder(44100, 2, ENC_BITRATE, n_streams=ENC_STREAMS,
                             device="cpu")._rate_choice(e0, nF)
    short = torch.from_numpy(is_short.reshape(-1))
    q = {}
    for dev in ("cuda", "cpu"):
        args = [a.to(dev) for a in outs["cpu"]]
        q[dev] = [a.cpu().numpy() for a in enc._quantize(
            args[0], args[1], args[2], args[4],
            torch.from_numpy(off).to(dev), short.to(dev))]
    check(np.array_equal(q["cuda"][1], q["cpu"][1]), "ENC-512 quantize: sf "
          "differs")
    dq = np.abs(q["cuda"][0].astype(np.int32) - q["cpu"][0])
    q_share = float((dq != 0).mean())
    check(q_share <= 1e-4 and int(dq.max()) <= 1, f"ENC-512 quantize: q "
          f"differs on {q_share} of bins, max step {int(dq.max())}")
    say(f"ENC-512: one chunk's analysis on the card matches the CPU: coefs "
        f"{c_err:.3g} * max|coefs|, base differs on {shares['base']:.6f} and "
        f"fit_sf on {shares['fit_sf']:.6f} of (row, band) entries, est "
        f"{e_err:.4g} of a row's largest; quantize fed the same analysis: "
        f"{q_share:.7f} of q differ (max step {int(dq.max())}), sf equal")


def enc_device_profile(torch, enc, chunk) -> None:
    """The analysis and the quantize of one chunk on the card: device time,
    kernel launches and the ten costliest device ops of each
    (torch.profiler), and the peak memory of one analysis."""
    from torch.profiler import ProfilerActivity, profile
    seqs, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(chunk)
    dev = [a.to("cuda") for a in (torch.from_numpy(pcm_i16),
                                  torch.from_numpy(w_idx.astype(np.int64)),
                                  torch.from_numpy(is_short))]
    analysis = enc._analysis_for(nF)
    outs = analysis(*dev)
    off = torch.from_numpy(enc._rate_choice(outs[3].cpu().numpy(), nF)[0]
                           ).to("cuda")
    short = dev[2].reshape(-1)
    torch.cuda.synchronize()
    del outs
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    outs = analysis(*dev)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    say(f"ENC-512: analysis peak memory {peak:.3f} GiB above its inputs "
        f"({torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated at "
        "the peak)")
    reps = 5
    for what, run in (("analysis", lambda: analysis(*dev)),
                      ("quantize", lambda: enc._quantize(
                          outs[0], outs[1], outs[2], outs[4], off, short))):
        ms = time_ms(torch, run, runs=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        evs = list(prof.key_averages())
        total = sum(dev_time(e) for e in evs) / reps
        dev_s = (f"{total / 1e3:.4f} ms" if total else
                 "not measured (the trace held no device times)")
        say(f"ENC-512: {what} of one chunk: device time {dev_s} over "
            f"{sum(e.count for e in evs) / reps:.0f} kernel launches (a "
            f"trace of {reps} calls), {ms:.4f} ms by CUDA events (median of "
            "10); top 10 device ops, per call:")
        for e in sorted(evs, key=dev_time, reverse=True)[:10]:
            t = dev_time(e) / reps
            say(f"ENC-512:   {t / 1e3:8.4f} ms "
                f"{100 * t / max(total, 1e-9):5.1f}% x{e.count / reps:<5.0f} "
                f"{e.key[:100]}")


def enc_snrs(dec, outs, pcm, streams) -> list[float]:
    """Each stream's SNR (dB) of its decode (dec's f32 chunks `outs`)
    against its source pcm [S, n, 2]: the decode lags the source by one
    frame; the first chunk, where the bit estimate's calibration warms, and
    the last frame are left out."""
    L = ENC_CHUNK * 1024
    snrs = []
    for s in streams:
        out = np.concatenate([dec.stream_pcm(o, s, ENC_CHUNK) for o in outs])
        ref = pcm[s, L:len(outs) * L - 1024].astype(np.float64)
        got = out[L + 1024:] * 32768.0
        snrs.append(float(10 * np.log10(np.sum(ref ** 2)
                                        / np.sum((got - ref) ** 2))))
    return snrs


def phase_encode_serving(torch) -> dict:
    """ENC-512: 512 AAC-LC stereo streams at 44.1 kHz and 128 kbps
    (bench.py bench_encode's traffic), chunks of 16 frames through
    BatchEncoder on the card: one warm-up chunk, then ENC_RUNS runs of
    encode_pipelined over ENC_CHUNKS chunks (encode_aggregate_realtime_x per
    run and their median, the stage split, the writer); the pipelined
    payloads against sequential encode_chunk on the card byte for byte; one
    chunk's analysis and quantize against the CPU; the device programs'
    time, launches, costliest ops and peak memory; then every stream of one
    run decoded on the card through decode_pipelined (the tail kernel),
    its SNR against its source held to the same streams encoded and
    decoded on the CPU route: within 0.5 dB of each of 32 streams, and no
    stream below their minimum by more than 0.5 dB.  Returns the launches
    of the encode_pipelined runs (one of each encoder scan kernel a chunk)
    and of the decode."""
    import aacjax_torch
    from aacjax_torch.host import native_write
    from aacjax_torch.testing import encode_serving_pcm
    check(native_write.available(), "the native writer is not available")
    L = ENC_CHUNK * 1024
    pcm = encode_serving_pcm(ENC_STREAMS, ENC_CHUNKS * L)
    chunks = [pcm[:, k * L:(k + 1) * L] for k in range(ENC_CHUNKS)]
    audio_s = ENC_STREAMS * ENC_CHUNKS * L / 44100

    def encoder():
        return aacjax_torch.BatchEncoder(44100, 2, ENC_BITRATE,
                                         n_streams=ENC_STREAMS)

    t0 = time.perf_counter()
    warm = encoder()
    warm.encode_chunk(chunks[0])
    say(f"ENC-512: {ENC_STREAMS} streams x {ENC_CHUNKS} chunks of "
        f"{ENC_CHUNK} frames ({audio_s:.1f} s of audio a run), writer "
        f"{'native' if warm._native_write else 'python'}; warm-up chunk "
        f"{time.perf_counter() - t0:.2f} s")
    rtx, runs, stats = [], [], []
    reset_launches()
    for _ in range(ENC_RUNS):
        enc = encoder()
        t0 = time.perf_counter()
        outs = list(enc.encode_pipelined(iter(chunks)))
        wall = time.perf_counter() - t0
        check(len(outs) == ENC_CHUNKS, "ENC-512: encode_pipelined lost chunks")
        rtx.append(audio_s / wall)
        runs.append(outs)
        stats.append(dict(enc.stats))
    enc_counts = read_launches()
    for kernel in ENC_KERNELS:
        check(enc_counts[kernel] == ENC_RUNS * ENC_CHUNKS, f"ENC-512: "
              f"{enc_counts[kernel]} {kernel} launches over {ENC_RUNS} runs "
              f"of {ENC_CHUNKS} chunks, expected one a chunk")
    say(f"ENC-512: launches over the {ENC_RUNS} runs {enc_counts}")
    kbps = (sum(len(p) for o in runs[0] for s in o for p in s) * 8
            / (ENC_CHUNKS * L / 44100) / 1000 / ENC_STREAMS)
    say(f"ENC-512: encode_aggregate_realtime_x {float(np.median(rtx)):.1f} "
        f"(median of {ENC_RUNS} runs; runs {[round(x, 1) for x in rtx]}), "
        f"{kbps:.1f} kbps a stream")
    for k, st in enumerate(stats):
        per = {key: round(v / ENC_CHUNKS, 4) for key, v in st.items()
               if key != "frames"}
        say(f"ENC-512: run {k} stage split, seconds a chunk summed over the "
            f"three stages' threads: {per}, frames {st['frames']}")

    seq = encoder()
    want = [seq.encode_chunk(c) for c in chunks]
    check(want == runs[0], "ENC-512: encode_pipelined differs from "
          "sequential encode_chunk")
    say("ENC-512: the pipelined payloads equal sequential encode_chunk on the "
        "card byte for byte")
    enc_analysis_check(torch, seq, chunks[1])
    enc_device_profile(torch, seq, chunks[1])

    cfg = seq.config
    payloads = [[p for o in runs[0] for p in o[s]] for s in range(ENC_STREAMS)]
    dec = aacjax_torch.BatchDecoder([cfg] * ENC_STREAMS, chunk_frames=ENC_CHUNK)
    reset_launches()
    outs = list(dec.decode_pipelined(
        iter([[p[k * ENC_CHUNK:(k + 1) * ENC_CHUNK] for p in payloads]
              for k in range(ENC_CHUNKS)]), out_int16=False))
    counts = read_launches()
    check(counts["tail"] == ENC_CHUNKS, f"ENC-512 decode: launches {counts}")
    check(not any(st.failed for st in dec.streams), "ENC-512 decode: a "
          "stream failed")
    snrs = enc_snrs(dec, outs, pcm, range(ENC_STREAMS))
    # the reference for the quality: a subset of the streams encoded and
    # decoded on the CPU route (held byte for byte to aacjax's encoder by
    # tests/test_torch_encode_batch.py)
    sub = list(range(0, ENC_STREAMS, 16))
    cpu_enc = aacjax_torch.BatchEncoder(44100, 2, ENC_BITRATE,
                                        n_streams=len(sub), device="cpu")
    cpu_runs = [cpu_enc.encode_chunk(c[sub]) for c in chunks]
    same = sum(a == b for i, s in enumerate(sub) for k in range(ENC_CHUNKS)
               for a, b in zip(runs[0][k][s], cpu_runs[k][i]))
    cpu_dec = aacjax_torch.BatchDecoder([cfg] * len(sub),
                                        chunk_frames=ENC_CHUNK, device="cpu")
    cpu_outs = list(cpu_dec.decode_pipelined(
        iter([[p[k * ENC_CHUNK:(k + 1) * ENC_CHUNK] for p in
               ([q for o in cpu_runs for q in o[i]] for i in range(len(sub)))]
              for k in range(ENC_CHUNKS)]), out_int16=False))
    cpu_snrs = enc_snrs(cpu_dec, cpu_outs, pcm[sub], range(len(sub)))
    worst = max(abs(snrs[s] - c) for s, c in zip(sub, cpu_snrs))
    check(worst <= 0.5, f"ENC-512 decode: a stream's SNR is {worst:.3f} dB "
          "from the same stream's on the CPU route")
    check(min(snrs) >= min(cpu_snrs) - 0.5, f"ENC-512 decode: SNR min "
          f"{min(snrs):.2f} dB, below the CPU route's min "
          f"{min(cpu_snrs):.2f} dB - 0.5")
    say(f"ENC-512: all {ENC_STREAMS} streams of run 0 decode on the card "
        f"through decode_pipelined (launches {counts}) at SNR min "
        f"{min(snrs):.2f} / median {float(np.median(snrs)):.2f} / max "
        f"{max(snrs):.2f} dB; {len(sub)} of them on the CPU route: SNR min "
        f"{min(cpu_snrs):.2f} / median {float(np.median(cpu_snrs)):.2f} dB, "
        f"each within {worst:.4f} dB of the card's; {same} of "
        f"{len(sub) * ENC_CHUNKS * ENC_CHUNK} of their frames byte-identical "
        "to the card's")
    return add_counts(counts, enc_counts)


# -- phase 9: the mesh --------------------------------------------------------
MESH_SHARDS = 4      # shards of the mesh runs: 4x1 and 2x2
MESH_CHUNKS = 2      # chunks of the HE, PS and encoder mesh runs
MESH_HE_TOL = 1e-5   # the reference's dry-run bar, * max(1, max|ref|)


def mesh_devices(torch, n: int) -> list:
    """n distinct cards where the machine has them, else n virtual shards
    of cuda:0."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def mesh_serving_chunks(corpus, n_chunks: int, frames: int):
    per_stream = [corpus[i % len(corpus)] for i in range(N_STREAMS)]
    n = min(n_chunks, min(len(p) for p in per_stream) // frames)
    return [[p[k * frames:(k + 1) * frames] for p in per_stream]
            for k in range(n)]


def mesh_decode(torch, name: str, config, chunks, mesh, out_int16: bool,
                he: bool = False, ps: bool = False):
    """One pipelined run of `chunks` on a fresh decoder, with `mesh` (None:
    unsharded); the launch counts set to 0 just before it and read just
    after.  Returns (outputs, wall seconds, counts)."""
    import aacjax_torch
    dec = aacjax_torch.BatchDecoder(
        [config] * N_STREAMS, chunk_frames=len(chunks[0][0]),
        cce_slots=1 if ps else 0)
    run = dec.decode_he_pipelined if he else dec.decode_pipelined
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [o.copy() for o in run(iter(chunks), out_int16=out_int16,
                                  mesh=mesh)]
    wall = time.perf_counter() - t0
    counts = read_launches()
    check(len(outs) == len(chunks), f"{name}: chunks lost")
    check(not any(st.failed for st in dec.streams), f"{name}: a stream "
          f"failed: {[st.last_error for st in dec.streams if st.failed][:1]}")
    return outs, wall, counts


def mesh_lc(torch, devs) -> dict:
    """LC-512 (512 stereo streams, C = 1024, chunk_frames=16, int16 PCM) on
    a 4x1 mesh, 256 slots a shard: every chunk bit-equal to the unsharded
    card run, one tail launch a shard a chunk, realtime_x beside the
    unsharded run's; then on a 2x2 mesh (the frame axis, 8 frames a shard
    and a halo frame): every chunk within 1 LSB on < 2% of samples, and the
    carry after each of three chunks, stepped, within 3e-3 of the unsharded
    decoder's."""
    import aacjax_torch
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.testing import adts_payloads, assert_pcm_close
    config, streams = lc_corpus()
    chunks = mesh_serving_chunks([adts_payloads(d) for d in streams], 99,
                                 CHUNK)
    n = len(chunks)
    audio_s = N_STREAMS * n * CHUNK * 1024 / config.sample_rate
    m41 = meshlib.make_mesh(4, 1, devices=devs)
    m22 = meshlib.make_mesh(2, 2, devices=devs)
    for mesh in (m41, m22):      # warm-up chunk: the shards' streams
        mesh_decode(torch, "mesh warm-up", config, chunks[:1], mesh, True)
    ref, ref_wall, _ = mesh_decode(torch, "lc-512", config, chunks, None,
                                   True)
    got, wall, c41 = mesh_decode(torch, "lc-512 4x1", config, chunks, m41,
                                 True)
    check(c41["tail"] == 4 * n, f"lc-512 4x1: launches {c41}, expected "
          f"{4 * n} tail launches")
    for k in range(n):
        check(np.array_equal(got[k], ref[k]), f"lc-512 4x1: chunk {k} "
              "differs from the unsharded card run")
    say(f"mesh lc-512 4x1: all {n} chunks bit-equal to the unsharded card "
        f"run; launches {c41}; realtime_x {audio_s / wall:.1f} sharded, "
        f"{audio_s / ref_wall:.1f} unsharded (walls {wall:.3f} s and "
        f"{ref_wall:.3f} s for {audio_s:.1f} s of audio)")
    got, wall, c22 = mesh_decode(torch, "lc-512 2x2", config, chunks, m22,
                                 True)
    check(c22["tail"] == 4 * n, f"lc-512 2x2: launches {c22}")
    same = 0
    for k in range(n):
        assert_pcm_close(got[k], ref[k], True, f"lc-512 2x2 chunk {k}")
        same += int(np.array_equal(got[k], ref[k]))
    a = aacjax_torch.BatchDecoder([config] * N_STREAMS, chunk_frames=CHUNK)
    b = aacjax_torch.BatchDecoder([config] * N_STREAMS, chunk_frames=CHUNK)
    carry = 0.0
    for k in range(min(3, n)):
        a.step_raw(chunks[k], out_int16=True)
        b.finalize_step(b._device_step(
            b._parse_native(chunks[k], compact=True), True, mesh=m22))
        carry = max(carry, float((a.overlap - b.overlap).abs().max()))
        check(carry <= 3e-3, f"lc-512 2x2: the carry after chunk {k} is "
              f"{carry} from the unsharded decoder's")
    say(f"mesh lc-512 2x2: {same} of {n} chunks bit-equal to the unsharded "
        f"card run, all within 1 LSB on < 2% of samples; the carry after "
        f"each of {min(3, n)} chunks within {carry} of the unsharded "
        f"decoder's; launches {c22}; realtime_x {audio_s / wall:.1f}")
    return add_counts(dict(c41), c22)


def mesh_main(torch, devs) -> dict:
    """Main-512 on a 2x2 mesh: the predictor's state handed from frame
    shard to frame shard, TNS and the synthesis kernel per shard; f32 PCM
    of every chunk within 5e-5 * max|ref| of the unsharded card run."""
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.testing import assert_pcm_close
    config, corpus = main_corpus()
    chunks = mesh_serving_chunks(corpus, 3, CHUNK)
    m22 = meshlib.make_mesh(2, 2, devices=devs)
    ref, _, _ = mesh_decode(torch, "main-512", config, chunks, None, False)
    got, wall, counts = mesh_decode(torch, "main-512 2x2", config, chunks,
                                    m22, False)
    n = len(chunks)
    check(counts["pred"] == 4 * n and counts["synthesis"] == 4 * n
          and counts["tail"] == 0, f"main-512 2x2: launches {counts}")
    worst = max(assert_pcm_close(g, r, False, f"main-512 2x2 chunk {k}")
                / max(1.0, float(np.abs(r).max()))
                for k, (g, r) in enumerate(zip(got, ref)))
    say(f"mesh main-512 2x2: all {n} chunks within 5e-5 * max|ref| of the "
        f"unsharded card run (max {worst:.3g} * max|ref|); launches {counts}")
    return counts


def mesh_he(torch, devs, ps: bool) -> dict:
    """HE-512 or PS-512 on a 4x1 mesh, MESH_CHUNKS chunks, one run each in
    f32 and in int16 after a warm-up chunk on each side: the f32 PCM within
    MESH_HE_TOL * max(1, max|ref|) of the unsharded card run, the int16 PCM
    within HE_I16_ONSET / HE_I16_STEADY of it; one tail and (PS) one
    decorrelator launch a shard a chunk."""
    from aacjax_torch.runtime import mesh as meshlib
    name = "ps-512 4x1" if ps else "he-512 4x1"
    config, corpus = he_corpus(ps)
    chunks = mesh_serving_chunks(corpus, MESH_CHUNKS, HE_CHUNK)
    n = len(chunks)
    m41 = meshlib.make_mesh(4, 1, devices=devs)
    for mesh in (None, m41):     # warm-up chunk on each side
        mesh_decode(torch, f"{name} warm-up", config, chunks[:1], mesh,
                    True, he=True, ps=ps)
    total, walls, errs = {}, {}, []
    for out_int16 in (False, True):
        ref, ref_wall, _ = mesh_decode(torch, name, config, chunks, None,
                                       out_int16, he=True, ps=ps)
        got, wall, counts = mesh_decode(torch, name, config, chunks, m41,
                                        out_int16, he=True, ps=ps)
        check(counts["tail"] == 4 * n and counts["ps_decorr"] ==
              (4 * n if ps else 0), f"{name}: launches {counts}")
        add_counts(total, counts)
        walls[out_int16] = (wall, ref_wall)
        if out_int16:
            stats = he_i16_check([(g, r, k * HE_CHUNK) for k, (g, r) in
                                  enumerate(zip(got, ref))], name)
        else:
            errs = [he_close(g, r, f"{name} chunk {k}", MESH_HE_TOL)
                    for k, (g, r) in enumerate(zip(got, ref))]
    audio_s = N_STREAMS * n * HE_CHUNK * 2048 / 44100.0
    say(f"mesh {name}: f32 within {max(errs):.3g} * max(1, max|ref|) of the "
        f"unsharded card run (bar {MESH_HE_TOL}); int16 frames 0-1 up to "
        f"{stats['onset'][0]} LSB on {stats['onset'][1]:.5f} of samples, "
        f"later frames up to {stats['steady'][0]} LSB on "
        f"{stats['steady'][1]:.6f}; launches over both runs {total}; "
        f"realtime_x (int16 run) {audio_s / walls[True][0]:.1f} sharded, "
        f"{audio_s / walls[True][1]:.1f} unsharded")
    return total


def mesh_encode(torch, devs) -> dict:
    """ENC-512 on a 4x1 mesh (256 channel rows a shard), MESH_CHUNKS chunks
    of encode_pipelined after a warm-up chunk on each side, against the
    unsharded card run: every frame byte-identical (the rows are
    independent), one launch of each encoder scan kernel a chunk a shard,
    and each stream's decoded SNR beside the unsharded stream's.  Returns
    the encoders' and the decodes' launches."""
    import aacjax_torch
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.testing import encode_serving_pcm
    L = ENC_CHUNK * 1024
    pcm = encode_serving_pcm(ENC_STREAMS, MESH_CHUNKS * L)
    chunks = [pcm[:, k * L:(k + 1) * L] for k in range(MESH_CHUNKS)]
    m41 = meshlib.make_mesh(4, 1, devices=devs)
    runs, walls = [], []
    reset_launches()
    for mesh in (None, m41):
        enc = aacjax_torch.BatchEncoder(44100, 2, ENC_BITRATE,
                                        n_streams=ENC_STREAMS, mesh=mesh)
        list(enc.encode_pipelined(iter(chunks[:1])))     # warm-up chunk
        enc = aacjax_torch.BatchEncoder(44100, 2, ENC_BITRATE,
                                        n_streams=ENC_STREAMS, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(list(enc.encode_pipelined(iter(chunks))))
        walls.append(time.perf_counter() - t0)
    counts = read_launches()
    want = (1 + MESH_CHUNKS) * (1 + MESH_SHARDS)   # one a chunk a shard
    for kernel in ENC_KERNELS:
        check(counts[kernel] == want, f"enc-512 4x1: {counts[kernel]} "
              f"{kernel} launches, expected {want}")
    same = total = 0
    for k in range(MESH_CHUNKS):
        for a, b in zip(runs[0][k], runs[1][k]):
            same += sum(x == y for x, y in zip(a, b))
            total += len(a)
    check(same == total, f"enc-512 4x1: {total - same} of {total} frames "
          "differ from the unsharded card run")
    snrs = []
    for outs in runs:
        payloads = [[p for o in outs for p in o[s]]
                    for s in range(ENC_STREAMS)]
        dec = aacjax_torch.BatchDecoder([enc.config] * ENC_STREAMS,
                                        chunk_frames=ENC_CHUNK)
        reset_launches()
        dec_outs = list(dec.decode_pipelined(iter(
            [[p[k * ENC_CHUNK:(k + 1) * ENC_CHUNK] for p in payloads]
             for k in range(MESH_CHUNKS)]), out_int16=False))
        add_counts(counts, read_launches())
        snrs.append(enc_snrs(dec, dec_outs, pcm, range(ENC_STREAMS)))
    worst = max(abs(a - b) for a, b in zip(*snrs))
    check(worst <= 0.5, f"enc-512 4x1: a stream's SNR is {worst:.3f} dB from "
          "the unsharded run's")
    audio_s = ENC_STREAMS * MESH_CHUNKS * L / 44100
    say(f"mesh enc-512 4x1: all {total} frames byte-identical to the "
        f"unsharded card run; every stream's SNR within {worst:.4f} dB of "
        f"its unsharded SNR (median {float(np.median(snrs[1])):.2f} dB); "
        f"realtime_x {audio_s / walls[1]:.1f} sharded, "
        f"{audio_s / walls[0]:.1f} unsharded (after a warm-up chunk each)")
    return counts


def phase_mesh(torch) -> dict:
    """The mesh (runtime/mesh.py): LC-512 on 4x1 and 2x2, Main-512 on 2x2,
    HE-512 and PS-512 on 4x1, ENC-512 on 4x1, and
    graft_entry.dryrun_multichip(4); the shards on distinct cards where the
    machine has 4, else virtual shards of cuda:0.  Returns the launches of
    every run."""
    from aacjax_torch import graft_entry
    t0 = time.perf_counter()
    devs = mesh_devices(torch, MESH_SHARDS)
    where = ("distinct cards" if len(set(devs)) == MESH_SHARDS
             else "one card (virtual shards)")
    say(f"mesh: {MESH_SHARDS} shards on {where} {[str(d) for d in devs]}; "
        f"{torch.cuda.device_count()} card(s)")
    counts = mesh_lc(torch, devs)
    add_counts(counts, mesh_main(torch, devs))
    add_counts(counts, mesh_he(torch, devs, ps=False))
    add_counts(counts, mesh_he(torch, devs, ps=True))
    add_counts(counts, mesh_encode(torch, devs))
    reset_launches()
    for line in graft_entry.dryrun_multichip(MESH_SHARDS, devices=devs):
        say(f"mesh dryrun_multichip({MESH_SHARDS}): {line}")
    add_counts(counts, read_launches())
    say(f"mesh: phase done in {time.perf_counter() - t0:.1f} s; launches "
        f"{counts}")
    return counts


# -- phase 10: the compiled programs ------------------------------------------
GRAPH_REPS = 10      # calls of a profiler trace of one program


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [] if tree is None else [tree]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def host_ms(torch, fn, runs: int = TIMING_RUNS) -> float:
    """Median over `runs` of the host's time to return from one call (the
    enqueue: nothing waits for the card), each call after the card drained
    the last."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def call_profile(torch, fn, reps: int = GRAPH_REPS) -> dict:
    """Per call of `fn`, from a torch.profiler trace of `reps` calls after
    a warm-up call: the kernel launches the host made (the runtime's launch
    calls), its graph launches, its copies and fills (memcpy / memset
    calls), the device activities (kernels, copies, fills) and their
    summed device time (None when the trace holds none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = dict(kernels=0, graphs=0, copies=0, device_ops=0)
    dev_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()
            n["device_ops"] += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            n["kernels"] += 1
        elif e.name == "cudaGraphLaunch":
            n["graphs"] += 1
        elif e.name.startswith(("cudaMemcpy", "cudaMemset")):
            n["copies"] += 1
    out = {k: v / reps for k, v in n.items()}
    out["device_ms"] = dev_us / reps / 1e3 if dev_us else None
    return out


def graph_against_eager(torch, got, want, what: str, tol) -> str:
    """The graph's outputs against the eager call's: bit for bit, or, where
    they differ, within `tol` (a function of (got, want, what) that checks
    one output and returns its error).  Returns what was found."""
    g, w = tree_leaves(got), tree_leaves(want)
    check(len(g) == len(w), f"graphs: {what}: {len(g)} outputs against "
          f"{len(w)}")
    differ = []
    for i, (a, b) in enumerate(zip(g, w)):
        check(a.shape == b.shape and a.dtype == b.dtype, f"graphs: {what}: "
              f"output {i} is {a.dtype}{tuple(a.shape)} against "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            same = torch.equal(a, b)
        if not same:
            differ.append(f"output {i} ({b.dtype}{tuple(b.shape)}) within "
                          f"{tol(a.cpu(), b.cpu(), f'{what} output {i}'):.4g}")
    return ("bit-equal to eager" if not differ else
            "differs from eager: " + "; ".join(differ))


def graph_case(torch, name: str, prog, args, tol) -> None:
    """One compiled program at one shape: captured into a pool of its own
    (graphs.clear first), its replay held against its eager function on
    fresh copies of the same inputs, then per call, eager against graph:
    kernel launches and graph launches the host made, the host's enqueue
    ms, device ms (torch.profiler), ms by CUDA events, and the capture ms
    and pool bytes of the graph."""
    from aacjax_torch.runtime import graphs
    dev = tree_leaves(args)[0].device
    graphs.clear(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = read_launches()
    prog(*clone_tree(args))                   # warm-up and capture
    torch.cuda.synchronize()
    eager_counts = {k: v - before[k] for k, v in read_launches().items()}
    entry = [e for e in graphs.entries() if e["name"] == prog.name]
    check(len(entry) == 1, f"graphs: {name}: {len(entry)} captured programs")
    entry = entry[0]
    want = prog.fn(*clone_tree(args))
    before = read_launches()
    got = prog(*clone_tree(args))             # a replay
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in read_launches().items()}
    check(counts == eager_counts, f"graphs: {name}: a replay counted "
          f"{counts}, the eager call {eager_counts}")
    held = {k: v for k, v in counts.items() if v}
    found = graph_against_eager(torch, got, want, name, tol)
    del got, want

    def eager():
        return prog.fn(*args)

    def graph():
        return prog(*args)
    rows = {}
    for route, fn in (("eager", eager), ("graph", graph)):
        p = call_profile(torch, fn)
        rows[route] = (f"{p['kernels']:.0f} kernel launches, "
                       f"{p['graphs']:.0f} graph launches, "
                       f"{p['copies']:.0f} copies from the host, "
                       f"{p['device_ops']:.0f} device ops; host "
                       f"{host_ms(torch, fn):.4f} ms, device "
                       f"{fmt(p['device_ms'])}, events "
                       f"{time_ms(torch, fn, runs=10, reps=3):.4f} ms")
        if route == "graph":
            check(p["graphs"] == 1, f"graphs: {name}: {p['graphs']} graph "
                  "launches a call")
    say(f"graphs: {name}: {found}; kernels held {held}")
    say(f"graphs: {name}: eager: {rows['eager']}")
    say(f"graphs: {name}: graph: {rows['graph']}; capture "
        f"{entry['capture_s'] * 1e3:.1f} ms, pool "
        f"{entry['pool_bytes'] / 2**20:.1f} MiB")


def int16_tol(got, want, what: str) -> float:
    from aacjax_torch.testing import assert_pcm_close
    return assert_pcm_close(got.numpy(), want.numpy(), True, what)


def core_tol(got, want, what: str) -> float:
    """f32 within 5e-5 * max(1, max|ref|), as error / max(1, max|ref|)."""
    return he_close(got, want, what, 5e-5)


def phase_graphs(torch) -> None:
    """Every compiled program at its serving shape: graph against eager on
    the card (bit for bit expected; a difference is named and held to the
    program's bound: int16 1 LSB on < 2% of samples, core f32 5e-5, HE f32
    2e-4 * max(1, max|ref|)), with the numbers of graph_case; then the
    decode step at the small shapes where host time dominated, the tail at
    C = 8, T = 64 and the synthesis route at B = 256."""
    import aacjax_torch
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import pred
    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import sbr_batch as SB
    from aacjax_torch.runtime import mesh as meshlib
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)

    def spec_args(config, corpus, frames, cce_slots=0, n=N_STREAMS,
                  out_int16=True):
        per = [corpus[i % len(corpus)][:frames] for i in range(n)]
        dec = aacjax_torch.BatchDecoder([config] * n, chunk_frames=frames,
                                        cce_slots=cce_slots)
        up = dec._upload_batch(dec._parse_native(per, compact=True))
        torch.cuda.synchronize()
        flags = dec._spec_flags({k: v for k, v in up.items()
                                 if k.startswith("_")}, out_int16, True)
        args = [up["_shards"].parts[0][0], dec.overlap]
        if flags.has_pred:
            args.append(pred.pred_state_init(dec.C, dev))
        return P.jitted_decode_spec_step(flags), tuple(args)

    from aacjax_torch.testing import adts_payloads
    config, streams = lc_corpus()
    prog, args = spec_args(config, [adts_payloads(d) for d in streams], CHUNK)
    graph_case(torch, "decode_spec_step LC-512 (C=1024, T=16, compact i16, "
               "tail, int16)", prog, args, int16_tol)
    config, corpus = main_corpus()
    prog, args = spec_args(config, corpus, CHUNK, out_int16=False)
    graph_case(torch, "decode_spec_step Main-512 (C=1024, T=16, predictor, "
               "TNS, synthesis, f32)", prog, args, core_tol)
    chunks, _ = TI.packed_step_chunks(8, CHUNK, 1)
    b, flags = chunks[0]
    flags = dataclasses.replace(flags, use_pallas=True)
    C = b["quant"].shape[0]
    graph_case(torch, f"decode_step (python packer, C={C}, T={CHUNK}, Main "
               "profile)", P.jitted_decode_step(flags),
               ({k: meshlib.packed_tensor(k, v, dev) for k, v in b.items()},
                torch.zeros((C, 1024), device=dev),
                pred.pred_state_init(C, dev)), core_tol)

    core, planes, cfg, state = TI.sbr_apply_inputs(N_STREAMS, HE_CHUNK, dev,
                                                   compact=True)
    graph_case(torch, "sbr_apply HE-512 (C=1024, T=8, int16)",
               SB.jitted_sbr_apply(True), (core, planes, state, cfg),
               int16_tol)
    del core, planes, cfg, state
    core, planes, ps, cfg, state, ps20 = TI.sbr_ps_apply_inputs(
        N_STREAMS, HE_CHUNK, dev)
    C = core.shape[0]
    ps34 = PB.ps_state_init(C, True, dev)
    for is34, st in ((False, ps20), (True, ps34)):
        graph_case(torch, f"sbr_ps_apply PS-512 (C=1024, T=8, "
                   f"{34 if is34 else 20}-band, int16)",
                   PB.jitted_sbr_ps_apply(True, is34),
                   (core, planes, ps, state, st, cfg), int16_tol)
    mixed = dict(ps, slot_is34=(torch.arange(C, device=dev) % 2).float())
    graph_case(torch, "sbr_ps_apply_dual PS-512 (C=1024, T=8, half the "
               "slots 34-band, int16)", PB.jitted_sbr_ps_apply_dual(True),
               (core, planes, mixed, state, ps20, ps34, cfg), int16_tol)
    del core, planes, ps, cfg, state, ps20, ps34, mixed

    from aacjax_torch.testing import encode_serving_pcm
    enc = aacjax_torch.BatchEncoder(44100, 2, ENC_BITRATE,
                                    n_streams=ENC_STREAMS)
    pcm = encode_serving_pcm(ENC_STREAMS, ENC_CHUNK * 1024)
    _, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(pcm)
    ins = tuple(torch.from_numpy(a).to(dev) for a in (
        pcm_i16, w_idx.astype(np.int64), is_short))
    analysis = enc._analysis_for(nF)
    graph_case(torch, f"encode analysis ENC-512 ({ins[0].shape[0]} rows, "
               f"{nF} frames)", analysis, ins, exact_tol)
    outs = analysis.fn(*ins)
    off, _ = enc._rate_choice(outs[3].cpu().numpy(), nF)
    graph_case(torch, "encode quantize ENC-512", enc._quantize,
               (outs[0], outs[1], outs[2], outs[4],
                torch.from_numpy(off).to(dev), ins[2].reshape(-1)),
               exact_tol)
    del outs, ins

    for C, T, what in ((8, 64, "tail"), (2, 128, "synthesis, B = 256")):
        b = TI.spec_step_chunk(7, C, T)
        flags = P.PipelineFlags(has_stereo=False, use_pallas=True,
                                has_short=True)
        graph_case(torch, f"decode_spec_step small (C={C}, T={T}, f32, "
                   f"{what})", P.jitted_decode_spec_step(flags),
                   ({k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                    torch.zeros((C, 1024), device=dev)), core_tol)
    say(f"graphs: phase done in {time.perf_counter() - t0:.1f} s")


def exact_tol(got, want, what: str) -> float:
    """The encoder's programs: a difference from eager is a failure (q and
    sf feed the bitstream)."""
    fail(f"graphs: {what}: differs from eager")
    return 0.0



# -- phase 11: the port's benchmark ---------------------------------------------
BENCH_SECONDS = 2.0  # audio a stream in each mode (the default run: 8 s LC,
                     # 4 s the sub-benches)
BENCH_ENC_STREAMS = 128
BENCH_TIMEOUT = 600  # seconds the LC command may take
BENCH_LC_STAGES = ("parse_s", "h2d_s", "dispatch_s", "compute_s", "d2h_s",
                   "chunk_audio_s", "compute_realtime_x", "wall_chunk_s",
                   "serial_floor_s", "overlap_floor_s",
                   "pipeline_overlap_eff")
BENCH_HE_STAGES = ("host_s", "core_s", "core_compute_s", "sbr_h2d_s",
                   "sbr_dispatch_s", "sbr_compute_s", "d2h_s",
                   "chunk_audio_s", "compute_realtime_x")
BENCH_ENC_SPLIT = ("prep_s", "h2d_s", "analysis_dispatch_s",
                   "analysis_compute_s", "est_d2h_s", "rate_s",
                   "quantize_dispatch_s", "quantize_compute_s", "q_d2h_s",
                   "write_s", "chunk_audio_s", "compute_realtime_x")
BENCH_ENC_STAGES = ("h2d_s", "analysis_s", "d2h_s", "host_s", "write_s",
                    "frames")


def bench_check(torch, name: str, res: dict, metric: str,
                stage_keys: dict) -> None:
    """One result of aacjax_torch.bench: no error or skip, the reference's
    schema, the metric, `device` naming this card, and under each key of
    `stage_keys` those stages, every value finite and positive (the
    pipeline's overlap efficiency finite: it is negative where the wall
    exceeds the serial sum of the stages)."""
    check("error" not in res and "skipped" not in res,
          f"{name}: the mode failed: {res}")
    for key in ("metric", "value", "median", "reps", "unit", "device",
                *stage_keys):
        check(key in res, f"{name}: no {key!r} in {sorted(res)}")
    check(res["metric"] == metric, f"{name}: metric {res['metric']!r}, "
          f"expected {metric!r}")
    check(torch.cuda.get_device_name(0) in res["device"],
          f"{name}: device {res['device']!r} does not name "
          f"{torch.cuda.get_device_name(0)!r}")
    nums = {"value": res["value"], "median": res["median"],
            **{f"reps[{i}]": v for i, v in enumerate(res["reps"])}}
    for key, keys in stage_keys.items():
        check(set(res[key]) == set(keys), f"{name}: {key} keys "
              f"{sorted(res[key])}, expected {sorted(keys)}")
        nums.update({f"{key}.{k}": v for k, v in res[key].items()})
    for k, v in nums.items():
        ok = isinstance(v, (int, float)) and np.isfinite(v)
        check(ok and (v > 0 or k.endswith("pipeline_overlap_eff")),
              f"{name}: {k} = {v!r}")


def phase_bench(torch) -> dict:
    """The port's benchmark, aacjax_torch/bench.py, cut in depth: the LC
    headline through its command line (python -m aacjax_torch.bench
    --lc-only, 512 streams of BENCH_SECONDS, 2 reps) in a process of its
    own, its last line parsed and held to the schema; then bench_lc (the
    same corpus, no stage split), bench_he, bench_he(ps=True) (512
    streams, chunks of 8) and bench_encode (128 streams, chunks of 8) in
    this process, 1 rep each.  Each counts its launches through its
    `timed` hook, set to 0 after the warm-up and read after the timed
    rep, before the stage split: the tail launched in the LC and both HE
    modes, the PS decorrelator in the PS mode, the encoder's two scan
    kernels in the encode mode.  Returns the in-process modes'
    launches."""
    from aacjax_torch import bench
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "aacjax_torch.bench", "--lc-only",
           "--seconds", str(BENCH_SECONDS), "--repeats", "2"]
    try:
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"bench: {' '.join(cmd[1:])} ran past {BENCH_TIMEOUT} s")
    check(r.returncode == 0, f"bench: {' '.join(cmd[1:])} exited "
          f"{r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    check(bool(lines), "bench: the LC command printed nothing")
    try:
        lc = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"bench: the LC command's last line is not JSON: {lines[-1]!r}")
    bench_check(torch, "bench lc", lc, "aggregate_realtime_x",
                {"stages": BENCH_LC_STAGES})
    say(f"bench lc ({' '.join(cmd[1:])}, {time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(lc)}")

    counts = {}

    @contextlib.contextmanager
    def counted():
        """The launches of a bench's timed reps, into `counts`."""
        torch.cuda.synchronize()
        reset_launches()
        yield
        torch.cuda.synchronize()
        counts.update(read_launches())

    lc_args = bench._parse_args(["--seconds", str(BENCH_SECONDS),
                                 "--repeats", "1", "--no-stages"])
    modes = (
        ("lc (in process)", lambda: bench.bench_lc(lc_args, timed=counted),
         "aggregate_realtime_x", {}, ("tail",)),
        ("he", lambda: bench.bench_he(N_STREAMS, BENCH_SECONDS, HE_CHUNK, 1,
                                      timed=counted),
         "he_aac_aggregate_realtime_x", {"stages": BENCH_HE_STAGES},
         ("tail",)),
        ("ps", lambda: bench.bench_he(N_STREAMS, BENCH_SECONDS, HE_CHUNK, 1,
                                      ps=True, timed=counted),
         "he_aac_v2_aggregate_realtime_x", {"stages": BENCH_HE_STAGES},
         ("tail", "ps_decorr")),
        ("encode", lambda: bench.bench_encode(BENCH_ENC_STREAMS,
                                              BENCH_SECONDS, 8, 1,
                                              timed=counted),
         "encode_aggregate_realtime_x",
         {"stages": BENCH_ENC_STAGES, "stages_split": BENCH_ENC_SPLIT},
         ENC_KERNELS))
    total = dict.fromkeys(KERNELS, 0)
    for name, run, metric, stage_keys, kernels in modes:
        t1 = time.perf_counter()
        counts.clear()
        res = run()
        bench_check(torch, f"bench {name}", res, metric, stage_keys)
        for kernel in kernels:
            check(counts.get(kernel, 0) > 0, f"bench {name}: the {kernel} "
                  "kernel was never launched in the timed reps")
        add_counts(total, counts)
        say(f"bench {name} ({time.perf_counter() - t1:.1f} s, launches "
            f"{counts}): {json.dumps(res)}")
    say(f"bench: phase done in {time.perf_counter() - t0:.1f} s")
    return total


T0 = time.perf_counter()


def main() -> None:
    if not (REPO / "aacjax_torch" / "__init__.py").exists():
        fail("aacjax_torch is not next to chip_smoke.py")
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")

    # -- phase 1: environment and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from aacjax_torch.kernels import _build
    nvcc = _build.nvcc_path()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60)
    say(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    try:
        import triton
        say(f"triton {triton.__version__} imports")
    except ImportError as e:
        say(f"triton does not import: {e}")
    from aacjax_torch.host import native
    say(f"native parser available: {native.available()}")
    check(native.available(), "the native parser is not available")
    path, secs = _build.build()
    _build.lib()
    say(f"kernels built in {secs:.1f} s: {path.relative_to(REPO)}")
    for line in ptxas_lines(_build.ptxas_log()):
        say(line)
    for name, ops in sass_counts(path, ("enc_spread_kernel",
                                        "enc_rate_cost_kernel")).items():
        check(bool(ops), f"no SASS found for {name}")
        say(f"sass {name}: " + ", ".join(f"{op} {ops.get(op, 0)}"
                                         for op in SLOW_OPS)
            + f" of {sum(ops.values())} instructions")

    dev = torch.device("cuda")
    results = phase_kernels(torch, dev)
    phase_he_checks(torch, dev)
    phase_ps_checks(torch, dev)
    # the launches of every main path, each counted from 0 over its own run
    launches = dict.fromkeys(KERNELS, 0)
    for phase in (phase_slice, phase_slice_tns, phase_slice_main,
                  phase_slice_mc, phase_decode_adts, phase_he_serving,
                  phase_he_routes, phase_ps_serving, phase_ps_routes,
                  phase_surfaces, phase_encode_serving, phase_mesh):
        for kernel, n in phase(torch).items():
            launches[kernel] += n
    phase_graphs(torch)
    add_counts(launches, phase_bench(torch))
    for kernel in KERNELS:
        check(launches[kernel] > 0, f"the {kernel} kernel was never launched "
              "on a main path")
        results[kernel]["launches"] = launches[kernel]

    src = "aacjax_torch/kernels/csrc/"
    meta = {"tail": (src + "filterbank.cu", "aacjax/kernels/pallas_tail.py:190"),
            "synthesis": (src + "filterbank.cu",
                          "aacjax/kernels/pallas_synth.py:112"),
            "tns": (src + "tns.cu", "aacjax/kernels/pipeline.py:334"),
            "pred": (src + "pred.cu", "aacjax/kernels/pipeline.py:219"),
            "ps_decorr": (src + "ps_decorr.cu",
                          "aacjax/kernels/ps_batch.py:366"),
            "enc_spread": (src + "enc_scans.cu", "aacjax/encode_batch.py:176"),
            "enc_rate_cost": (src + "enc_scans.cu",
                              "aacjax/encode_batch.py:364")}
    keys = ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name=k, route="cuda", source=meta[k][0],
                    replaces=meta[k][1], **{q: results[k][q] for q in keys})
               for k in meta]
    say(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
