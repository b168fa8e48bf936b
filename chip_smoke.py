#!/usr/bin/env python3
"""Drive the port's AAC-LC serving path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. environment (GPU, power limit, torch, nvcc, triton, native parser),
     the build of the CUDA kernels from aacjax_torch/kernels/csrc and what
     ptxas reported for each kernel (registers, spills);
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes and a few others, with its time beside the plain
     version's, the least time the card could take for the same work
     (its bound) and a PyTorch library call as a yardstick where one
     exists (CUDA events, median of 20 runs of 10 back-to-back calls for
     the kernels and the library calls, of 1 call for the plain versions,
     of which the TNS one gets 3 runs), and each kernel's own device time
     from a torch.profiler trace of 10 launches;
  3. the serving slice at full width: 512 concurrent AAC-LC stereo streams
     (44.1 kHz, ~200 kbps; the reference's headline corpus),
     chunk_frames=16, through BatchDecoder.decode_pipelined, five runs --
     launch counts, every chunk of every stream of every run against the
     plain route (and the share of int16 samples that differ), the host's
     cores and parse threads, aggregate realtime x (median of the runs),
     stage split;
  4. decode_adts on a stream with short windows and TNS (synthesis and TNS
     kernels) and on a mono stream in chunks of 5 frames (synthesis at
     C*T = 15), each against the plain route on the CPU, and the round-trip
     SNR of an encoded tone.
The last two lines are a JSON object of the kernels' results and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

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
    """The kernel's own device time per launch (ms), from a torch.profiler
    trace of `reps` calls after a warm-up call: the average over the
    launches of every device kernel whose name holds `kernel`.  None when
    the trace shows no such kernel."""
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
    count = sum(e.count for e in evs)
    return total / count / 1e3 if count and total else None


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
            kind = (f"filterbank_kernel<spec_i16={k[1]}, mode={k[2]}>" if k
                    else "tns_kernel" if "tns_kernel" in name else name)
            out.append(f"ptxas {kind}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name, spill = None, ""
    return out


# -- phase 2: each kernel against its plain version ---------------------------
def phase_kernels(torch, dev) -> dict:
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import synth, tail, tns
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

    for B, key in ((256, "synthesis"), (16384, "synthesis_16384")):
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

    for C, T, key in ((256, 16, None), (4, 64, "tns")):
        args = on_dev(TI.random_tns_chunk(5 + C, C, T))
        out = tns.tns(*args)
        ref = tns.tns_ref(*args)
        torch.cuda.synchronize()
        xmax = float(args[0].abs().max())
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), "tns: non-finite output")
        check(err <= 1e-6 * xmax, f"tns B={C * T}: err {err} > {1e-6 * xmax}")
        ms = time_ms(torch, lambda: tns.tns(*args), reps=REPS)
        dms = device_ms(torch, lambda: tns.tns(*args), "tns_kernel")
        # the plain version is a Python loop of ~0.5 M small launches
        # (seconds per call): three runs
        plain = time_ms(torch, lambda: tns.tns_ref(*args), runs=3)
        b_ms, b_by = bound(nbytes(*args, out), tns_flops(args))
        if key:
            results[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
        say(f"kernel tns B={C * T} orders 2/12/20: max err {err} "
            f"(max|x| {xmax:.1f}); {ms:.4f} ms per call (device {fmt(dms)}), "
            f"plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); no PyTorch call computes TNS")
    return results


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
def phase_slice(torch) -> int:
    import aacjax_torch
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import synth, tail, tns
    from aacjax_torch.testing import (adts_payloads, assert_pcm_close,
                                      make_corpus)

    t0 = time.perf_counter()
    config, streams = make_corpus(4, 4.0)
    corpus = [adts_payloads(d) for d in streams]
    per_stream = [corpus[i % 4] for i in range(N_STREAMS)]
    n_chunks = min(len(p) for p in per_stream) // CHUNK
    chunks = [[p[k * CHUNK:(k + 1) * CHUNK] for p in per_stream]
              for k in range(n_chunks)]
    say(f"slice: corpus of 4 unique streams x 4 s encoded in "
        f"{time.perf_counter() - t0:.1f} s; {N_STREAMS} streams x "
        f"{n_chunks} chunks of {CHUNK} frames")
    say(f"slice: host has {os.cpu_count()} online cores, "
        f"AACJAX_PARSE_THREADS={os.environ.get('AACJAX_PARSE_THREADS')}, "
        f"the native parse uses {parse_threads(N_STREAMS)} threads")

    def decoder():
        return aacjax_torch.BatchDecoder([config] * N_STREAMS,
                                         chunk_frames=CHUNK)

    decoder().step_raw(chunks[0], out_int16=True)       # warm-up chunk
    torch.cuda.synchronize()
    # WINDOWS pipelined runs over all chunks, each with a fresh decoder
    tail.launches = synth.launches = tns.launches = 0
    walls, runs = [], []
    for _ in range(WINDOWS):
        dec = decoder()
        t1 = time.perf_counter()
        outs = list(dec.decode_pipelined(iter(chunks), out_int16=True,
                                         compact=True))
        walls.append(time.perf_counter() - t1)
        check(len(outs) == n_chunks, "decode_pipelined lost chunks")
        check(not any(st.failed for st in dec.streams), "a stream failed")
        runs.append(outs)
    launches = tail.launches
    audio_s = N_STREAMS * n_chunks * CHUNK * 1024 / config.sample_rate
    say(f"slice: tail launches {launches} for {WINDOWS} x {n_chunks} chunks "
        f"(synthesis {synth.launches}, tns {tns.launches})")
    check(launches >= WINDOWS * n_chunks,
          "the tail kernel did not run every chunk")

    # every chunk of every stream of every run against the plain route on
    # the same parsed batches (a separate decoder parses the same chunks)
    ver = decoder()
    overlap = torch.zeros((ver.C, 1024), device="cuda")
    worst, n_diff, n_all = 0.0, 0, 0
    for k, chunk in enumerate(chunks):
        dev = ver._upload_batch(ver._parse_native(chunk, compact=True))
        ver._h2d_done[0].synchronize()
        facts = {key: dev.pop(key) for key in list(dev) if key[0] == "_"}
        flags = P.PipelineFlags(has_stereo=False, has_tns=facts["_has_tns"],
                                out_int16=True, spec_i16=True,
                                has_short=facts["_has_short"])
        ref, overlap = P.decode_spec_step(dev, overlap, flags)
        ref = ref.cpu()
        for w, outs in enumerate(runs):
            worst = max(worst, assert_pcm_close(outs[k], ref, True,
                                                f"run {w} chunk {k}"))
            n_diff += int((outs[k] != ref.numpy()).sum())
            n_all += ref.numel()
    say(f"slice: all {n_chunks} chunks of all {N_STREAMS} streams in all "
        f"{WINDOWS} runs match the plain route within 1 LSB on < 2% of "
        f"samples (max int16 delta {worst:.0f}, {n_diff / n_all:.6f} of "
        f"samples differ)")

    # stage split for one chunk: parse on the host clock, H2D / compute /
    # D2H with CUDA events on their streams (median of 5)
    st = decoder()
    splits = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        p0 = time.perf_counter()
        parsed = st._parse_native(chunks[1], compact=True)
        parse_s = time.perf_counter() - p0
        ev[0].record(st._h2d_stream)
        dev = st._upload_batch(parsed)
        ev[1].record(st._h2d_stream)
        ev[2].record(st._compute_stream)
        pcm = st._device_step(dev, out_int16=True)
        ev[3].record(st._compute_stream)
        torch.cuda.synchronize()
        ev[4].record(st._d2h_stream)
        st.finalize_step(pcm)
        ev[5].record(st._d2h_stream)
        torch.cuda.synchronize()
        splits.append((parse_s, ev[0].elapsed_time(ev[1]) / 1e3,
                       ev[2].elapsed_time(ev[3]) / 1e3,
                       ev[4].elapsed_time(ev[5]) / 1e3))
    parse_s, h2d_s, comp_s, d2h_s = np.median(np.array(splits), axis=0)
    chunk_audio = N_STREAMS * CHUNK * 1024 / config.sample_rate
    rtx = [audio_s / w for w in walls]
    say(f"slice: aggregate_realtime_x {float(np.median(rtx)):.1f} "
        f"(median of {WINDOWS} runs of {audio_s:.1f} s of audio, int16 PCM "
        f"delivered, compact i16 H2D; runs {[round(x, 1) for x in rtx]}, "
        f"walls {[round(w, 3) for w in walls]} s)")
    say(f"slice: per-chunk stages ({chunk_audio:.1f} s of audio): parse "
        f"{parse_s:.4f} s, h2d {h2d_s:.4f} s, compute {comp_s:.4f} s, "
        f"d2h {d2h_s:.4f} s")
    return launches


# -- phase 4: decode_adts ----------------------------------------------------
def phase_decode_adts(torch) -> dict:
    import aacjax_torch
    from aacjax_torch.kernels import synth, tail, tns
    from aacjax_torch.testing import (assert_pcm_close, encode_adts,
                                      tns_short_adts, tone_pcm)

    data = tns_short_adts(12, seed=0)
    tail.launches = synth.launches = tns.launches = 0
    out, rate = aacjax_torch.decode_adts(data)
    counts = dict(synthesis=synth.launches, tns=tns.launches)
    say(f"decode_adts: TNS + short-window stream, launches {counts} "
        f"(tail {tail.launches})")
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
    counts["synthesis"] = synth.launches

    pcm = tone_pcm(n)
    dec, _ = aacjax_torch.decode_adts(encode_adts(pcm, target_sf=120))
    got = dec[1024:1024 + n] * 32768.0       # undo the encoder's delay
    lo, hi = 2048, n - 2048
    err = got[lo:hi] - pcm[lo:hi]
    snr = 10 * np.log10(np.sum(pcm[lo:hi] ** 2) / np.sum(err ** 2))
    say(f"decode_adts: round-trip SNR {snr:.2f} dB")
    check(bool(np.isfinite(dec).all()) and snr > 60.0, "round-trip SNR <= 60 dB")
    return counts


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

    dev = torch.device("cuda")
    results = phase_kernels(torch, dev)
    results["tail"]["launches"] = phase_slice(torch)
    counts = phase_decode_adts(torch)
    results["synthesis"]["launches"] = counts["synthesis"]
    results["tns"]["launches"] = counts["tns"]

    src = "aacjax_torch/kernels/csrc/"
    meta = {"tail": (src + "filterbank.cu", "aacjax/kernels/pallas_tail.py:190"),
            "synthesis": (src + "filterbank.cu",
                          "aacjax/kernels/pallas_synth.py:112"),
            "tns": (src + "tns.cu", "aacjax/kernels/pipeline.py:334")}
    keys = ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name=k, route="cuda", source=meta[k][0],
                    replaces=meta[k][1], **{q: results[k][q] for q in keys})
               for k in meta]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
