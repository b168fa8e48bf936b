"""The port's headline benchmark: aggregate decode and encode throughput on
one CUDA card, function for function the counterpart of the reference's
`bench.py`.

    python -m aacjax_torch.bench                 # LC, then he / ps / encode
    python -m aacjax_torch.bench --lc-only       # the LC headline alone
    python -m aacjax_torch.bench --he [--ps]     # HE-AAC v1 / v2 alone
    python -m aacjax_torch.bench --encode        # the batched encoder alone

Decodes N concurrent AAC-LC stereo ADTS streams end to end (the native C++
parse, threaded across streams; the copy of the compact spectra to the card;
the compiled decode step with the hand-written tail kernel; int16 PCM back
to the host) and reports aggregate realtime x: audio seconds decoded per
wall second.  Prints ONE JSON line with the reference's schema (`metric`,
`value`, `median`, `reps`, `unit`, `stages`, `modes`; the encoder's mode
adds `stages_split`) and `device`, the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them.

The default run measures all four programs (AAC-LC decode, the headline;
HE-AAC v1; HE-AAC v2; the batched encoder) under one budget,
AACJAX_BENCH_BUDGET seconds (default 900), split among the four modes
before any of them runs: each mode's share bounds its timed repetitions
(the first always runs), so a mode that runs long cannot leave a later one
without time.  Every mode records its per-rep values (`reps`) and their
median beside the best.

Where the port differs from the reference:

- every stage that runs on the card is timed by CUDA events recorded on the
  stream that does its work (the decoder's copy-up, compute and copy-down
  streams; the encoder's upload and download streams); host stages by the
  host clock.  The chained device stages (`compute_s`, `core_compute_s`,
  `sbr_compute_s`, the encoder's `*_compute_s`) are the events' time over
  a chain of calls divided by its length: since every program replays as
  one CUDA graph, that is the device's time unless the host enqueues the
  calls more slowly than the card runs them;
- the LC stage split has no A/B against a second device route
  (`compute_xla_s` / `compute_pallas_s`): the port keeps one form a stage;
- `overlap_floor_s` is the largest of parse, H2D, compute and D2H: the card
  copies each way on its own engine, so H2D and D2H overlap each other;
- `vs_baseline` is gone (its target was set for another accelerator);
  `device` is new;
- a stage split that fails is the mode's failure, not a result without
  stages.

The benchmark runs on the card only: without one, the command line exits
non-zero.  The functions take `device`; the tests pass "cpu", where the
kernels' plain versions run and every stage is on the host clock.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from aacjax_torch.testing import make_corpus

LC_CHAIN = 16      # chained decode steps of compute_s
HE_CHAIN = 8       # chained core and SBR (+ PS) steps of the HE split
ENC_CHAIN = 8      # chained analysis and quantize calls of the encode split
MODES = ("lc", "he", "ps", "encode")


def card_info(device) -> str:
    """The device as the result names it: on the card its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them, else "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    if idx < len(lines):
        return lines[idx].strip()
    return f"{torch.cuda.get_device_name(idx)}, power limit not read"


def _label(device) -> str:
    """What the `unit` strings say ran the device half."""
    dev = torch.device(device)
    return (f"one {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
            else "the CPU")


class _Stage:
    """One stage's seconds.  With a CUDA stream: events recorded on it, the
    stream that does the stage's work, around the block, in which it is the
    current stream.  Without (a host stage, or every stage on the CPU): the
    host clock, the stage's work done when its calls return."""

    def __init__(self, stream=None):
        self.stream = stream

    def __enter__(self):
        if self.stream is None:
            self._t = [time.perf_counter()]
            return self
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self._ev[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            self._t.append(time.perf_counter())
        else:
            self._ev[1].record(self.stream)
            self._ctx.__exit__(*exc)
        return False

    @property
    def s(self) -> float:
        if self.stream is None:
            return self._t[1] - self._t[0]
        self._ev[1].synchronize()
        return self._ev[0].elapsed_time(self._ev[1]) / 1e3


def _dec_streams(dec) -> tuple:
    """The decoder's (copy up, compute, copy down) streams; Nones on the
    CPU."""
    if not dec._cuda:
        return None, None, None
    return dec._h2d_stream, dec._compute_stream, dec._d2h_stream


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _min_over(reps: list[dict]) -> dict:
    return {k: round(min(r[k] for r in reps), 6) for k in reps[0]}


def measure_stages(dec, chunk, compact: bool, reps: int = 3) -> dict:
    """One chunk's decode as parse / H2D / one dispatch / device compute /
    D2H seconds, the min of each over `reps`, through the timed loop's own
    calls (the native parse, _upload_batch, _device_step, finalize_step).
    compute_s is the time of LC_CHAIN chained replays of the compiled step
    (pipeline.jitted_decode_spec_step) through the overlap, divided by
    LC_CHAIN; the decoder's overlap is restored after the chain."""
    from aacjax_torch.kernels.pipeline import jitted_decode_spec_step
    h2d, compute, d2h = _dec_streams(dec)
    out = []
    for _ in range(reps):
        with _Stage() as parse:
            parsed = dec._parse_native(chunk, compact=compact)
        with _Stage(h2d) as up:
            batch = dec._upload_batch(parsed)
        flags = dec._spec_flags(batch, out_int16=True, use_pallas=True)
        shard = batch["_shards"].parts[0][0]
        with _Stage(compute) as dispatch:
            pcm = dec._device_step(dict(batch), out_int16=True)
        _sync(dec.device)
        with _Stage(d2h) as down:
            dec.finalize_step(pcm)
        fn = jitted_decode_spec_step(flags)
        ov0 = dec.overlap
        with _Stage(compute):
            _pcm, ov = fn(shard, ov0)     # the chain's key, outside the timer
        with _Stage(compute) as chain:
            for _ in range(LC_CHAIN):
                _pcm, ov = fn(shard, ov)
        dec.overlap = ov0
        out.append(dict(parse_s=parse.s, h2d_s=up.s, dispatch_s=dispatch.s,
                        compute_s=chain.s / LC_CHAIN, d2h_s=down.s))
    return _min_over(out)


def measure_stages_he(dec, chunk_payloads, ps: bool, reps: int = 2) -> dict:
    """One HE chunk as host phase / core (H2D + one step) / core compute /
    SBR-plane H2D / one SBR (+ PS) dispatch / SBR compute / D2H seconds,
    the min of each over `reps`.  The two compute stages are HE_CHAIN
    chained calls divided by HE_CHAIN: the core step through the overlap,
    the runtime's SBR (+ PS) dispatch (_sbr_dispatch) through the SBR and
    PS state it carries on the decoder from call to call.  The PS planes'
    copy counts in sbr_h2d_s, as the pipeline uploads them beside the SBR
    planes."""
    h2d, compute, d2h = _dec_streams(dec)
    home = dec._home
    out = []
    for _ in range(reps):
        with _Stage() as host:
            parsed, dense, ctx = dec._he_host_phase(chunk_payloads)
        with _Stage(h2d) as core_up:
            core_dev = dec._upload_batch(parsed)
        with _Stage(compute) as core_step:
            core = dec._device_step(dict(core_dev), out_int16=False)
        with _Stage(compute) as core_chain:
            for _ in range(HE_CHAIN):
                dec._device_step(dict(core_dev), out_int16=False)
        _sync(dec.device)      # the planes' copy waits for no chained step
        with _Stage(h2d) as sbr_up:
            planes = dec._sbr_upload(dense, ctx, home)

        def step():
            return dec._sbr_dispatch(core, *planes, ctx, True, home)[0]
        with _Stage(compute) as sbr_step:
            step()
        with _Stage(compute) as sbr_chain:
            for _ in range(HE_CHAIN):
                pcm = step()
        _sync(dec.device)
        with _Stage(d2h) as down:
            dec.finalize_step(pcm)
        out.append(dict(host_s=host.s, core_s=core_up.s + core_step.s,
                        core_compute_s=core_chain.s / HE_CHAIN,
                        sbr_h2d_s=sbr_up.s, sbr_dispatch_s=sbr_step.s,
                        sbr_compute_s=sbr_chain.s / HE_CHAIN, d2h_s=down.s))
    return _min_over(out)


def measure_stages_encode(enc, pcm_chunk, reps: int = 2) -> dict:
    """One encode chunk as prep / H2D / one analysis dispatch / analysis
    compute / est D2H / rate choice / one quantize dispatch / quantize
    compute / q-sf D2H / write seconds, the min of each over `reps`.  The
    upload, analysis and est copy run on one stream and the quantize and
    its copy on another, as in encode_pipelined; the compute stages are
    ENC_CHAIN chained calls divided by ENC_CHAIN."""
    up_streams, down_streams = enc._new_streams(), enc._new_streams()
    up = down = None
    if up_streams is not None:
        (up,), (down,) = up_streams.values(), down_streams.values()
    out = []
    for _ in range(reps):
        with _Stage() as prep:
            seqs, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(pcm_chunk)
        analysis = enc._analysis_for(nF)
        with _Stage(up) as h2d:
            dev = [blocks[0] for blocks in enc._upload(pcm_i16, w_idx,
                                                       is_short, up_streams)]
        with _Stage(up) as a_step:
            outs = analysis(*dev)
        with _Stage(up) as a_chain:
            for _ in range(ENC_CHAIN):
                outs = analysis(*dev)
        with _Stage(up) as est_down:
            (est_np,) = enc._to_host([outs[3]], up_streams)
        with _Stage() as rate:
            off, chosen_est = enc._rate_choice(est_np, nF)
        coefs, base, fit_sf, _est, bin_band = outs
        short_flat = is_short.reshape(-1)
        if down is not None:
            down.wait_stream(up)
        with _Stage(down) as q_step:
            off_t = torch.from_numpy(off).to(enc.device)
            short_t = torch.from_numpy(short_flat).to(enc.device)
            q_dev, sf_dev = enc._quantize(coefs, base, fit_sf, bin_band,
                                          off_t, short_t)
        with _Stage(down) as q_chain:
            for _ in range(ENC_CHAIN):
                q_dev, sf_dev = enc._quantize(coefs, base, fit_sf, bin_band,
                                              off_t, short_t)
        with _Stage(down) as q_down:
            q_packed, sf = enc._to_host([q_dev, sf_dev], down_streams)
        with _Stage() as write:
            q = enc._unpack_q(q_packed, short_flat).reshape(
                enc.S, enc.channels, nF, 1024)
            enc._write_out(seqs, q, sf.reshape(enc.S, enc.channels, nF, -1),
                           chosen_est)
        out.append(dict(prep_s=prep.s, h2d_s=h2d.s,
                        analysis_dispatch_s=a_step.s,
                        analysis_compute_s=a_chain.s / ENC_CHAIN,
                        est_d2h_s=est_down.s, rate_s=rate.s,
                        quantize_dispatch_s=q_step.s,
                        quantize_compute_s=q_chain.s / ENC_CHAIN,
                        q_d2h_s=q_down.s, write_s=write.s))
    return _min_over(out)


def _median(vals):
    return round(float(np.median(vals)), 1) if vals else None


def bench_he(n_streams: int, seconds: float, chunk: int, repeats: int,
             ps: bool = False, pipelined: bool = True,
             rep_budget_s: float = 330.0, device="cuda",
             timed=contextlib.nullcontext) -> dict:
    """HE-AAC batched throughput at the 44.1 kHz output: the host phase
    (native core parse, SBR [+ PS] parse and pack) and the compiled device
    programs (core decode -> batched SBR [-> batched Parametric Stereo with
    `ps`: mono v2 streams emitting stereo, cce_slots=1]).  Every stream
    replays one stream, bench_he's own (seed 7): he_serving_corpus /
    ps_serving_corpus(1, seconds, chunk).  `timed()` is entered around the
    timed reps alone, as in bench_lc."""
    from aacjax_torch.runtime.batch import BatchDecoder
    from aacjax_torch.testing import he_serving_corpus, ps_serving_corpus

    config, corpus = (ps_serving_corpus if ps else he_serving_corpus)(
        1, seconds, chunk)
    per_stream = [corpus[0]] * n_streams
    n_frames = len(corpus[0]) // chunk * chunk

    def decoder():
        return BatchDecoder([config] * n_streams, chunk_frames=chunk,
                            cce_slots=1 if ps else 0, device=device)
    warm = decoder()
    warm.step_he_raw([p[:chunk] for p in per_stream], out_int16=True)

    vals = []
    t_reps0 = time.perf_counter()
    with timed():
        for rep in range(repeats):
            if rep and time.perf_counter() - t_reps0 > rep_budget_s:
                break
            dec = decoder()
            t1 = time.perf_counter()
            if pipelined and dec.use_native:
                it = ([p[lo:lo + chunk] for p in per_stream]
                      for lo in range(0, n_frames, chunk))
                for _pcm in dec.decode_he_pipelined(it, out_int16=True):
                    pass
            else:
                for lo in range(0, n_frames, chunk):
                    dec.step_he_raw([p[lo:lo + chunk] for p in per_stream],
                                    out_int16=True)
            wall = time.perf_counter() - t1
            audio_seconds = n_streams * n_frames * 2048 / 44100.0
            vals.append(round(audio_seconds / wall, 1))
    best = max(vals)
    label = ("HE-AAC v2 mono->stereo (SBR+PS)" if ps
             else "HE-AAC v1 stereo")
    stages = {}
    if warm.use_native:
        stages = measure_stages_he(warm, [p[:chunk] for p in per_stream], ps)
        chunk_audio_s = n_streams * chunk * 2048 / 44100.0
        stages["chunk_audio_s"] = round(chunk_audio_s, 2)
        dev = stages["core_compute_s"] + stages["sbr_compute_s"]
        stages["compute_realtime_x"] = (round(chunk_audio_s / dev, 1)
                                        if dev else None)
    return {
        "metric": ("he_aac_v2_aggregate_realtime_x" if ps
                   else "he_aac_aggregate_realtime_x"),
        "value": best,
        "median": _median(vals),
        "reps": vals,
        "unit": f"x_realtime ({n_streams} {label} streams, {_label(device)}, "
                "end-to-end incl. python host parse; reference has no SBR)",
        "device": card_info(device),
        **({"stages": stages} if stages else {}),
    }


def bench_encode(n_streams: int, seconds: float, chunk: int,
                 repeats: int, bitrate: int = 128_000,
                 rep_budget_s: float = 330.0, pipelined: bool = True,
                 device="cuda", timed=contextlib.nullcontext) -> dict:
    """Batched ENCODE throughput: the device analysis (MDCT, band energies,
    psy spread kernel, quantization trials, the rate-cost grid kernel over
    the offsets) and quantize, the host rate choice and bitstream write,
    through encode_pipelined unless pipelined=False.  The traffic is
    testing.encode_serving_pcm, bench_encode's construction.  `timed()` is
    entered around the timed reps alone, as in bench_lc."""
    from aacjax_torch.encode_batch import BatchEncoder
    from aacjax_torch.testing import encode_serving_pcm

    sr = 44100
    n = int(seconds * sr) // 1024 * 1024
    pcm = encode_serving_pcm(n_streams, n)

    def encoder():
        return BatchEncoder(sr, 2, bitrate, n_streams=n_streams,
                            device=device)
    warm = encoder()
    warm.encode_chunk(pcm[:, : chunk * 1024])

    vals = []
    stats, best_rt = None, 0.0
    n_chunks = n // (chunk * 1024)
    t_reps0 = time.perf_counter()
    with timed():
        for rep in range(repeats):
            if rep and time.perf_counter() - t_reps0 > rep_budget_s:
                break
            enc = encoder()
            t1 = time.perf_counter()
            total_bytes = 0
            chunks = (pcm[:, k * chunk * 1024:(k + 1) * chunk * 1024]
                      for k in range(n_chunks))
            outs = (enc.encode_pipelined(chunks) if pipelined
                    else map(enc.encode_chunk, chunks))
            for out in outs:
                total_bytes += sum(len(p) for o in out for p in o)
            wall = time.perf_counter() - t1
            audio_seconds = n_streams * n_chunks * chunk * 1024 / sr
            rt = audio_seconds / wall
            vals.append(round(rt, 1))
            if stats is None or rt > best_rt:   # the best rep's stage sums
                stats, best_rt = dict(enc.stats), rt
    best = max(vals)
    kbps = total_bytes * 8 / (n_chunks * chunk * 1024 / sr) / 1000 \
        / n_streams
    result = {
        "metric": "encode_aggregate_realtime_x",
        "value": best,
        "median": _median(vals),
        "reps": vals,
        "unit": f"x_realtime ({n_streams} AAC-LC stereo streams encoded "
                f"at ~{kbps:.0f} kbps, {_label(device)} device analysis + "
                "host bitstream write; reference has no encoder)",
        "device": card_info(device),
    }
    fr = max(stats.pop("frames"), 1)
    result["stages"] = {k: round(v, 6) for k, v in stats.items()}
    result["stages"]["frames"] = fr
    split = measure_stages_encode(warm, pcm[:, : chunk * 1024])
    chunk_audio_s = n_streams * chunk * 1024 / sr
    split["chunk_audio_s"] = round(chunk_audio_s, 2)
    dev = split["analysis_compute_s"] + split["quantize_compute_s"]
    split["compute_realtime_x"] = (round(chunk_audio_s / dev, 1)
                                   if dev else None)
    result["stages_split"] = split
    return result


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m aacjax_torch.bench",
        description="Aggregate decode / encode throughput on one CUDA card; "
                    "prints one JSON line.")
    ap.add_argument("--streams", type=int, default=512)
    # 8 s -> ~21 chunks a rep: the pipeline's fill and drain are < 5% of it
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--unique", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage breakdown pass")
    ap.add_argument("--no-compact", action="store_false", dest="compact",
                    help="transfer exact f32 spectra instead of per-row "
                         "int16 fixed point (compact halves H2D)")
    ap.add_argument("--no-pipelined", action="store_false", dest="pipelined",
                    help="disable the parse / device overlap (pipelined is "
                         "the default: the parse of chunk k+1 overlaps chunk "
                         "k's copies and device work)")
    ap.add_argument("--profile", metavar="LOGDIR", default=None,
                    help="write a torch.profiler trace (CPU and CUDA) of "
                         "the LC timed reps to LOGDIR/trace.json")
    ap.add_argument("--he", action="store_true",
                    help="benchmark the batched HE-AAC (SBR) pipeline "
                         "instead of AAC-LC")
    ap.add_argument("--ps", action="store_true",
                    help="with --he: HE-AAC v2 (Parametric Stereo) "
                         "mono->stereo streams")
    ap.add_argument("--encode", action="store_true",
                    help="benchmark the batched encoder instead of decode")
    ap.add_argument("--lc-only", action="store_true",
                    help="headline LC decode only (the default run adds "
                         "he / ps / encode sub-benches under the global "
                         "AACJAX_BENCH_BUDGET)")
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def _profiler(logdir, device):
    """A torch.profiler context over the timed reps, or None."""
    if not logdir:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def bench_lc(args, rep_budget_s: float = 330.0, device="cuda",
             timed=contextlib.nullcontext) -> dict:
    """The headline: args.streams AAC-LC stereo streams (make_corpus(
    args.unique, args.seconds), stream i replaying corpus i % unique) in
    chunks of args.chunk frames through decode_pipelined, int16 PCM out,
    best and median of args.repeats reps after a warm-up chunk, then one
    chunk's stage split and the pipeline's accounting against it.
    `timed()`, a context manager, is entered around the timed reps alone
    (not the warm-up or the stage split): what a caller counts or traces
    through it is what the reps ran."""
    from aacjax_torch.host import adts, native
    from aacjax_torch.runtime.batch import BatchDecoder

    t0 = time.perf_counter()
    config, corpus = make_corpus(args.unique, args.seconds)
    if args.verbose:
        print(f"# corpus: {args.unique} unique streams x {args.seconds}s "
              f"encoded in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    per_stream_payloads = []
    for i in range(args.streams):
        data = corpus[i % args.unique]
        frames = adts.split_frames(data)
        per_stream_payloads.append([data[s:e] for _, s, e in frames])
    n_frames = min(len(p) for p in per_stream_payloads)
    n_chunks = n_frames // args.chunk
    n_frames = n_chunks * args.chunk
    sr = config.sample_rate
    use_native = native.available() and not args.no_native
    if args.verbose:
        print(f"# native parser: {use_native}; {args.streams} streams x "
              f"{n_frames} frames, chunk={args.chunk}", file=sys.stderr)

    def decoder():
        return BatchDecoder([config] * args.streams, chunk_frames=args.chunk,
                            use_native=use_native, device=device)
    warm = decoder()
    warm.step_raw([p[:args.chunk] for p in per_stream_payloads],
                  out_int16=True, compact=args.compact)

    def chunks():
        for c in range(n_chunks):
            lo = c * args.chunk
            yield [p[lo:lo + args.chunk] for p in per_stream_payloads]

    prof = _profiler(args.profile, device)
    vals = []
    t_reps0 = time.perf_counter()
    with timed(), prof or contextlib.nullcontext():
        for rep in range(args.repeats):
            if rep and time.perf_counter() - t_reps0 > rep_budget_s:
                break
            dec = decoder()
            t1 = time.perf_counter()
            if use_native and args.pipelined:
                for _pcm in dec.decode_pipelined(chunks(), out_int16=True,
                                                 compact=args.compact):
                    pass
            else:
                pending = None
                for chunk in chunks():
                    pcm = dec.step_raw(chunk, out_int16=True,
                                       materialize=False,
                                       compact=args.compact)
                    if pending is not None:
                        dec.finalize_step(pending)
                    # the python route returns host PCM, finished already
                    pending = None if isinstance(pcm, np.ndarray) else pcm
                if pending is not None:
                    dec.finalize_step(pending)
            wall = time.perf_counter() - t1
            audio_seconds = args.streams * n_frames * 1024 / sr
            rt = audio_seconds / wall
            if args.verbose:
                print(f"# rep: {wall * 1e3:.0f} ms for {audio_seconds:.0f}s "
                      f"audio -> {rt:.0f}x", file=sys.stderr)
            vals.append(round(rt, 1))
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    best = max(vals)
    tail = ", CUDA tail kernel" if torch.device(device).type == "cuda" else ""
    result = {
        "metric": "aggregate_realtime_x",
        "value": best,
        "median": _median(vals),
        "reps": vals,
        "unit": f"x_realtime ({args.streams} AAC-LC stereo streams, "
                f"{_label(device)}, end-to-end incl. host parse + int16 PCM "
                f"D2H{', compact i16 H2D' if args.compact else ''}{tail})",
        "device": card_info(device),
    }
    if use_native and not args.no_stages:
        stages = measure_stages(warm, next(chunks()), args.compact)
        chunk_audio_s = args.streams * args.chunk * 1024 / sr
        stages["chunk_audio_s"] = round(chunk_audio_s, 2)
        stages["compute_realtime_x"] = (
            round(chunk_audio_s / stages["compute_s"], 1)
            if stages["compute_s"] else None)
        # the best rep's wall per chunk against two floors: the serial sum
        # of the stages and the overlapped floor, the slowest stage (each
        # copy direction has its own engine).  overlap_eff 1.0 = wall at
        # the overlapped floor, 0.0 = no overlap, < 0 = wall beyond even
        # the serial sum
        wall_chunk = audio_seconds / best / n_chunks
        ser = (stages["parse_s"] + stages["h2d_s"] + stages["compute_s"]
               + stages["d2h_s"])
        floor = max(stages["parse_s"], stages["h2d_s"], stages["compute_s"],
                    stages["d2h_s"])
        stages["wall_chunk_s"] = round(wall_chunk, 4)
        stages["serial_floor_s"] = round(ser, 4)
        stages["overlap_floor_s"] = round(floor, 4)
        stages["pipeline_overlap_eff"] = (
            round((ser - wall_chunk) / (ser - floor), 3)
            if ser - floor > 1e-9 else None)
        result["stages"] = stages
    return result


def budget_shares(budget: float, modes=MODES) -> dict:
    """Each mode's share of the global budget in seconds, fixed before any
    mode runs: equal parts."""
    return {m: budget / len(modes) for m in modes}


def run_modes(subs: dict, shares: dict) -> dict:
    """Each sub-bench `subs[name](rep_budget_s)` with its own share, in
    order.  A failure is recorded as {"error": ...} in its place (the
    artifact keeps the other modes)."""
    modes = {}
    for name, fn in subs.items():
        try:
            modes[name] = fn(shares[name])
        except Exception as e:  # noqa: BLE001 -- keep the artifact
            modes[name] = {"error": repr(e)}
    return modes


def main(argv=None) -> int:
    args = _parse_args(argv)
    if not torch.cuda.is_available():
        print("aacjax_torch.bench: no CUDA card (torch.cuda.is_available() "
              "is false); the benchmark runs on the card only",
              file=sys.stderr)
        return 1
    if args.encode:
        print(json.dumps(bench_encode(args.streams, args.seconds, args.chunk,
                                      args.repeats,
                                      pipelined=args.pipelined)))
        return 0
    if args.he or args.ps:
        print(json.dumps(bench_he(args.streams, args.seconds, args.chunk,
                                  args.repeats, ps=args.ps,
                                  pipelined=args.pipelined)))
        return 0
    if args.lc_only:
        print(json.dumps(bench_lc(args)))
        return 0
    shares = budget_shares(float(os.environ.get("AACJAX_BENCH_BUDGET",
                                                "900")))
    result = bench_lc(args, rep_budget_s=shares["lc"])
    # the sub-benches at the reference's sizes: HE and PS at 512 streams x
    # 4 s in chunks of 8, encode at 128 x 4 s, 2 reps each
    result["modes"] = run_modes({
        "he": lambda rb: bench_he(512, 4.0, 8, 2, ps=False, rep_budget_s=rb),
        "ps": lambda rb: bench_he(512, 4.0, 8, 2, ps=True, rep_budget_s=rb),
        "encode": lambda rb: bench_encode(128, 4.0, 8, 2, rep_budget_s=rb),
    }, shares)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
