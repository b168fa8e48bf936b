#!/usr/bin/env python3
"""Each hand-written CUDA kernel of the port at the main path's shapes, its
time per call on one card against its bound.

    python3 scripts/kernel_times.py

One row a (kernel, shape): the kernel's wrapper and its plain PyTorch twin
on the same inputs from aacjax_torch.testing, and the bytes and FP32
operations the call needs, computed from its shape and inputs (each input
byte read once, each output byte written once).  The kernel's time is the
median over 20 runs of CUDA events around 10 back-to-back calls, after a
warm-up call; the twin's is one call after a warm-up call (the plain TNS
and decorrelator are Python loops that take seconds).  The bound is portbench.roofline.bound_s:
the larger of the bytes over the HBM rate and the operations over the
FP32 peak.  Whether a kernel is right is the card tests' job
(tests/test_torch_cuda.py), not this script's.  Needs a CUDA card; prints
its name and power limit, then one line a row.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from aacjax_torch import testing as TI  # noqa: E402
from aacjax_torch.kernels import enc_scans as ES  # noqa: E402
from aacjax_torch.kernels import pred, ps_decorr, synth, tail, tns  # noqa: E402
from portbench import roofline  # noqa: E402

RUNS, REPS = 20, 10
DEV = torch.device("cuda")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def on_card(arrays) -> list:
    return [None if a is None else torch.from_numpy(a).to(DEV) for a in arrays]


def filterbank_flops(is_short, per_sample: int) -> float:
    """The FFT IMDCT of every frame plus `per_sample` operations per output
    sample (decompression, windows, overlap-adds, concealment, scale)."""
    n_short = int((np.asarray(is_short) != 0).sum())
    n = np.asarray(is_short).size
    return ((n - n_short) * roofline.FFT_FLOPS[False]
            + n_short * roofline.FFT_FLOPS[True] + n * 1024 * per_sample)


def tns_flops(planes) -> float:
    """Per bin inside a filter's region, `order` compensated multiply-adds
    (TwoProd + TwoSum, ~20 operations each) and the closing TwoSums (~13)."""
    total = 0.0
    for d in (0, 3):                   # forward, reverse
        lpc, start, end = (np.asarray(a.cpu()) for a in planes[1 + d:4 + d])
        nz = lpc != 0
        order = np.where(nz.any(-1), 20 - np.argmax(nz[..., ::-1], -1), 0)
        span = np.maximum(end - start, 0)
        total += float((span * (20 * order + 13) * (order > 0)).sum())
    return total


def tail_rows():
    # spectra scaled so that the PCM spans ~+-5000, inside the int16 range
    for label, C, T, i16, out16, short in (
            ("C=1024 T=16 i16->int16 all-long", 1024, 16, True, True, False),
            ("C=1024 T=16 f32->int16 1/4 short", 1024, 16, False, True, True),
            ("C=8 T=64 f32->f32 ragged", 8, 64, False, False, True)):
        b = TI.random_tail_chunk(len(label), C, T, i16=i16, has_short=short,
                                 ragged=C < 64, amp=3000.0)
        args = on_card(b[k] for k in TI.TAIL_ARGS)
        kw = dict(out_int16=out16, has_short=short)
        share = float((b["is_short"] != 0).mean())
        yield ("tail", label, lambda a=args, k=kw: tail.decode_tail(*a, **k),
               lambda a=args, k=kw: tail.decode_tail_ref(*a, **k),
               roofline.tail_bytes(C, T, i16, out16),
               roofline.tail_flops(C, T, share, i16))


def synthesis_rows():
    for B in (16384, 256):
        np_args = TI.random_synth_batch(4, B)
        args = on_card(np_args)
        out = 2 * B * 1024 * 4                          # the two halves
        yield ("synthesis", f"B={B}", lambda a=args: synth.synthesis(*a),
               lambda a=args: synth.synthesis_ref(*a),
               nbytes(*args) + roofline.TAIL_TABLE_BYTES + out,
               filterbank_flops(np_args[5], 2))


def tns_rows():
    args = on_card(TI.serving_tns_chunk(7, 1024, 16))
    q, sc, lpc, rng = args
    planes = (None, lpc[:, :, 0], rng[:, :, 0, :, 0], rng[:, :, 0, :, 1],
              lpc[:, :, 1], rng[:, :, 1, :, 0], rng[:, :, 1, :, 1])
    yield ("tns", "16384 rows serving mix, i16 + packed planes",
           lambda: tns.tns_packed(*args), lambda: tns.tns_packed_ref(*args),
           nbytes(*args) + q.numel() * 4, tns_flops(planes))
    for C, T in ((4, 64), (256, 16), (1024, 16)):
        args = on_card(TI.random_tns_chunk(5 + C, C, T))
        yield ("tns", f"{C * T} rows orders 2/12/20, both directions",
               lambda a=args: tns.tns(*a), lambda a=args: tns.tns_ref(*a),
               nbytes(*args) + args[0].numel() * 4, tns_flops(args))


def pred_rows():
    for C, T in ((1024, 16), (8, 64)):
        args = on_card(TI.pred_chunk(C, C, T))
        spec, mode, reset, nbins, used = args
        state = pred.pred_state_init(C, DEV)
        work = spec.clone()     # in place, as the main path calls it
        # the 672 predicted bins read and written, `used`, the three planes,
        # the state in and out; ~9 operations a (channel, frame, bin) for
        # the prediction, ~23 more where the state moves
        kk = torch.arange(672, device=DEV)
        n_upd = int(((mode == 1)[..., None] & (kk < nbins[..., None])).sum())
        yield ("pred", f"C={C} T={T} every mode, resets",
               lambda a=args, w=work, s=state: pred.apply_prediction(
                   w, *a[1:], s, inplace=True),
               lambda a=args, s=state: pred.apply_prediction_ref(*a, s),
               2 * C * T * 672 * 4 + nbytes(used, mode, reset, nbins)
               + 2 * nbytes(state),
               9.0 * C * T * 672 + 23.0 * n_upd)


def ps_decorr_rows():
    from aacjax_torch.kernels import ps_batch as PB
    B, S = 1024, 256
    for is34 in (False, True):
        nb, npar, nap = PB._NB[is34], PB._NPAR[is34], PB._NAP[is34]
        s_r, s_i, st = TI.ps_decorr_inputs(3 + is34, B, S, is34)
        s_r, s_i = on_card((s_r, s_i))
        st = {k: torch.from_numpy(v).to(DEV) for k, v in st.items()}
        c, sdb = PB._consts(is34, DEV), PB._SDB[is34]
        # s in and d out [B, S, nb] complex, the state (delay lines, allpass
        # lines, detector) in and out; per (slot, band) 5 operations, per
        # (slot, parameter band) ~10, per (slot, allpass band) 48
        state = 2 * nb * 14 + 2 * nap * 15 + 3 * npar
        yield ("ps_decorr", f"C={B} S={S} {npar}-band",
               lambda x=(s_r, s_i, st, c, sdb):
                   ps_decorr.decorrelate_chunk(*x),
               lambda x=(s_r, s_i, st, c, sdb):
                   ps_decorr.decorrelate_chunk_ref(*x),
               4 * B * (4 * S * nb + 2 * state),
               float(B * S * (5 * nb + 10 * npar + 48 * nap)))


def enc_rows():
    """On the intermediates of one ENC-512 chunk (512 stereo streams of 16
    frames at 44.1 kHz and 128 kbps: N = 16384, nb = 36, Pe = 544, K =
    16) through the eager analysis program."""
    import aacjax_torch
    enc = aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=512,
                                    device=DEV)
    seen, _ = TI.enc_scans_inputs(enc, TI.encode_serving_pcm(512, 16 * 1024),
                                  DEV)
    sp = seen["spread"][0]
    rc = seen["rate_cost"][0]
    t34, is_short, regions, base, fit_sf, zero_sf, offsets = rc
    region = torch.where(is_short[:, None], regions[1], regions[0])
    lut = ES._constants(offsets, DEV)["lut"]
    (N, nb), Pe, K = base.shape, t34.shape[1], len(offsets)
    # e in, the spread out; two maxima, two products and the smr product
    yield ("enc_spread", f"N={N} nb={nb}", lambda: ES.spread(*sp),
           lambda: ES.spread_ref(*sp), 2 * N * nb * 4, 5.0 * N * nb)
    # t34, the row flags, the maps, three band planes and the tables in, est
    # out; ~12 operations a bin and offset, 4 a band and offset
    yield ("enc_rate_cost", f"N={N} Pe={Pe} nb={nb} K={K}",
           lambda: ES.rate_cost(*rc),
           lambda: ES.rate_cost_ref(t34, region, base, fit_sf, zero_sf, lut,
                                    offsets),
           nbytes(t34, is_short, regions, base, fit_sf, zero_sf, lut)
           + 4 * N * K + 4 * (256 + K),
           12.0 * N * Pe * K + 4.0 * N * (nb + 1) * K)


def events_ms(fn, reps: int) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"{'kernel':<14} {'shape':<45} {'ms':>8} {'bound ms':>9} "
          f"{'by':<10} {'share':>6} {'plain ms':>10}", flush=True)
    for rows in (tail_rows, synthesis_rows, tns_rows, pred_rows,
                 ps_decorr_rows, enc_rows):
        for name, shape, kernel, twin, moved, flops in rows():
            kernel()
            torch.cuda.synchronize()
            ms = float(np.median([events_ms(kernel, REPS)
                                  for _ in range(RUNS)]))
            twin()
            plain = events_ms(twin, 1)
            bound_s, by = roofline.bound_s(moved, flops)
            print(f"{name:<14} {shape:<45} {ms:8.4f} {bound_s * 1e3:9.4f} "
                  f"{by:<10} {bound_s * 1e3 / ms:6.1%} {plain:10.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
