#!/usr/bin/env python3
"""Where the rate-cost grid kernel spends its time, on one CUDA GPU.

    python3 scripts/enc_grid_variants.py

Builds variant copies of aacjax_torch/kernels/csrc/enc_scans.cu into
build/enc_grid_variants/ (nvcc, side by side), each with one change to the
kernel's pair loop, and times each variant's `aacjax_enc_rate_cost` on the
intermediates of one ENC-512 chunk (512 stereo streams of 16 frames at 44.1
kHz and 128 kbps: N = 16384, Pe = 544, nb = 36, K = 16) with CUDA events
over 200 back-to-back launches, three turns in alternating order:

  kernel        the kernel as it stands (bit-equal to rate_cost_ref);
  rows8         eight rows a block instead of four (bit-equal);
  two_loads     the odd bin's {scale} loaded apart even where both bins of
                every pair share a band (bit-equal);
  no_prefetch   a pair's t34 loaded when its turn comes, not one pair
                ahead (bit-equal);
  no_pair_load  the pair table's byte load replaced by an integer op on its
                index (wrong sums: an ablation of the shared-memory load);
  no_band_load  every lane reads one band's {scale, magic} for every pair
                (wrong sums: an ablation of the band table's loads);
  no_loads      both;
  no_pass       no pass over the pairs at all: the blocks' set-up, the band
                tables, the reductions and the stores alone (wrong sums).

Prints the card's name and power limit and one line per variant.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "enc_grid_variants"


def variants(src: str) -> dict:
    """Variant sources, by name; each replacement must find its anchor."""
    def sub(s, old, new):
        assert old in s, old
        return s.replace(old, new)

    pair = "acc[q] += pairs[c0 * CODES + c1 - CODE_BIAS];"
    band = "const float2 band = e0[q];"
    no_pair = sub(src, pair, "acc[q] += (c0 * CODES + c1) & 7;")
    passes = ("    if (same)\n"
              "      pair_pass<true>(acc, src, map, tab, pairs, P, lane);\n"
              "    else\n"
              "      pair_pass<false>(acc, src, map, tab, pairs, P, lane);\n")
    ahead = ("  float2 next = lane < P ? src[lane] : "
             "make_float2(0.0f, 0.0f);\n"
             "  for (int p = lane; p < P; p += 32) {\n"
             "    const float2 t = next;\n"
             "    if (p + 32 < P) next = src[p + 32];\n")
    return dict(
        kernel=src,
        rows8=sub(src, "constexpr int RC_WARPS = 4;",
                  "constexpr int RC_WARPS = 8;"),
        two_loads=sub(src, passes, "    pair_pass<false>(acc, src, map, tab, "
                      "pairs, P, lane);\n"),
        no_prefetch=sub(src, ahead, "  for (int p = lane; p < P; p += 32) {\n"
                        "    const float2 t = src[p];\n"),
        no_pair_load=no_pair,
        no_band_load=sub(src, band, "const float2 band = tab[q];"),
        no_loads=sub(no_pair, band, "const float2 band = tab[q];"),
        no_pass=sub(src, passes, ""))


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    import aacjax_torch
    import chip_smoke as smoke
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import _build
    from aacjax_torch.kernels import enc_scans as ES

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "enc_scans.cu").read_text()
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variants(src).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        for line in smoke.ptxas_lines(log):
            if "rate_cost" in line:
                print(f"{name}: {line}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).aacjax_enc_rate_cost
        fn.argtypes = _build._SIGNATURES["aacjax_enc_rate_cost"]
        fns[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())

    dev = torch.device("cuda")
    enc = aacjax_torch.BatchEncoder(44100, 2, smoke.ENC_BITRATE,
                                    n_streams=smoke.ENC_STREAMS)
    pcm = TI.encode_serving_pcm(smoke.ENC_STREAMS, smoke.ENC_CHUNK * 1024)
    seen, _ = TI.enc_scans_inputs(enc, pcm, dev)
    args = seen["rate_cost"][0]
    t34, is_short, regions, base, fit, zero, offsets = args
    region = torch.where(is_short[:, None], regions[1], regions[0])
    c = ES._constants(offsets, dev)
    want = ES.rate_cost_ref(t34, region, base, fit, zero, c["lut"], offsets)
    (N, Pe), nb, K = t34.shape, base.shape[1], len(offsets)

    def launch(fn, est):
        err = fn(t34.data_ptr(), is_short.data_ptr(), regions.data_ptr(),
                 base.data_ptr(), fit.data_ptr(), zero.data_ptr(),
                 c["pairs"].data_ptr(), c["exp2"].data_ptr(),
                 c["offsets"].data_ptr(), est.data_ptr(), N, Pe, nb, K,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")

    times = {name: [] for name in fns}
    exact = {}
    for turn in range(3):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            est = torch.empty_like(want)
            launch(fns[name], est)
            torch.cuda.synchronize()
            exact[name] = bool(torch.equal(est.view(torch.int32),
                                           want.view(torch.int32)))
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(200):
                launch(fns[name], est)
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / 200)
    for name in ("kernel", "rows8", "two_loads", "no_prefetch"):
        if not exact[name]:
            sys.exit(f"{name}: differs from rate_cost_ref")
    for name, ts in times.items():
        what = ("bit-equal to rate_cost_ref" if exact[name]
                else "an ablation: sums wrong")
        print(f"{name}: " + " / ".join(f"{t:.4f}" for t in ts)
              + f" ms a call ({what})")


if __name__ == "__main__":
    main()
