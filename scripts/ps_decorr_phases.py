#!/usr/bin/env python3
"""Where a tile's time goes inside the fused PS decorrelator, on one CUDA GPU.

    python3 scripts/ps_decorr_phases.py

Builds a copy of `aacjax_torch/kernels/csrc/ps_decorr.cu` into
`build/ps_decorr_phases/` with clock64() stamps at the boundaries of a
tile's phases, runs it at PS-512's chunk shape (C = 1024 rows, S = 256
slots) in both band modes on `ps_decorr_inputs`, checks that it still
equals the plain version bit for bit, and prints the mean cycles a tile
spends in each phase, for two threads: detector thread 0 (the power sums,
then the detector's recurrences) and allpass thread 0 (the allpass walk).
The phases, in order:

    wait     the tile's bulk copy (mbarrier wait)
    sums     the power sums of this thread's warp (detector thread only)
    sumsync  the named barrier of the summing warps (detector thread only)
    walk     the detector's recurrences, or the allpass walk
    sync1    the block barrier after the walks
    gains    the quotients and the block barrier after them
    half1    d's rows 0..15 and the block barrier
    half2    d's rows 16..31 and the block barrier
    issue    the bulk copies out and the next tile's copy in (thread 0)

The stamps are the anchors below in the kernel's source: change them with
the kernel.  The stamps themselves cost a few percent of the kernel's time,
printed beside the cycles.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PHASES = ("wait", "sums", "sumsync", "walk", "sync1", "gains", "half1",
          "half2", "issue")
# (source text, the same with a stamp); stamp i closes phase i - 1
ANCHORS = [
    ("  for (int t = 0; t < ntiles; ++t) {\n",
     "  long long stamp = clock64();\n"
     "  for (int t = 0; t < ntiles; ++t) {\n    STAMP(0);\n"),
    ("& 1u);\n\n    if (in_ap) {", "& 1u);\n    STAMP(1);\n\n    if (in_ap) {"),
    ("      sync_sums(32 * sum_warps);\n",
     "      STAMP(2);\n      sync_sums(32 * sum_warps);\n      STAMP(3);\n"),
    ("    __syncthreads();\n\n    // 2. the gains",
     "    STAMP(4);\n    __syncthreads();\n    STAMP(5);\n\n    // 2. the gains"),
    ("    __syncthreads();\n\n    // 3. d for the tile",
     "    __syncthreads();\n    STAMP(6);\n\n    // 3. d for the tile"),
    ("    __syncthreads();\n    // thread 0: d leaves",
     "    __syncthreads();\n    STAMP(7);\n    // thread 0: d leaves"),
    ("    d_rows(HALF);\n    asm volatile(\"fence.proxy.async.shared::cta;\" "
     "::: \"memory\");\n    __syncthreads();\n",
     "    d_rows(HALF);\n    asm volatile(\"fence.proxy.async.shared::cta;\" "
     "::: \"memory\");\n    __syncthreads();\n    STAMP(8);\n"),
    ("          s_i + row + next * plane, plane);\n    }\n  }\n",
     "          s_i + row + next * plane, plane);\n    }\n    STAMP(9);\n  }\n"),
]
STAMPS = '''
__device__ unsigned long long g_cycles[2][16];
#define STAMP(i) do { if ((is_det && tid == 0) || (is_ap && k_ap == 0)) { \\
  const long long now = clock64(); \\
  if (i > 0) atomicAdd(&g_cycles[is_ap][(i) - 1], \\
                       static_cast<unsigned long long>(now - stamp)); \\
  stamp = now; } } while (0)
'''
ACCESS = '''
extern "C" void cycles_get(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
extern "C" void cycles_zero() {
  static const unsigned long long zero[32] = {0};
  cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero));
}
'''


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    import chip_smoke as CS
    from aacjax_torch import testing as TI
    from aacjax_torch.kernels import _build
    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import ps_decorr as D

    src = (_build.CSRC / "ps_decorr.cu").read_text()
    for old, new in ANCHORS:
        if src.count(old) != 1:
            sys.exit(f"anchor not found once in ps_decorr.cu: {old!r}")
        src = src.replace(old, new)
    src = src.replace("namespace {\n", "namespace {\n" + STAMPS, 1) + ACCESS
    out = REPO / "build" / "ps_decorr_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ps_decorr_phases.cu").write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out / "lib.so"), str(out / "ps_decorr_phases.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    fn = lib.aacjax_ps_decorrelate
    fn.argtypes = _build._SIGNATURES["aacjax_ps_decorrelate"]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    B, S = 2 * CS.N_STREAMS, 32 * CS.HE_CHUNK
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for is34 in (False, True):
        s_r, s_i, st = TI.ps_decorr_inputs(3 + is34, B, S, is34)
        s_r, s_i = (torch.from_numpy(a).to(dev) for a in (s_r, s_i))
        st = {k: torch.from_numpy(v).to(dev) for k, v in st.items()}
        c, sdb = PB._consts(is34, dev), PB._SDB[is34]
        npar, M = c["members"].shape
        d_r, d_i = torch.empty_like(s_r), torch.empty_like(s_i)
        new = {k: torch.empty_like(st[k]) for k in D.STATE_KEYS}
        args = ([s_r.data_ptr(), s_i.data_ptr()]
                + [st[k].data_ptr() for k in D.STATE_KEYS]
                + [c[k].data_ptr() for k in D.CONST_KEYS]
                + [d_r.data_ptr(), d_i.data_ptr()]
                + [new[k].data_ptr() for k in D.STATE_KEYS]
                + [B, S, s_r.shape[2], npar, c["phi_r"].shape[0], sdb, M,
                   torch.cuda.current_stream(dev).cuda_stream])

        def run():
            if fn(*args):
                raise RuntimeError("launch failed")
        lib.cycles_zero()
        run()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 32)()
        lib.cycles_get(cycles)
        want = D.decorrelate_chunk_ref(s_r, s_i, st, c, sdb)
        same = (torch.equal(d_r, want[0]) and torch.equal(d_i, want[1])
                and all(torch.equal(new[k], want[2][k])
                        for k in D.STATE_KEYS))
        ms = CS.time_ms(torch, run, reps=CS.REPS)
        base = CS.time_ms(torch, lambda: D.decorrelate_chunk(s_r, s_i, st, c,
                                                             sdb), reps=CS.REPS)
        tiles = B * S // 32
        mode = f"{npar}-band"
        print(f"{mode}: stamped {ms:.4f} ms a call, unstamped {base:.4f} ms; "
              f"bit-equal to the plain version: {same}", flush=True)
        for who, name in ((0, "detector thread 0"), (1, "allpass thread 0")):
            per = [cycles[16 * who + i] / tiles for i in range(len(PHASES))]
            print(f"{mode} {name}: cycles a tile: " + ", ".join(
                f"{p} {v:.0f}" for p, v in zip(PHASES, per))
                + f"; total {sum(per):.0f}", flush=True)
        if not same:
            sys.exit("the stamped kernel differs from the plain version")


if __name__ == "__main__":
    main()
