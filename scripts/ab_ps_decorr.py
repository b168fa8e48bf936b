#!/usr/bin/env python3
"""Time the PS decorrelation of one tree of the port on one CUDA GPU.

    python3 scripts/ab_ps_decorr.py --tree DIR

DIR holds the `aacjax_torch` under test (this repository's root, or an
archive of another commit).  The inputs and the timing helpers always come
from the repository this script lies in, so that two trees are read on the
same data: `scripts/ab_ps_decorr.sh PARENT_TREE` runs parent, change,
change, parent in one call.  Printed, one line each, tagged with the tree:

  - `ps_batch._decorrelate` at C = 1024 rows, T = 8 frames (S = 256 slots,
    PS-512's chunk) in the 20-band and the 34-band mode, from hybrid
    planes and a carried state (`ps_decorr_inputs`): ms per call (CUDA
    events, median of 20 runs of 10 back-to-back calls), the device time of
    every kernel it launches per call and their count (torch.profiler), and
    sum|d| (two trees that compute the same function print it alike, to
    float rounding);
  - one `sbr_ps_apply` at PS-512's chunk shape (512 mono streams with their
    pairs, C = 1024, T = 8, int16 out): ms per call (CUDA events, median of
    10) and its device time per call.
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


def device_per_call(torch, fn, reps: int) -> tuple[float, float]:
    """The summed device time (ms) and the number of kernels per call of
    `reps` calls in a torch.profiler trace, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if (getattr(e, "device_time_total", 0.0) or 0.0) > 0]
    total = sum(e.device_time_total for e in evs)
    return total / reps / 1e3, sum(e.count for e in evs) / reps


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
    from aacjax_torch.kernels import ps_batch as PB
    if pathlib.Path(aacjax_torch.__file__).resolve().parents[1] != tree:
        sys.exit(f"aacjax_torch was not imported from {tree}")
    dev = torch.device("cuda")
    tag = f"[{tree.name or tree}]"
    B, S = 2 * CS.N_STREAMS, 32 * CS.HE_CHUNK

    for is34 in (False, True):
        s_r, s_i, st = gen.ps_decorr_inputs(3 + is34, B, S, is34)
        s_r, s_i = (torch.from_numpy(a).to(dev) for a in (s_r, s_i))
        st = {k: torch.from_numpy(v).to(dev) for k, v in st.items()}
        c = PB._consts(is34, dev)

        def run():
            return PB._decorrelate(s_r, s_i, st, c, is34)
        d_r, d_i, _ = run()
        torch.cuda.synchronize()
        ms = CS.time_ms(torch, run, reps=CS.REPS)
        dms, n = device_per_call(torch, run, CS.REPS)
        print(f"{tag} _decorrelate B={B} S={S} {20 + 14 * is34}-band: "
              f"{ms:.4f} ms per call, device {dms:.4f} ms over {n:.0f} "
              f"kernels a call; sum|d| "
              f"{float(d_r.double().abs().sum() + d_i.double().abs().sum())!r}",
              flush=True)

    core, planes, ps, cfg, state, ps_state = gen.sbr_ps_apply_inputs(
        CS.N_STREAMS, CS.HE_CHUNK, dev)

    def chunk():
        return PB.sbr_ps_apply(core, planes, ps, state, ps_state, cfg, True)
    ms = CS.time_ms(torch, chunk, runs=10)
    dms, n = device_per_call(torch, chunk, 3)
    print(f"{tag} sbr_ps_apply C={B} T={CS.HE_CHUNK} int16: {ms:.4f} ms per "
          f"call, device {dms:.4f} ms over {n:.0f} kernels a call", flush=True)


if __name__ == "__main__":
    main()
