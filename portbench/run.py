"""Run one cell of the port's benchmark on the card and print one JSON line.

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (BENCHMARK.json `workloads`) names
a configuration and a traffic mix; portbench/registry.py finds their files,
the route that drives the program (`aacjax_torch`) and a reader per metric.

A run: load the frozen corpus (hashes checked); give each slot a (stream,
start frame) from the seed; warm every compiled variant of the program the
window's chunks can reach on a throwaway decoder; then a closed loop on a
fresh decoder through the program's serving entry: the iterator hands each
chunk over as soon as the program asks.  The first `warmup_chunks` chunks
are set-up; the window opens when the last of them reaches the host and
lasts `--seconds`.  With `--trace 1` spans wrap the program's layers and
torch.profiler traces the whole window, and the line carries the
per-layer metrics; with `--trace 0` it carries the end-to-end ones.  Once
the window has closed and the device's peak memory is read, the program is
freed and the reference (portbench/reference) checks a sample of what the
window yielded (portbench/check.py); each number compared is printed
beside its limit, last in the line and as the last lines of stderr.  The
line's `wall` gives the run's parts on the host clock: set-up, the serving
loop from the window's opening to its end, and the check.

Without a CUDA card (or with fewer than the cell asks for), and where
jax, jaxlib, flax or aacjax is loaded once the window has closed, it exits
non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import numpy as np  # noqa: E402

from portbench import registry  # noqa: E402
from portbench.check import Check  # noqa: E402
from portbench.corpus import Feed, assign_slots, load  # noqa: E402
from portbench.trace import Tracer, breakdown  # noqa: E402
from portbench.window import Window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "aacjax")


@dataclass
class Run:
    """What the metric readers read: the cell, its window, its feed and,
    in a traced run, its spans and reduced trace."""
    cell: registry.Cell
    window: Window
    feed: Feed
    setup_s: float
    tracer: Tracer | None

    @property
    def profile(self):
        return self.tracer.profile if self.tracer else None

    def host_s(self, name: str) -> list[float]:
        if self.tracer is None or self.window.t_open is None:
            return []
        return self.tracer.host_s(name, self.window.t_open,
                                  self.window.t_close)

    def counted(self, name: str) -> int | None:
        return self.tracer.counted(name) if self.tracer else None

    def device_s(self, name: str) -> list[float]:
        if self.tracer is None or self.window.t_open is None:
            return []
        return self.tracer.device_s(name, self.window.t_open,
                                    self.window.t_close)

    def frame_share(self, flag: int) -> float:
        """The share of the window's slot-frames whose corpus flags hold
        `flag`."""
        ks = self.window.chunks()
        if not ks:
            return 0.0
        fl = self.feed.corpus.flags
        hit = n = 0
        for s, start in self.feed.slots:
            idx = (start + np.arange(ks[0] * self.feed.T,
                                     (ks[-1] + 1) * self.feed.T))
            f = fl[s][idx % len(fl[s])]
            hit += int((f & flag != 0).sum())
            n += f.size
        return hit / n


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else "not read"


def _graphs() -> int:
    from aacjax_torch.runtime import graphs
    return len(graphs.entries())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tamper=None, control: str | None = None,
             workers: int | None = None, t_start: float | None = None,
             log=None, traffic: dict | None = None) -> tuple[dict, dict]:
    """One run of cell `name`.  Returns (the result line, the readings).
    `tamper(decoder, serve) -> serve` replaces the program's serving
    entry (the tests' planted faults); `control` (a reference precision)
    puts the reference in that precision in the program's place in the
    check; `traffic` overrides keys of the cell's traffic (the CPU tests'
    sizes).  The caller checks for a card."""
    import torch
    t_start = T_START if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = registry.cell(registry.benchmark(), name)
    cell.traffic = {**cell.traffic, **(traffic or {})}
    cfg, traffic, route = cell.config, cell.traffic, cell.route
    cuda = torch.device(device).type == "cuda"
    T, W = traffic["chunk_frames"], traffic["warmup_chunks"]
    n_slots = traffic["streams"]

    corpus = load(cfg, registry.ROOT)
    slots = assign_slots(seed, [len(p) for p in corpus.payloads], n_slots,
                         traffic["spacing_chunks"] * T)
    feed = Feed(corpus, slots, T)

    # every compiled variant the window's chunks can reach, each from the
    # first chunk that needs it, on a throwaway decoder of the same shape
    n_max = W + 2 + math.ceil(seconds * traffic["max_chunks_per_s"])
    keys = feed.chunk_flags(0, n_max) & route.KEY_FLAGS
    firsts = [int(np.flatnonzero(keys == v)[0]) for v in np.unique(keys)]
    warm = route.decoder(cell, device)
    for _ in route.serve(warm, (feed.chunk(k) for k in firsts)):
        pass
    del warm

    dec = route.decoder(cell, device)
    serve = route.serve if tamper is None else tamper(dec, route.serve)
    check = Check(route.CHECK, seed, feed, cfg, traffic["check"],
                  corpus.files, route.SBR, rows=getattr(route, "ROWS", None),
                  out_channels=getattr(route, "OUT_CHANNELS", None))
    tracer = Tracer(cuda) if trace else None
    if tracer:
        route.instrument(dec, tracer)
    chunk_audio = n_slots * T * route.OUT_SAMPLES / cfg["output_rate"]
    win = Window(seconds, chunk_audio, W, handed=feed.handed)
    setup_s = captured = None
    if tracer:
        tracer.start_profile()
    for k, pcm in enumerate(serve(dec, iter(feed))):
        closed = win.record(time.perf_counter())
        check.keep(k, pcm)
        if k == W - 1:
            setup_s = win.t_open - t_start
            captured = _graphs()
            if tracer:
                tracer.mark()
        if closed:
            feed.stop()
            if tracer and tracer.profiling:
                tracer.stop_profile()
    if tracer and tracer.profiling:
        tracer.stop_profile()
    if cuda:
        torch.cuda.synchronize()
    t_served = time.perf_counter()
    window = win.chunks()
    log(f"portbench: {name} seed {seed}: set-up {setup_s:.3f} s, "
        f"{len(window)} chunks in the window, {len(win.done)} decoded")
    if tracer and tracer.counters:
        log("portbench: counted over the window: " + ", ".join(
            f"{n} {tracer.counted(n)}" for n in sorted(tracer.counters)))
    if captured is not None and _graphs() != captured:
        log(f"portbench: {_graphs() - captured} program(s) captured after "
            "the window opened")

    run = Run(cell, win, feed, setup_s, tracer)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = registry.metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed_slots = sum(st.failed for st in dec.streams)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(torch.device(device))
                         if cuda else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                    torch.device(device)) if cuda else 0)}
    if cuda:
        dev_info["power_limit"] = power_limit()
    if trace and tracer.profile is not None:
        dev_info["busy_s"] = tracer.profile.busy_s
        dev_info["window_s"] = tracer.profile.window_s
    bd = breakdown(tracer) if tracer else None

    del dec, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check.run(window, control=control, workers=workers)
    ok, shown = check.verdict(readings)
    check_s = time.perf_counter() - t_check
    log(f"portbench: the check compared {readings.get('compared_chunks')} "
        f"chunks in {check_s:.1f} s")
    attempted = len(window) * n_slots
    failed = failed_slots * len(window)
    result = {"correct": bool(ok and failed == 0 and attempted > 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if bd is not None:
        result["breakdown"] = bd
    result["wall"] = {
        "setup_s": setup_s,
        "window_s": (None if win.t_open is None else t_served - win.t_open),
        "check_s": check_s}
    result["compared"] = shown
    return result, readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    chips = registry.cell(registry.benchmark(), args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded in the process; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
