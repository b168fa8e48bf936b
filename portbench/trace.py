"""The traced run's instruments, all in the benchmark's own files: host
spans around the calls into the program's layers, CUDA-event spans on the
stream a layer's device work runs on, and a torch.profiler trace of the
window reduced to the device's busy time, its
operations and its idle gaps.  Nothing inside the program changes: a span
wraps a method of the one decoder object the run drives."""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np

MARK = "portbench.traced"
NAME_CHARS = 160     # a device operation's name in the breakdown, cut there


@dataclass
class Profile:
    """A reduced trace: the traced stretch in the profiler's clock, the
    device's activity inside it, and the host's clock at its start."""
    window_s: float
    busy_s: float
    ops: dict                    # name -> [durations, s] inside the stretch
    whole: dict                  # name -> [durations, s] of ops wholly in it
    gaps: list                   # (start s from the stretch's start, length)
    t_host0: float               # perf_counter at the stretch's start


@dataclass
class Tracer:
    cuda: bool
    spans: list = field(default_factory=list)    # (name, t0, t1), any thread
    dev: list = field(default_factory=list)      # (name, t0, ev0, ev1)
    counters: dict = field(default_factory=dict)  # name -> [read, at open, at close]
    profile: Profile | None = None

    def wrap(self, obj, attr: str, name: str) -> None:
        """A host span around every call of obj.attr."""
        fn = getattr(obj, attr)
        spans = self.spans

        def spanned(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans.append((name, t0, time.perf_counter()))
        setattr(obj, attr, spanned)

    def wrap_device(self, obj, attr: str, name: str, stream) -> None:
        """CUDA events recorded on `stream` before and after every call of
        obj.attr: the device time of the work the call enqueues there
        (after what the stream already holds).  Without CUDA, the host
        clock."""
        if not self.cuda:
            return self.wrap(obj, attr, name)
        import torch
        fn = getattr(obj, attr)
        dev = self.dev

        def spanned(*args, **kw):
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            try:
                return fn(*args, **kw)
            finally:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record(stream)
                dev.append((name, t0, e0, e1))
        setattr(obj, attr, spanned)

    def count(self, name: str, read) -> None:
        """A counter of the program's: `read()` gives its running total,
        read when the window opens (`mark`) and when it closes
        (`stop_profile`)."""
        self.counters[name] = [read, None, None]

    def counted(self, name: str) -> int | None:
        """The counter's growth over the window."""
        c = self.counters.get(name)
        if c is None or c[1] is None or c[2] is None:
            return None
        return c[2] - c[1]

    def _read_counters(self, at: int) -> None:
        for c in self.counters.values():
            c[at] = c[0]()

    def host_s(self, name: str, t_lo: float, t_hi: float) -> list[float]:
        """The durations of `name`'s spans that started in [t_lo, t_hi]."""
        return [t1 - t0 for n, t0, t1 in list(self.spans)
                if n == name and t_lo <= t0 <= t_hi]

    def device_s(self, name: str, t_lo: float, t_hi: float) -> list[float]:
        """The device seconds of `name`'s spans that started in [t_lo,
        t_hi] (their events must have completed)."""
        if not self.cuda:
            return self.host_s(name, t_lo, t_hi)
        return [e0.elapsed_time(e1) / 1e3 for n, t0, e0, e1 in list(self.dev)
                if n == name and t_lo <= t0 <= t_hi]

    def open_at(self, times: np.ndarray) -> list[str]:
        """For each host time, the names of the spans open then ("none").
        The spans of one name follow each other (one thread calls them)."""
        by_name = collections.defaultdict(list)
        for n, t0, t1 in list(self.spans):
            by_name[n].append((t0, t1))
        labels = [[] for _ in times]
        for n in sorted(by_name):
            iv = np.array(sorted(by_name[n]))
            i = np.searchsorted(iv[:, 0], times, side="right") - 1
            hit = (i >= 0) & (iv[np.maximum(i, 0), 1] >= times)
            for j in np.flatnonzero(hit):
                labels[j].append(n)
        return ["+".join(x) or "none" for x in labels]

    # -- the profiler ---------------------------------------------------------
    def start_profile(self) -> None:
        """Start the profiler (its first start sets up CUPTI, which takes
        seconds: call it before the stretch to trace)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def mark(self) -> None:
        """Open the traced stretch: the MARK range on this thread."""
        import torch
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self._t_host0 = time.perf_counter()
        self._read_counters(1)

    @property
    def profiling(self) -> bool:
        return getattr(self, "_prof", None) is not None

    def stop_profile(self) -> None:
        """Close the stretch and reduce its trace (no stretch was opened:
        no profile)."""
        mark, self._mark = getattr(self, "_mark", None), None
        if mark is not None:
            mark.__exit__(None, None, None)
            self._read_counters(2)
        self._prof.stop()
        if mark is not None:
            self.profile = reduce(
                self._prof.profiler.kineto_results.events(), self._t_host0)
        self._prof = None


def reduce(events, t_host0: float) -> Profile:
    """The device's activity inside the MARK range: the union of its
    operations' intervals (kernels, copies, sets) clipped to the range,
    their time by name, and the gaps between them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e for e in events if e.name() == MARK]
    if not mark:
        raise RuntimeError(f"the trace holds no {MARK} range")
    w0 = mark[0].start_ns()
    w1 = w0 + mark[0].duration_ns()
    iv = []
    ops = collections.defaultdict(list)
    whole = collections.defaultdict(list)
    for e in events:
        if e.device_type() != cuda:
            continue
        s0, s1 = e.start_ns(), e.start_ns() + e.duration_ns()
        a, b = max(s0, w0), min(s1, w1)
        if b > a:
            iv.append((a, b))
            ops[e.name()].append((b - a) / 1e9)
            if (a, b) == (s0, s1):
                whole[e.name()].append((b - a) / 1e9)
    iv.sort()
    busy, gaps, cur = 0, [], w0
    for a, b in iv:
        if a > cur:
            gaps.append(((cur - w0) / 1e9, (a - cur) / 1e9))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append(((cur - w0) / 1e9, (w1 - cur) / 1e9))
    return Profile(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                   ops=dict(ops), whole=dict(whole), gaps=gaps,
                   t_host0=t_host0)


def breakdown(tracer: Tracer, top: int = 10) -> dict | None:
    """The device operations that took the most time in the traced
    stretch, and its idle time by the benchmark spans open on the host in
    each gap (at its midpoint), the largest first."""
    p = tracer.profile
    if p is None or not p.ops:
        return None
    ops = sorted(((n, float(np.sum(d))) for n, d in p.ops.items()),
                 key=lambda x: -x[1])[:top]
    idle = collections.Counter()
    mids = np.array([p.t_host0 + a + n / 2 for a, n in p.gaps])
    for label, (_, length) in zip(tracer.open_at(mids), p.gaps):
        idle[label] += length
    gaps = [[n, float(s)] for n, s in idle.most_common(top)]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": gaps}
