"""The decoder's own measurements: `DecodeStats`, the running totals an
operator reads while serving, and `Trace`, the spans and counters of one
decoder's serving layers, recorded when a caller sets `BatchDecoder.trace`
to a `Trace()`.

Both read `time.perf_counter` (spans in nanoseconds), one clock on every
thread.  A span records its name, the chunk it belongs to (the serving
entries number their chunks 0, 1, 2, ... in the order they are handed
over; other calls record under None), the span that encloses it on its
thread, the thread's role ("main", the caller's thread; "upload" and
"download", the pipeline's workers) and its start and end.  Counters are
integers keyed by (name, chunk).  Everything stays in memory.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

WORKERS = ("upload", "download")   # the pipeline's thread name prefixes


@dataclass
class DecodeStats:
    """Running totals over every chunk a decoder has finished.

    wall_seconds: a pipelined call counts from its first chunk's hand-over
    to its last yield (summed over calls); a direct call (step_raw,
    step_he_raw) counts each step from its parse to its PCM on the host.
    parse_seconds: the native parse of each chunk (the `parse` span's own
    measurement).  device_seconds: each step from its dispatch to its PCM
    on the host; under the pipeline that includes the time a step waits
    behind the one before it, so it is neither throughput nor cost.
    realtime_x: audio seconds over wall seconds."""
    sample_rate: int = 44100
    frames_decoded: int = 0          # channel-frames
    stream_frames: int = 0           # stream-frames (audio time basis)
    steps: int = 0
    streams_failed: int = 0
    parse_seconds: float = 0.0
    device_seconds: float = 0.0
    wall_seconds: float = 0.0

    def add_step(self, parse_seconds: float, device_seconds: float,
                 stream_frames: int, channel_frames: int,
                 wall_seconds: float = 0.0) -> None:
        """Record one completed step (one method call with locally measured
        durations, so the pipeline's threads can't interleave partial
        state)."""
        self.parse_seconds += parse_seconds
        self.device_seconds += device_seconds
        self.wall_seconds += wall_seconds
        self.steps += 1
        self.stream_frames += stream_frames
        self.frames_decoded += channel_frames

    @property
    def audio_seconds(self) -> float:
        return self.stream_frames * 1024 / self.sample_rate

    @property
    def realtime_x(self) -> float:
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "steps": self.steps,
            "stream_frames": self.stream_frames,
            "channel_frames": self.frames_decoded,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "parse_seconds": round(self.parse_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "realtime_x": round(self.realtime_x, 1),
            "streams_failed": self.streams_failed,
        }


@dataclass(eq=False, slots=True)
class Span:
    name: str
    chunk: int | None
    parent: Span | None = field(repr=False)
    thread: str
    t0_ns: int
    t1_ns: int = 0


class Trace:
    """Spans and counters of one decoder (see the module docstring).
    Spans are appended as they open; `t1_ns` is 0 until they close.  It
    grows with every chunk: a caller reads it and sets a fresh one."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[tuple[str, int | None], int] = {}
        self._open = threading.local()   # per thread: the open spans

    def open(self, name: str, chunk: int | None,
             t0_ns: int | None = None) -> Span:
        """Open a span on the calling thread, inside the innermost one open
        there; `t0_ns` (perf_counter_ns) where the caller has read it."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        role = threading.current_thread().name.partition("_")[0]
        s = Span(name, chunk, stack[-1] if stack else None,
                 role if role in WORKERS else "main",
                 time.perf_counter_ns() if t0_ns is None else t0_ns)
        stack.append(s)
        self.spans.append(s)
        return s

    def close(self, span: Span, t1_ns: int | None = None) -> None:
        """Close a span opened on the calling thread; a span an exception
        left open inside it leaves the thread's stack too (its t1_ns stays
        0)."""
        span.t1_ns = time.perf_counter_ns() if t1_ns is None else t1_ns
        stack = self._open.stack
        del stack[stack.index(span):]

    def count(self, name: str, chunk: int | None, n: int = 1) -> None:
        """Add n to a counter (counters are kept on one thread)."""
        key = (name, chunk)
        self.counters[key] = self.counters.get(key, 0) + n
