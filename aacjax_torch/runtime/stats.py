"""Per-batch decode statistics and stage timing (SURVEY.md §5: the
reference has no tracing/metrics at all; the realtime-x north-star metric
requires them here).

DecodeStats accumulates per-step host-parse and device wall times and
exposes aggregate realtime-x.  device_seconds spans dispatch through
host-side materialization (compute + D2H), recorded when the runtime's
finalize_step materializes a result — never the async jit dispatch alone,
which would overstate throughput.  For deep device profiling use
`jax.profiler.trace(logdir)` around BatchDecoder steps — the decode step
shows up as a single fused XLA program.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class DecodeStats:
    sample_rate: int = 44100
    frames_decoded: int = 0          # channel-frames
    stream_frames: int = 0           # stream-frames (audio time basis)
    steps: int = 0
    streams_active: int = 0
    streams_failed: int = 0
    parse_seconds: float = 0.0
    device_seconds: float = 0.0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def add_step(self, parse_seconds: float, device_seconds: float,
                 stream_frames: int, channel_frames: int) -> None:
        """Record one completed step (thread-safe under the GIL: single
        method call with locally measured durations, so the pipelined
        runtime's parse/device threads can't interleave partial state)."""
        self.parse_seconds += parse_seconds
        self.device_seconds += device_seconds
        self.steps += 1
        self.stream_frames += stream_frames
        self.frames_decoded += channel_frames

    @property
    def audio_seconds(self) -> float:
        return self.stream_frames * 1024 / self.sample_rate

    @property
    def realtime_x(self) -> float:
        total = self.parse_seconds + self.device_seconds
        return self.audio_seconds / total if total > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "steps": self.steps,
            "stream_frames": self.stream_frames,
            "channel_frames": self.frames_decoded,
            "audio_seconds": round(self.audio_seconds, 3),
            "parse_seconds": round(self.parse_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "realtime_x": round(self.realtime_x, 1),
            "streams_failed": self.streams_failed,
        }
