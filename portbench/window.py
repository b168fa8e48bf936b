"""The measured window of a closed-loop run and its end-to-end statistics.

The window opens when the last warm-up chunk's PCM reaches the host and
closes `seconds` later.  Its chunks are those whose PCM reached the host
inside it.  `decode_realtime_x` is their audio seconds over the time from
the window's opening to the last of them; `chunk_p95_ms` the 95th
percentile of their latencies, each from the moment the benchmark's
iterator handed the chunk over to the moment its PCM was yielded.  Both
are taken over every chunk of the window: no best repetition, no median
of pieces.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float
    chunk_audio_s: float              # audio seconds a chunk carries
    warmup_chunks: int
    handed: list[float] = field(default_factory=list)
    done: list[float] = field(default_factory=list)
    t_open: float | None = None

    @property
    def t_close(self) -> float | None:
        return None if self.t_open is None else self.t_open + self.seconds

    def record(self, t: float) -> bool:
        """Chunk len(done)'s PCM reached the host at `t`.  Returns True
        once the window has closed: no more chunks are to be handed
        over."""
        self.done.append(t)
        if len(self.done) == self.warmup_chunks:
            self.t_open = t
        return self.t_open is not None and t >= self.t_close

    def chunks(self) -> list[int]:
        """The window's chunk indices."""
        if self.t_open is None:
            return []
        return [k for k in range(self.warmup_chunks, len(self.done))
                if self.done[k] <= self.t_close]

    def latencies_s(self) -> np.ndarray:
        return np.array([self.done[k] - self.handed[k]
                         for k in self.chunks()])

    def realtime_x(self) -> float | None:
        ks = self.chunks()
        if not ks:
            return None
        return len(ks) * self.chunk_audio_s / (self.done[ks[-1]]
                                               - self.t_open)

    def p95_ms(self) -> float | None:
        lat = self.latencies_s()
        if not len(lat):
            return None
        return float(np.percentile(lat, 95.0)) * 1e3
