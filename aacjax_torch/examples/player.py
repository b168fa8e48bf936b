"""Aurora-style player integration on aacjax_torch (counterpart of
examples/player.py).

The reference plugs into Aurora.js: `Player` pulls PCM by repeatedly
calling `decoder.readChunk()` and seeks by restarting the demuxer
(SURVEY.md §1 L6).  aacjax_torch.AACFile gives the same loop random access
over any supported container (ADTS, LOAS/LATM, MP4/M4A) with a frame
index and warmed-in decoding, so a player is just:

    python -m aacjax_torch.examples.player song.m4a out.wav --start 30 \
        --duration 10 [--device cpu]

The "sink" here is a WAV writer; swap play() for a real audio callback
(the chunk cadence matches one AAC frame of output samples).
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from aacjax_torch import AACFile


class WavSink:
    """Stand-in for an audio device: accepts float32 PCM chunks."""

    def __init__(self, path: str, rate: int, channels: int):
        self._f = open(path, "wb")
        self._rate, self._ch, self._n = rate, channels, 0
        self._f.write(b"\x00" * 44)  # header patched on close

    def play(self, chunk: np.ndarray) -> None:
        i16 = np.clip(np.round(chunk * 32768.0), -32768, 32767)
        self._f.write(i16.astype(np.int16).tobytes())
        self._n += chunk.shape[0]

    def close(self) -> None:
        data_len = self._n * self._ch * 2
        self._f.seek(0)
        self._f.write(b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE")
        self._f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, self._ch,
                                            self._rate,
                                            self._rate * self._ch * 2,
                                            self._ch * 2, 16))
        self._f.write(b"data" + struct.pack("<I", data_len))
        self._f.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="ADTS/LOAS/M4A file")
    ap.add_argument("output", help="WAV sink path")
    ap.add_argument("--start", type=float, default=0.0,
                    help="seek position, seconds")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds to play (default: to EOF)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (cuda or cpu)")
    args = ap.parse_args(argv)

    f = AACFile(open(args.input, "rb").read(), device=args.device)
    print(f"{args.input}: {f.duration:.2f}s, {f.sample_rate} Hz, "
          f"{f.channels}ch, {f.frames} frames")
    sink = WavSink(args.output, f.sample_rate, f.channels)
    f.seek(args.start)
    end = (f.total_samples if args.duration is None
           else min(f.total_samples,
                    round((args.start + args.duration) * f.sample_rate)))
    played = 0
    # the Aurora Player loop: pull chunks from the cursor until done
    while True:
        pos = round(f.tell() * f.sample_rate)
        if pos >= end:
            break
        chunk = f.read_chunk()
        if chunk is None:
            break
        chunk = chunk[: end - pos]
        sink.play(chunk)
        played += chunk.shape[0]
    sink.close()
    print(f"played {played} samples ({played / f.sample_rate:.2f}s) "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
