#!/usr/bin/env python3
"""Minimal batch-serving example: decode many concurrent AAC streams on
one GPU with per-stream state, error isolation, and live stats
(counterpart of examples/serving.py).

    python -m aacjax_torch.examples.serving stream1.aac stream2.aac ...
    python -m aacjax_torch.examples.serving --demo    # 32 demo streams
    (add --device cpu to run without CUDA)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from aacjax_torch.host import adts
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.runtime.batch import BatchDecoder


def demo_streams(n: int):
    from aacjax_torch.testing.encoder import encode_pcm
    config = parse_asc(make_asc(2, 4, 2))
    sr = config.sample_rate
    t = np.arange(sr * 2) // 1 / sr
    out = []
    for i in range(n):
        f0 = 220.0 * (1.2 ** (i % 12))
        x = 8000 * np.sin(2 * np.pi * f0 * t)
        out.append(encode_pcm(np.stack([x, 0.8 * x], axis=1), config,
                              target_sf=140))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="*")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (cuda or cpu)")
    args = ap.parse_args()

    datas = (demo_streams(32) if args.demo
             else [open(f, "rb").read() for f in args.files])
    if not datas:
        ap.error("give .aac files or --demo")

    # segment + configure every stream
    configs, payloads = [], []
    for data in datas:
        frames = adts.split_frames(data)
        header = frames[0][0]
        configs.append(parse_asc(adts.synthesize_cookie(header)))
        payloads.append([data[s:e] for _, s, e in frames])

    dec = BatchDecoder(configs, chunk_frames=args.chunk, device=args.device)
    n_frames = max(len(p) for p in payloads)

    def chunks():
        for lo in range(0, n_frames, args.chunk):
            yield [p[lo:lo + args.chunk] for p in payloads]

    total = np.zeros(len(datas))
    for c, pcm in enumerate(dec.decode_pipelined(chunks(), out_int16=True)):
        # route each stream's PCM wherever it needs to go
        lo = c * args.chunk
        for i in range(len(datas)):
            n = min(args.chunk, len(payloads[i]) - lo)
            if n > 0:
                total[i] += np.abs(dec.stream_pcm(pcm, i, n)).mean()

    print("stats:", dec.stats.as_dict(), file=sys.stderr)
    print("failed streams:",
          [i for i, st in enumerate(dec.streams) if st.failed],
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
