#!/usr/bin/env python3
"""Transcode anything aacjax_torch decodes into anything it encodes
(counterpart of examples/transcode.py).

    python -m aacjax_torch.examples.transcode in.{aac,loas,m4a,wav} \
        out.{aac,m4a,loas,wav} [--bitrate 128000] \
        [--profile lc|lc960|ld|eld|he|hev2] [--device cpu]

Demonstrates the full loop: container sniffing -> batched device decode
-> (optional) re-encode through any profile family -> mux.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def load(path: str, device: str):
    from aacjax_torch import decode_adts, decode_loas, decode_m4a
    from aacjax_torch.cli import _read_wav
    from aacjax_torch.host import mp4
    from aacjax_torch.host.latm import probe_loas
    data = open(path, "rb").read()
    if path.lower().endswith(".wav"):
        return _read_wav(path)
    if mp4.probe(data):
        pcm, rate = decode_m4a(data, device=device)
    elif probe_loas(data):
        pcm, rate = decode_loas(data, device=device)
    else:
        pcm, rate = decode_adts(data, device=device)
    return pcm * 32768.0, rate


def save(path: str, pcm: np.ndarray, rate: int, profile: str,
         bitrate: int) -> bytes:
    from aacjax_torch.encode import AACEncoder
    from aacjax_torch.encode_he import HEAACEncoder
    from aacjax_torch.cli import _write_wav
    ch = pcm.shape[1]
    if path.lower().endswith(".wav"):
        i16 = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
        _write_wav(path, i16, rate)
        return b""
    if profile in ("he", "hev2"):
        enc = HEAACEncoder(rate, ch, bitrate, ps=profile == "hev2")
        data = (enc.encode_m4a(pcm)
                if path.lower().endswith((".m4a", ".mp4"))
                else enc.encode(pcm))
    elif profile in ("ld", "eld", "lc960"):
        enc = AACEncoder(rate, ch, bitrate,
                         profile={"ld": 23, "eld": 39, "lc960": 2}[profile],
                         frame_length=960 if profile == "lc960" else None,
                         pns=profile == "lc960")
        data = enc.encode_loas(pcm)
    else:
        enc = AACEncoder(rate, ch, bitrate)
        if path.lower().endswith((".m4a", ".mp4")):
            from aacjax_torch.encode import encode_m4a
            data = encode_m4a(pcm, rate, bitrate)
        else:
            data = enc.encode(pcm)
    with open(path, "wb") as f:
        f.write(data)
    return data


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--bitrate", type=int, default=128_000)
    ap.add_argument("--profile", default="lc",
                    choices=["lc", "lc960", "ld", "eld", "he", "hev2"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (cuda or cpu)")
    args = ap.parse_args()
    pcm, rate = load(args.input, args.device)
    data = save(args.output, pcm, rate, args.profile, args.bitrate)
    secs = len(pcm) / rate
    kbps = len(data) * 8 / max(secs, 1e-9) / 1000 if data else 0.0
    print(f"{args.input} -> {args.output}: {secs:.1f}s @ {rate} Hz, "
          f"{pcm.shape[1]} ch" + (f", {kbps:.0f} kbps" if data else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
