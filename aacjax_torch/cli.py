"""Command-line interface of the port: decode / encode / probe / parity /
info (counterpart of `aacjax/cli.py`).

  python -m aacjax_torch.cli decode input.aac output.wav [--device cpu]
  python -m aacjax_torch.cli encode input.wav output.aac --bitrate 128000
  python -m aacjax_torch.cli probe input.aac
  python -m aacjax_torch.cli parity [--device cpu]
  python -m aacjax_torch.cli info

Decoding runs on --device, "cuda" unless given; a CUDA request without
CUDA fails.
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_decode(args) -> int:
    import numpy as np
    from aacjax_torch.api import decode_adts, decode_loas, decode_m4a
    from aacjax_torch.host import mp4
    from aacjax_torch.host.latm import probe_loas

    data = open(args.input, "rb").read()
    # sniff MP4/LOAS first: adts.probe can false-positive on binary payloads
    chan_config = None
    if mp4.probe(data):
        decode = decode_m4a
        try:
            chan_config = mp4.parse(data).config.chan_config
        except Exception:  # noqa: BLE001 — decode reports the real error
            pass
    elif probe_loas(data):
        decode = decode_loas
    else:
        decode = decode_adts
    pcm, rate = decode(data, chunk_frames=args.chunk,
                       cce_slots=args.cce_slots,
                       on_error="skip" if args.conceal else "raise",
                       device=args.device)
    as_wav = args.output.lower().endswith(".wav")
    if as_wav and pcm.shape[1] > 2:
        from aacjax_torch.api import to_canonical_order
        from aacjax_torch.host import adts as _adts
        if chan_config is None:
            # only the first header is needed for chan_config; scan a
            # prefix instead of re-segmenting the whole file
            first = _adts.split_frames(data[:1 << 16])
            chan_config = first[0][0].chan_config if first else 0
        pcm = to_canonical_order(pcm, chan_config)
    if args.int16 or as_wav:
        out = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        fmt = "int16"
    else:
        out = pcm.astype(np.float32)
        fmt = "float32"
    if as_wav:
        _write_wav(args.output, out, rate)
    else:
        out.tofile(args.output)
    print(json.dumps({
        "samples": int(pcm.shape[0]),
        "channels": int(pcm.shape[1]),
        "sample_rate": rate,
        "format": "wav/pcm_s16le" if as_wav else fmt,
        "output": args.output,
    }))
    return 0


def _write_wav(path: str, pcm_i16, rate: int) -> None:
    import struct
    n, ch = pcm_i16.shape
    data = pcm_i16.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                      rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def _read_wav(path: str):
    """Minimal RIFF/WAVE reader: PCM s16le or float32, any channel count."""
    import struct

    import numpy as np
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.read(size - 16)
            elif cid == b"data":
                raw = f.read(size)
                break
            else:
                f.read(size + (size & 1))
        if fmt is None:
            raise ValueError(f"{path}: no fmt chunk")
        tag, ch, rate, _, _, bits = fmt
        if tag == 1 and bits == 16:
            pcm = np.frombuffer(raw, "<i2").astype(np.float64)
        elif tag == 3 and bits == 32:
            pcm = np.frombuffer(raw, "<f4").astype(np.float64) * 32768.0
        else:
            raise ValueError(f"{path}: unsupported WAV format "
                             f"(tag {tag}, {bits}-bit)")
        return pcm.reshape(-1, ch), rate


def cmd_encode(args) -> int:
    from aacjax_torch.encode import AACEncoder
    from aacjax_torch.host.asc import make_asc

    pcm, rate = _read_wav(args.input)
    if pcm.shape[1] > 2:
        raise SystemExit("encoder supports mono and stereo WAV input")
    if args.he or args.ps:
        from aacjax_torch.encode_he import HEAACEncoder
        enc = HEAACEncoder(rate, pcm.shape[1], args.bitrate, ps=args.ps)
        as_m4a = args.output.lower().endswith((".m4a", ".mp4"))
        data = enc.encode_m4a(pcm) if as_m4a else enc.encode(pcm)
        with open(args.output, "wb") as f:
            f.write(data)
        secs = len(pcm) / rate
        print(json.dumps({
            "samples": int(pcm.shape[0]), "channels": int(pcm.shape[1]),
            "sample_rate": rate, "container": "m4a" if as_m4a else "adts",
            "profile": "HE-AAC v2" if args.ps else "HE-AAC",
            "bytes": len(data), "seconds": round(secs, 3),
            "kbps": round(len(data) * 8 / max(secs, 1e-9) / 1000, 1),
            "output": args.output,
        }))
        return 0
    if args.ld or args.eld:
        enc = AACEncoder(rate, pcm.shape[1], args.bitrate,
                         profile=39 if args.eld else 23,
                         tns=not args.no_tns, pns=False,
                         intensity=not args.no_is)
        data = enc.encode_loas(pcm)
        with open(args.output, "wb") as f:
            f.write(data)
        secs = len(pcm) / rate
        print(json.dumps({
            "samples": int(pcm.shape[0]), "channels": int(pcm.shape[1]),
            "sample_rate": rate, "container": "loas",
            "profile": "AAC-ELD" if args.eld else "AAC-LD",
            "frame_length": enc.config.frame_length,
            "bytes": len(data), "seconds": round(secs, 3),
            "kbps": round(len(data) * 8 / max(secs, 1e-9) / 1000, 1),
            "output": args.output,
        }))
        return 0
    enc = AACEncoder(rate, pcm.shape[1], args.bitrate,
                     tns=not args.no_tns, pns=not args.no_pns,
                     intensity=not args.no_is)
    if args.output.lower().endswith((".m4a", ".mp4")):
        from aacjax_torch.testing.mp4mux import mux_m4a
        payloads = enc.encode_frames(pcm)
        asc = make_asc(2, enc.config.sample_index, pcm.shape[1])
        data = mux_m4a(payloads, asc, rate, pcm.shape[1],
                       frame_length=enc.config.frame_length,
                       priming=enc.config.frame_length,
                       valid_samples=pcm.shape[0], movie_ts=rate)
        container = "m4a"
    else:
        data = enc.encode(pcm)
        container = "adts"
    with open(args.output, "wb") as f:
        f.write(data)
    secs = len(pcm) / rate
    print(json.dumps({
        "samples": int(pcm.shape[0]), "channels": int(pcm.shape[1]),
        "sample_rate": rate, "container": container,
        "bytes": len(data), "seconds": round(secs, 3),
        "kbps": round(len(data) * 8 / max(secs, 1e-9) / 1000, 1),
        "output": args.output,
    }))
    return 0


def cmd_probe(args) -> int:
    from aacjax_torch.host import adts
    from aacjax_torch.host.asc import parse_asc

    data = open(args.input, "rb").read()
    from aacjax_torch.host import latm
    if latm.probe_loas(data):
        mux, payloads = latm.split_loas(data, on_error="skip")
        cfg = mux.config if mux else None
        result = {"loas": True, "adts": False}
        if cfg:
            result.update(sample_rate=cfg.sample_rate,
                          channels=cfg.channels,
                          profile=cfg.profile, frames=len(payloads))
        print(json.dumps(result))
        return 0
    ok = adts.probe(data)
    result = {"adts": bool(ok)}
    if ok:
        frames = adts.split_frames(data)
        if frames:
            header = frames[0][0]
            cfg = parse_asc(adts.synthesize_cookie(header))
            result.update(sample_rate=cfg.sample_rate,
                          channels=cfg.chan_config,
                          profile=cfg.profile,
                          frames=len(frames))
    print(json.dumps(result))
    return 0 if ok else 1


def cmd_parity(args) -> int:
    """Validate the device pipeline against the independent fp64 model
    decoder over a randomized conformance corpus (all window sequences,
    stereo tools, TNS, PNS, pulse) — the BASELINE.json north-star check:
    PCM max-abs error < 1e-4 at the reference's 1/32768 output scale."""
    import numpy as np

    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.host.bitio import BitWriter
    from aacjax_torch.runtime.batch import BatchDecoder
    from aacjax_torch.testing import encoder as enc
    from aacjax_torch.testing.specgen import random_channel_spec, random_cpe_spec

    from aacjax_torch.host.asc import UnsupportedError
    from aacjax_torch.host.refdec import ModelDecoder

    rng = np.random.default_rng(args.seed)
    profile_plan = ([(2, 1024)] if not args.all_profiles else
                    [(2, 1024), (2, 960), (17, 1024), (17, 960),
                     (23, 512), (23, 480), (39, 512), (39, 480)])
    per_profile: dict = {}
    cases = 0
    for _case in range(args.cases):
        profile, fl = profile_plan[_case % len(profile_plan)]
        si = int(rng.integers(0, 12))
        stereo = bool(rng.integers(0, 2))
        try:
            config = parse_asc(make_asc(profile, si, 2 if stereo else 1,
                                        frame_length=fl))
        except UnsupportedError:   # LD/ELD undefined at some indices
            config = parse_asc(make_asc(profile, 4, 2 if stereo else 1,
                                        frame_length=fl))
        er = profile in (17, 23, 39)
        kw = dict(allow_pulse=not er, allow_noise=not er)
        payloads = []
        for _ in range(args.frames):
            if er:
                # ER layouts are FIXED by channelConfiguration: stereo
                # configs must carry a CPE
                if stereo:
                    left = random_channel_spec(rng, config,
                                               window_sequence=0, **kw)
                    right = random_channel_spec(
                        rng, config, window_sequence=0,
                        grouping=left.grouping, max_sfb=left.max_sfb,
                        window_shape=left.window_shape, **kw)
                    elem = ("CPE", enc.CPESpec(left=left, right=right,
                                               common_window=True,
                                               ms_type=2))
                else:
                    elem = ("SCE", random_channel_spec(
                        rng, config, window_sequence=0, **kw))
                payloads.append(
                    enc.write_eld_frame([elem], config)
                    if profile == 39
                    else enc.write_er_frame([elem], config))
            else:
                w = BitWriter()
                if stereo:
                    enc.write_cpe(w, random_cpe_spec(rng, config), config)
                else:
                    enc.write_sce(w, random_channel_spec(rng, config, **kw),
                                  config)
                payloads.append(enc.end_frame(w))
        dec = BatchDecoder([config], chunk_frames=len(payloads),
                           device=args.device)
        frames = dec.parse_stream_frames(0, payloads)
        got = dec.stream_pcm(dec.step([frames]), 0, len(payloads))
        model = ModelDecoder(config)
        want = np.concatenate([model.decode_frame(f) for f in frames], axis=0)
        # normalize to full-scale +-1.0 like the north-star criterion
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max()) / scale
        key = f"aot{profile}_f{fl}"
        per_profile[key] = max(per_profile.get(key, 0.0), err)
        cases += 1
    worst = max(per_profile.values()) if per_profile else 0.0
    ok = worst < 1e-4
    print(json.dumps({"cases": cases, "frames_per_case": args.frames,
                      "max_abs_err_fullscale": worst,
                      "per_profile": {k: round(v, 9)
                                      for k, v in sorted(per_profile.items())},
                      "target": 1e-4, "pass": ok}))
    return 0 if ok else 1


def cmd_info(args) -> int:
    import torch

    import aacjax_torch
    from aacjax_torch.host import native, native_write

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": aacjax_torch.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "cuda_device": torch.cuda.get_device_name(0) if cuda else None,
        "cuda_device_count": torch.cuda.device_count() if cuda else 0,
        "native_parser": native.available(),
        "native_writer": native_write.available(),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aacjax-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode",
                       help="decode an ADTS .aac file (raw PCM, or WAV if "
                            "the output ends in .wav)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--chunk", type=int, default=64)
    d.add_argument("--int16", action="store_true")
    d.add_argument("--conceal", action="store_true",
                   help="conceal corrupt frames as silence instead of failing")
    d.add_argument("--cce-slots", type=int, default=2, dest="cce_slots",
                   help="channel slots reserved per stream for coupling "
                        "channels (CCE elements)")
    d.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda or cpu)")
    d.set_defaults(fn=cmd_decode)

    e = sub.add_parser("encode",
                       help="encode a WAV file to AAC-LC (.aac ADTS, or "
                            ".m4a/.mp4 with gapless metadata)")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--bitrate", type=int, default=128_000)
    e.add_argument("--he", action="store_true",
                   help="encode HE-AAC v1 (SBR): half-rate AAC-LC core + "
                        "spectral band replication; for low bitrates "
                        "(~32-64 kbps)")
    e.add_argument("--ld", action="store_true",
                   help="encode low-delay AAC-LD (AOT 23, 512-sample "
                        "frames, LOAS/LATM output) for conferencing")
    e.add_argument("--eld", action="store_true",
                   help="encode enhanced-low-delay AAC-ELD (AOT 39, "
                        "one-frame system delay, LOAS/LATM output)")
    e.add_argument("--ps", action="store_true",
                   help="encode HE-AAC v2 (SBR + Parametric Stereo): mono "
                        "downmix core + IID/ICC stereo image (~24-40 kbps)")
    e.add_argument("--no-tns", action="store_true",
                   help="disable TNS analysis")
    e.add_argument("--no-pns", action="store_true",
                   help="disable perceptual noise substitution")
    e.add_argument("--no-is", action="store_true",
                   help="disable intensity stereo")
    e.set_defaults(fn=cmd_encode)

    p = sub.add_parser("probe", help="probe a file for ADTS AAC")
    p.add_argument("input")
    p.set_defaults(fn=cmd_probe)

    i = sub.add_parser("info", help="environment / backend info")
    i.set_defaults(fn=cmd_info)

    y = sub.add_parser("parity",
                       help="device pipeline vs fp64 model decoder")
    y.add_argument("--all-profiles", action="store_true",
                   dest="all_profiles",
                   help="sweep LC/ER-LC/LD/ELD at every frame length "
                        "instead of LC-1024 only")
    y.add_argument("--cases", type=int, default=12)
    y.add_argument("--frames", type=int, default=4)
    y.add_argument("--seed", type=int, default=0)
    y.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda or cpu)")
    y.set_defaults(fn=cmd_parity)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
