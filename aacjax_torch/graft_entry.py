"""The port's entry points for a compile check and a multi-device dry run,
the torch twin of the repository's `__graft_entry__.py`: a single-device
decode step, and a dry run of every sharded path over a mesh.

    entry(device=None) -> (fn, example_args)
    dryrun_multichip(n_devices, devices=None) -> list of result lines

`entry` returns the python-packer `decode_step` (dequantization, M/S, TNS,
the filterbank and the overlap-add; the hand-written kernels on the card)
with its inputs: a chunk of stereo CPE frames with M/S, window switching and
TNS, encoded and parsed from real bitstreams.  It runs on the card unless
`device="cpu"`.

`dryrun_multichip` runs the reference's five paths over an n_devices
('stream', 'frame') mesh, factored as the reference factors it, and holds
each to the same calls with no mesh: the python-packer `decode_step`, the
native spec path, the HE-AAC core + SBR, `encode_pipelined`, and SBR +
Parametric Stereo.  Its streams come from `aacjax_torch.testing`.  Unlike
the reference's dry run it needs no subprocess and no scrubbed environment:
torch picks no backend at interpreter start, and a mesh's devices are what
the caller passes (the CPU n times over, virtual shards of one card, or
distinct cards), so it runs in the calling process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

CORE_TOL = 5e-5     # f32 core PCM, * max(1, max|ref|)
# HE and PS PCM, likewise: the SBR program amplifies a last-bit difference
# of the core about a hundredfold (tests/test_torch_he_bound.py), and a
# shard's matrix products may round differently from the whole batch's (on
# the CPU the core's already do), so the port's HE route bar applies
HE_TOL = 1e-3


def _example_chunk(n_streams: int, T: int, seed: int = 0):
    """A small real packed batch: T stereo CPE frames (M/S, window
    switching, TNS) encoded and parsed for each of n_streams streams.
    Returns (batch of numpy arrays, overlap [C, 1024], flags)."""
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.host.bitio import BitWriter
    from aacjax_torch.runtime.batch import BatchDecoder
    from aacjax_torch.runtime.pack import pack_frames
    from aacjax_torch.testing import encoder as enc
    from aacjax_torch.testing.specgen import random_cpe_spec

    rng = np.random.default_rng(seed)
    config = parse_asc(make_asc(2, 4, 2))
    payloads = []
    for _ in range(T):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, config, common=True), config)
        payloads.append(enc.end_frame(w))
    dec = BatchDecoder([config] * n_streams, chunk_frames=T, device="cpu")
    per_slot = []
    for i in range(n_streams):
        frames = dec.parse_stream_frames(i, payloads)
        per_slot.append((dec.streams[i].base_slot, frames))
    batch, flags = pack_frames(per_slot, dec.C, dec.T)
    overlap = np.zeros((dec.C, 1024), np.float32)
    return batch, overlap, dataclasses.replace(flags, use_pallas=True)


def entry(device=None):
    """(fn, example_args): fn(batch, overlap) -> (pcm, new overlap) is the
    port's compiled decode step (jitted_decode_step: a CUDA graph on the
    card, the eager step on the CPU) on a 2-stream, 4-frame chunk, its
    tensors on `device` (default "cuda"; raises without CUDA)."""
    from aacjax_torch.kernels.pipeline import jitted_decode_step
    from aacjax_torch.runtime.mesh import packed_tensor

    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: CUDA is not available; pass device='cpu'")
    batch, overlap, flags = _example_chunk(n_streams=2, T=4)
    return jitted_decode_step(flags), (
        {k: packed_tensor(k, v, device) for k, v in batch.items()},
        torch.from_numpy(overlap).to(device))


def _factor(n_devices: int) -> tuple[int, int]:
    """n_devices as stream x frame, as the reference factors it (more
    streams; a frame axis of 2, 3 or 4 where that leaves >= 2 streams)."""
    n_frame = 1
    for cand in (2, 3, 4):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            n_frame = cand
            break
    return n_devices // n_frame, n_frame


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _hold(what: str, err: float, tol: float, lines: list) -> None:
    if not err <= tol:
        raise AssertionError(f"dryrun_multichip: {what}: sharded differs from "
                             f"the unsharded call by {err:.3g} * max(1, "
                             f"max|ref|) > {tol}")
    lines.append(f"{what}: sharded == unsharded within {tol} * max(1, "
                 f"max|ref|) (max {err:.3g})")


def dryrun_multichip(n_devices: int, devices=None) -> list[str]:
    """Run the five sharded paths over an n_devices mesh of `devices` (by
    default n_devices CUDA cards; make_mesh raises if there are fewer) and
    hold each to the same call without a mesh on the mesh's first device.
    Returns one line per path; raises on a mismatch."""
    from aacjax_torch import testing as TI
    from aacjax_torch.encode_batch import BatchEncoder
    from aacjax_torch.host import adts, native
    from aacjax_torch.host.asc import parse_asc
    from aacjax_torch.kernels.pipeline import decode_step
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.runtime.batch import BatchDecoder
    from aacjax_torch.testing.streams import make_lc_payload_chunks

    n_stream, n_frame = _factor(n_devices)
    m = meshlib.make_mesh(n_stream, n_frame, devices=devices)
    flat = [d for row in m.devices for d in row]
    dev = flat[0]
    lines = [f"mesh {n_stream}x{n_frame} on {[str(d) for d in flat]}"]

    # 1. the python-packer decode_step: n_stream stereo streams, 2 frames a
    # frame shard
    T = 2 * n_frame
    batch, overlap, flags = _example_chunk(n_streams=n_stream, T=T)
    ref = decode_step({k: meshlib.packed_tensor(k, v, dev)
                       for k, v in batch.items()},
                      torch.from_numpy(overlap).to(dev), flags)
    lay = meshlib.layout(m, [2] * n_stream, T)
    got = meshlib.sharded_decode_step(flags, m)(
        meshlib.shard_batch(m, batch, lay), torch.from_numpy(overlap).to(dev))
    for name, g, r in (("pcm", got[0], ref[0]), ("overlap", got[1], ref[1])):
        _hold(f"decode_step {name} on {n_stream}x{n_frame}",
              _rel(meshlib.gather(g, "cpu"), r.cpu()), CORE_TOL, lines)

    # 2. the native spec path (compact int16 spectra, concealment, TNS): 4
    # stereo streams a stream shard, so that every shard takes the fused
    # tail as the unsharded chunk does (8 slots)
    if native.available():
        configs, chunks = make_lc_payload_chunks(
            n_streams=4 * n_stream, chunk_frames=T, n_chunks=1, seed=1)
        outs = []
        for mesh in (None, m):
            d = BatchDecoder(configs, chunk_frames=T, device=dev)
            parsed = d._parse_native(chunks[0], compact=True)
            pcm = d._device_step(parsed, mesh=mesh)
            outs.append(d.finalize_step(pcm).copy())
        _hold(f"decode_spec_step on {n_stream}x{n_frame}",
              _rel(outs[1], outs[0]), CORE_TOL, lines)
    else:
        lines.append("decode_spec_step: native parser unavailable; skipped")

    # 3-5 run over a stream-only mesh of every device
    m1 = meshlib.make_mesh(n_devices, 1, devices=flat)

    # 3. HE-AAC core + SBR: 4 stereo streams a shard (8 slots: the core
    # takes the fused tail on every shard, as unsharded), 2 chunks of 2
    # frames
    he = TI.he_stream(n_frames=4)
    payloads = [he[s:e] for _, s, e in adts.split_frames(he)]
    config = parse_asc(adts.synthesize_cookie(adts.split_frames(he)[0][0]))

    def run_he(mesh, cfg, pays, **kw):
        n = 4 * n_devices
        d = BatchDecoder([cfg] * n, chunk_frames=2, device=dev, **kw)
        return [d.step_he_raw([pays[lo:lo + 2]] * n, mesh=mesh)
                for lo in (0, 2)]

    want, got = run_he(None, config, payloads), run_he(m1, config, payloads)
    _hold(f"HE-AAC core+SBR on {n_devices}x1",
          max(_rel(g, w) for g, w in zip(got, want)), HE_TOL, lines)

    # 4. encode_pipelined: one channel row a shard (stereo streams, mono
    # for an odd count), against sequential encode_chunk without a mesh
    ch = 2 if n_devices % 2 == 0 else 1
    S = n_devices // ch
    pcm = TI.encode_serving_pcm(S, 2048)[:, :, :ch]
    chunks = [pcm[:, :1024], pcm[:, 1024:]]
    seq = BatchEncoder(44100, ch, 96_000, n_streams=S, device=dev)
    want = [seq.encode_chunk(c) for c in chunks]
    enc = BatchEncoder(44100, ch, 96_000, n_streams=S, device=dev, mesh=m1)
    got = list(enc.encode_pipelined(iter(chunks)))
    if got != want:
        raise AssertionError("dryrun_multichip: the sharded encoder's "
                             "payloads differ from the unsharded ones")
    lines.append(f"encode_pipelined on {n_devices}x1: payloads "
                 "byte-identical to sequential unsharded encode_chunk")

    # 5. SBR + Parametric Stereo: 4 mono PS streams a shard, with a spare
    # slot each (the right channel)
    ps = TI.ps_stream(TI.ps_specs()["20-band"], n_frames=4)
    pays = [ps[s:e] for _, s, e in adts.split_frames(ps)]
    cfg = parse_asc(adts.synthesize_cookie(adts.split_frames(ps)[0][0]))
    want = run_he(None, cfg, pays, cce_slots=1)
    got = run_he(m1, cfg, pays, cce_slots=1)
    _hold(f"HE-AAC v2 SBR+PS on {n_devices}x1",
          max(_rel(g, w) for g, w in zip(got, want)), HE_TOL, lines)
    return lines
