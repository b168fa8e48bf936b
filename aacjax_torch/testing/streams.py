"""Small real-bitstream corpora for tests, the multichip dryrun and
benchmarks: encoded AAC-LC streams chunked into per-chunk payload lists
in the exact shape BatchDecoder.step_raw / decode_pipelined consume."""
from __future__ import annotations

import numpy as np

from aacjax_torch.host.asc import StreamConfig, make_asc, parse_asc
from aacjax_torch.testing.encoder import encode_pcm_frames


def make_lc_payload_chunks(n_streams: int, chunk_frames: int,
                           n_chunks: int = 1, seed: int = 0,
                           target_sf: int = 140,
                           ) -> tuple[list[StreamConfig], list[list[list[bytes]]]]:
    """Encode n_streams distinct stereo AAC-LC streams (tones + noise with
    per-stream character) and slice them into n_chunks payload chunks.

    Returns (configs, chunks) where chunks[k][i] is the list of
    raw_data_block payloads for stream i in chunk k.
    """
    config = parse_asc(make_asc(2, 4, 2))
    sr = config.sample_rate
    n = chunk_frames * n_chunks * config.frame_length
    t = np.arange(n) / sr
    per_stream: list[list[bytes]] = []
    for i in range(n_streams):
        rng = np.random.default_rng(seed * 1000 + i)
        f0 = 180.0 * (1.27 ** (i % 11))
        x = (6500 * np.sin(2 * np.pi * f0 * t)
             + 2200 * np.sin(2 * np.pi * 2.9 * f0 * t + 0.4 * i)
             + 800 * rng.standard_normal(n))
        pcm = np.stack([x, np.roll(x, 48) * 0.8], axis=1)
        per_stream.append(encode_pcm_frames(pcm, config,
                                            target_sf=target_sf))
    chunks = []
    for k in range(n_chunks):
        lo = k * chunk_frames
        chunks.append([p[lo:lo + chunk_frames] for p in per_stream])
    return [config] * n_streams, chunks
