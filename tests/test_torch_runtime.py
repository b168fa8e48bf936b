"""The port's runtime and API on CPU against the JAX package: the
pipelined batch decoder on real native-parsed chunks, decode_adts on a
stream with short windows and TNS, the state hand-over between the two
packages, and the routes the port does not take yet.

Tolerances (tests/test_pallas_tail.py): int16 PCM within 1 LSB with fewer
than 2% of samples differing; f32 PCM within 5e-5 * max(1, max|ref|).
"""
import numpy as np
import pytest
import torch

import aacjax
from aacjax.host import native
from aacjax.runtime.batch import BatchDecoder as JaxBatchDecoder
from aacjax.testing.streams import make_lc_payload_chunks
import aacjax_torch
from aacjax_torch.testing import (assert_pcm_close, encode_adts,
                                  tns_short_adts, tone_pcm)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")


@pytest.mark.parametrize("compact,out_int16", [(True, True), (False, False)])
def test_decode_pipelined_matches_reference(compact, out_int16):
    configs, chunks = make_lc_payload_chunks(n_streams=4, chunk_frames=8,
                                             n_chunks=3)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    want = list(ref.decode_pipelined(iter(chunks), out_int16=out_int16,
                                      compact=compact))
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    got = list(dec.decode_pipelined(iter(chunks), out_int16=out_int16,
                                    compact=compact))
    assert len(got) == len(want) == 3
    for k, (g, w) in enumerate(zip(got, want)):
        assert_pcm_close(g, w, out_int16, f"chunk {k}")
    assert dec.stats.steps == 3
    assert dec.stats.stream_frames == ref.stats.stream_frames
    np.testing.assert_array_equal(dec.prev_shapes, ref.prev_shapes)


def test_decode_adts_tns_short_matches_reference():
    data = tns_short_adts(12, seed=0)
    want, rate = aacjax.decode_adts(data)
    got, got_rate = aacjax_torch.decode_adts(data, device="cpu")
    assert got_rate == rate
    assert_pcm_close(got, want, False)


def test_decode_adts_mono_odd_chunks_matches_reference():
    """Mono in chunks of 5 frames: C = 1 + 2 CCE slots = 3, C*T = 15,
    which the port routes through the synthesis entry."""
    data = encode_adts(tone_pcm(1024 * 10)[:, :1], target_sf=120)
    want, rate = aacjax.decode_adts(data, chunk_frames=5)
    got, got_rate = aacjax_torch.decode_adts(data, chunk_frames=5,
                                             device="cpu")
    assert got_rate == rate and got.shape[1] == 1
    assert_pcm_close(got, want, False)


@pytest.mark.parametrize("drc_scale", [0.0, 0.5, 1.0])
def test_decode_adts_drc_matches_reference(drc_scale):
    """Banded dynamic_range_info gains with one excluded channel, folded
    into the native-parsed spectra on the host.  The stream comes from the
    port's copy of the encoder (its FIL path), byte-equal to aacjax's."""
    from aacjax.testing import encoder as jax_enc
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.testing import encoder as enc
    config = parse_asc(make_asc(2, 4, 2))
    t = np.arange(1024 * 6)[:, None] / 44100.0
    x = np.repeat(6000 * np.sin(2 * np.pi * 500 * t)
                  + 3000 * np.sin(2 * np.pi * 9000 * t), 2, axis=1)
    drc = enc.drc_payload([-18.0, 4.0], band_tops=[128, 1024],
                          excluded=[False, True])
    payloads = enc.encode_pcm_frames(x, config, target_sf=110,
                                     fil_payloads=[drc])
    assert payloads == jax_enc.encode_pcm_frames(x, config, target_sf=110,
                                                 fil_payloads=[drc])
    stream = b"".join(enc.adts_frame(p, config) for p in payloads)
    want, _ = aacjax.decode_adts(stream, drc_scale=drc_scale)
    got, _ = aacjax_torch.decode_adts(stream, drc_scale=drc_scale,
                                      device="cpu")
    assert_pcm_close(got, want, False)


def test_state_handover_from_jax():
    """Chunk 0 in JAX, its save_state() restored into the port, then
    chunk 1 in both packages."""
    configs, chunks = make_lc_payload_chunks(n_streams=2, chunk_frames=8,
                                             n_chunks=2, seed=3)
    ref = JaxBatchDecoder(configs, chunk_frames=8)
    ref.step_raw(chunks[0], out_int16=True)
    state = ref.save_state()
    want = ref.step_raw(chunks[1], out_int16=True)

    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    dec.restore_state(state)
    got = dec.step_raw(chunks[1], out_int16=True, compact=False)
    assert_pcm_close(got, want, True)
    back = dec.save_state()
    assert set(back) == {"overlap", "prev_shapes", "frames_decoded"}
    assert back["frames_decoded"] == [16, 16]


def test_he_stream_not_implemented():
    from test_sbr import make_he_stream
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        aacjax_torch.decode_adts(make_he_stream(ch=2, n_frames=2),
                                 device="cpu")


def test_restore_rejects_non_core_state():
    configs, _ = make_lc_payload_chunks(n_streams=1, chunk_frames=4)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    state = dec.save_state()
    state["pred_state"] = np.zeros((2, 672, 6), np.float32)
    with pytest.raises(NotImplementedError):
        dec.restore_state(state)
    with pytest.raises(NotImplementedError, match="item 7"):
        aacjax_torch.BatchDecoder(configs, use_native=False, device="cpu")
    assert torch.equal(dec.overlap, torch.zeros_like(dec.overlap))
