"""The port's hand-written CUDA kernels and its device path, on the card.

Every test here needs a CUDA GPU and skips without one: the kernels have no
interpret mode.  On a machine with one GPU, from the repository root:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held to its plain PyTorch version on the same card and the
same numpy-seeded inputs, at the reference's tolerances for its Pallas
kernels (tests/test_pallas_tail.py, tests/test_pallas_synth.py): int16 PCM
within 1 LSB with fewer than 2% of samples differing, f32 PCM within
5e-5 * max(1, max|ref|), the carried overlap of the random chunks within
3e-3, synthesis halves within 5e-5 * scale.  The kernels compute the IMDCT
by FFT, the plain versions by the reference's dense product.  TNS is held to 1e-6 * max|x|:
the float-float form exists for that accuracy.  This file imports no JAX.
"""
import pytest
import torch

import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.kernels import synth, tail, tns

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _on(dev, arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


@pytest.mark.parametrize("C,T,ragged", [(8, 4, True), (9, 5, True),
                                        (8, 64, True), (64, 16, False)])
@pytest.mark.parametrize("has_short", [True, False])
@pytest.mark.parametrize("out_int16", [True, False])
@pytest.mark.parametrize("i16", [True, False])
def test_tail_kernel_matches_plain(dev, i16, out_int16, has_short, C, T,
                                   ragged):
    """Includes a C that no channel block divides, T = 64 (two channels per
    block) and channels with no valid frame."""
    b = TI.random_tail_chunk(C * T, C, T, i16=i16, has_short=has_short,
                             ragged=ragged, amp=3000.0)
    args = _on(dev, (b[k] for k in TI.TAIL_ARGS))
    kw = dict(out_int16=out_int16, has_short=has_short)
    before = tail.launches
    pcm, ov = tail.decode_tail(*args, **kw)
    assert tail.launches == before + 1
    ref, ref_ov = tail.decode_tail_ref(*args, **kw)
    torch.cuda.synchronize()
    TI.assert_pcm_close(pcm.cpu(), ref.cpu(), out_int16)
    assert float((ov - ref_ov).abs().max()) <= 3e-3
    if ragged:     # channel 0 has no frames: its overlap passes through
        assert torch.equal(ov[0], args[-1][0])


@pytest.mark.parametrize("C,T,i16,out_int16,has_short", [
    (1024, 16, True, True, False),   # the serving chunk of LC-512
    (1024, 16, False, True, True),   # a quarter of the frames EIGHT_SHORT
    (8, 64, False, False, True),     # few channels, many frames
])
def test_tail_kernel_at_main_path_shapes(dev, C, T, i16, out_int16,
                                         has_short):
    b = TI.random_tail_chunk(C + T, C, T, i16=i16, has_short=has_short,
                             ragged=C < 64, amp=3000.0)
    args = _on(dev, (b[k] for k in TI.TAIL_ARGS))
    kw = dict(out_int16=out_int16, has_short=has_short)
    before = tail.launches
    pcm, ov = tail.decode_tail(*args, **kw)
    assert tail.launches == before + 1
    ref, ref_ov = tail.decode_tail_ref(*args, **kw)
    torch.cuda.synchronize()
    TI.assert_pcm_close(pcm.cpu(), ref.cpu(), out_int16)
    assert float((ov - ref_ov).abs().max()) <= 3e-3


@pytest.mark.parametrize("B", [8, 100, 256, 16384])
def test_synthesis_kernel_matches_plain(dev, B):
    args = _on(dev, TI.random_synth_batch(B, B))
    before = synth.launches
    first, second = synth.synthesis(*args)
    assert synth.launches == before + 1
    rf, rs = synth.synthesis_ref(*args)
    torch.cuda.synchronize()
    scale = max(1.0, float(rf.abs().max()), float(rs.abs().max()))
    assert float((first - rf).abs().max()) <= 5e-5 * scale
    assert float((second - rs).abs().max()) <= 5e-5 * scale


@pytest.mark.parametrize("C,T", [(3, 5), (9, 7)])
def test_decode_spec_step_launches_synthesis_for_any_batch(dev, C, T):
    """Where the tail's gate fails, the kernel route launches the synthesis
    kernel even when C*T is no multiple of 8, and agrees with the plain
    route on the card."""
    from aacjax_torch.kernels import pipeline as P
    b = TI.random_tail_chunk(C * T, C, T, i16=False, amp=3000.0)
    meta = torch.stack([torch.from_numpy(b[k]) for k in (
        "f_idx", "s_idx", "shape_idx", "prev_shape_idx", "is_short",
        "valid")], -1).to(dev)
    overlap = torch.from_numpy(b["overlap"]).to(dev)
    spec = torch.from_numpy(b["spec"]).to(dev)
    s0, t0 = synth.launches, tail.launches
    pcm, ov = P.decode_spec_step({"meta": meta, "spec": spec}, overlap,
                                 P.PipelineFlags(has_stereo=False,
                                                 out_int16=True,
                                                 use_pallas=True))
    assert synth.launches == s0 + 1 and tail.launches == t0
    ref, ref_ov = P.decode_spec_step({"meta": meta, "spec": spec}, overlap,
                                     P.PipelineFlags(has_stereo=False,
                                                     out_int16=True))
    torch.cuda.synchronize()
    TI.assert_pcm_close(pcm.cpu(), ref.cpu(), True)
    assert float((ov - ref_ov).abs().max()) <= 3e-3


def test_decode_adts_on_card_mono_odd_chunks(dev):
    data = TI.encode_adts(TI.tone_pcm(1024 * 10)[:, :1], target_sf=120)
    before = synth.launches
    got, _ = aacjax_torch.decode_adts(data, chunk_frames=5, device=dev)
    assert synth.launches > before
    want, _ = aacjax_torch.decode_adts(data, chunk_frames=5, device="cpu")
    TI.assert_pcm_close(got, want, False)


def test_tns_kernel_matches_plain(dev):
    """Order-2, order-12 and order-20 filters in both directions, regions
    touching the first and the last bin."""
    args = _on(dev, TI.random_tns_chunk(11, 4, 6))
    before = tns.launches
    out = tns.tns(*args)
    assert tns.launches == before + 1
    ref = tns.tns_ref(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-6 * float(args[0].abs().max())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    b = TI.random_tail_chunk(1, 8, 4, i16=False)
    args = _on(dev, (b[k] for k in TI.TAIL_ARGS))
    with pytest.raises(TypeError, match="f_idx"):
        tail.decode_tail(*args[:2], args[2].long(), *args[3:],
                         out_int16=True, has_short=True)
    with pytest.raises(ValueError, match="not contiguous"):
        tail.decode_tail(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                         *args[1:], out_int16=True, has_short=True)
    sargs = _on(dev, TI.random_synth_batch(0, 8))
    with pytest.raises(ValueError, match="on cpu"):
        synth.synthesis(sargs[0], sargs[1].cpu(), *sargs[2:])


def test_decode_adts_on_card_runs_synthesis_and_tns(dev):
    data = TI.tns_short_adts(12, seed=0)
    s0, t0 = synth.launches, tns.launches
    got, rate = aacjax_torch.decode_adts(data, device=dev)
    assert synth.launches > s0 and tns.launches > t0
    want, want_rate = aacjax_torch.decode_adts(data, device="cpu")
    assert rate == want_rate
    TI.assert_pcm_close(got, want, False)


def test_decode_pipelined_on_card_matches_cpu(dev):
    from aacjax_torch.testing.streams import make_lc_payload_chunks
    configs, chunks = make_lc_payload_chunks(n_streams=4, chunk_frames=8,
                                             n_chunks=3)
    before = tail.launches
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device=dev)
    got = list(dec.decode_pipelined(iter(chunks), out_int16=True))
    assert tail.launches == before + 3
    ref = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device="cpu")
    want = list(ref.decode_pipelined(iter(chunks), out_int16=True))
    for g, w in zip(got, want, strict=True):
        TI.assert_pcm_close(g, w, True)
    # the carried overlap is f32 PCM in the 32768 scale (real audio reaches
    # thousands): the f32 PCM bound, relative to its largest value
    TI.assert_pcm_close(dec.save_state()["overlap"],
                        ref.save_state()["overlap"], False)
