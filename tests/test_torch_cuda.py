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
by FFT, the plain versions by the reference's dense product.  TNS is held
to 1e-6 * max|x|: the float-float form exists for that accuracy (the kernel
keeps the plain version's roundings, so the two are in fact equal up to the
sign of a zero).  This file imports no JAX.
"""
import numpy as np
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


def _packed(np_args):
    """random_tns_chunk's arguments as tns_packed takes them, f32 spectra."""
    x, fl, fs, fe, rl, rs, re = np_args
    return (x, None, np.stack([fl, rl], axis=2),
            np.stack([np.stack([fs, fe], -1), np.stack([rs, re], -1)], axis=2))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("order", [1, 4, 5, 8, 9, 12, 13, 20])
def test_tns_kernel_each_order_class(dev, order, compact):
    """The lowest and the highest order of each class of the work lists,
    through both wrappers, from f32 and from compact int16 spectra."""
    np_args = TI.random_tns_chunk(order, 3, 5, kinds=[(order, 0.9)])
    x, _, lpc, rng = _packed(np_args)
    if compact:
        q, sc = TI.block_scale_i16(x)
        args = _on(dev, (q, sc, lpc, rng))
        out, ref = tns.tns_packed(*args), tns.tns_packed_ref(*args)
        xmax = float(ref.abs().max())
    else:
        args = _on(dev, np_args)
        out, ref = tns.tns(*args), tns.tns_ref(*args)
        packed = _on(dev, (x, None, lpc, rng))
        assert torch.equal(tns.tns_packed(*packed), out)
        xmax = float(args[0].abs().max())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-6 * xmax


def test_tns_kernel_serving_mix_passes_unfiltered_rows_through(dev):
    """Rows without a filter come out as the decompressed input, bit for
    bit; the launch count grows by one per call; a second call on the same
    input gives the same bits (the work lists' order varies from run to
    run and must not show)."""
    from aacjax_torch.kernels.pipeline import decompress_i16
    np_args = TI.serving_tns_chunk(5, 24, 16)
    args = _on(dev, np_args)
    before = tns.launches
    out = tns.tns_packed(*args)
    again = tns.tns_packed(*args)
    assert tns.launches == before + 2
    ref = tns.tns_packed_ref(*args)
    x = decompress_i16(args[0], args[1])
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-6 * float(x.abs().max())
    plain_rows = torch.from_numpy(
        ~tns.plan(np_args[2], np_args[3])["work"].any(axis=(1, 2))).to(dev)
    assert int(plain_rows.sum()) > 100
    assert torch.equal(out.reshape(-1, 1024)[plain_rows],
                       x.reshape(-1, 1024)[plain_rows])


def test_tns_kernel_overlapping_directions(dev):
    """A reverse range wins the bins it shares with a forward filter, also
    when it has no taps."""
    args = _on(dev, TI.overlap_tns_chunk())
    out, ref = tns.tns_packed(*args), tns.tns_packed_ref(*args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert torch.equal(out, tns.tns_packed(*args))


@pytest.mark.parametrize("compact", [False, True])
def test_tns_kernel_chunk_without_filters(dev, compact):
    """No work item at all: the launch is not refused and every bin passes
    through."""
    x = np.random.default_rng(2).standard_normal((4, 3, 1024)).astype(
        np.float32)
    spec, sc = TI.block_scale_i16(x) if compact else (x, None)
    args = _on(dev, (spec, sc, np.zeros((4, 3, 2, 8, 20), np.float32),
                     np.zeros((4, 3, 2, 8, 2), np.int32)))
    out = tns.tns_packed(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, tns.tns_packed_ref(*args))


def test_decode_spec_step_tns_route_does_not_synchronise(dev):
    """The kernel route of a TNS chunk copies nothing back to the host:
    with torch's sync debug mode on "error" a .item() or nonzero() on the
    route would raise.  It runs the TNS and the tail kernel."""
    from aacjax_torch.kernels import pipeline as P
    q, sc, lpc, rng = TI.serving_tns_chunk(9, 8, 16)
    b = TI.random_tail_chunk(3, 8, 16, i16=False, ragged=False)
    meta = np.stack([b[k] for k in ("f_idx", "s_idx", "shape_idx",
                                    "prev_shape_idx", "is_short", "valid")],
                    -1).astype(np.int32)
    batch = dict(zip(("spec_i16", "spec_scale", "tns_lpc", "tns_range",
                      "meta"), _on(dev, (q, sc, lpc, rng, meta))))
    overlap = torch.from_numpy(b["overlap"]).to(dev)
    flags = P.PipelineFlags(has_stereo=False, has_tns=True, out_int16=False,
                            use_pallas=True, spec_i16=True)
    P.decode_spec_step(dict(batch), overlap, flags)       # build, warm up
    torch.cuda.synchronize()
    n0, t0 = tns.launches, tail.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pcm, ov = P.decode_spec_step(dict(batch), overlap, flags)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tns.launches == n0 + 1 and tail.launches == t0 + 1
    ref, ref_ov = P.decode_spec_step(
        dict(batch), overlap, P.PipelineFlags(
            has_stereo=False, has_tns=True, out_int16=False, spec_i16=True))
    torch.cuda.synchronize()
    TI.assert_pcm_close(pcm.cpu(), ref.cpu(), False)
    assert float((ov - ref_ov).abs().max()) <= 3e-3


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


def test_tns_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, sc, lpc, rng = _on(dev, TI.serving_tns_chunk(1, 2, 4))
    with pytest.raises(TypeError, match="spec"):
        tns.tns_packed(q.int(), sc, lpc, rng)
    with pytest.raises(TypeError, match="spec"):
        tns.tns_packed(q, None, lpc, rng)          # int16 without its scale
    with pytest.raises(ValueError, match="spec_scale"):
        tns.tns_packed(q, sc[..., :32].contiguous(), lpc, rng)
    with pytest.raises(ValueError, match="tns_range: shape"):
        tns.tns_packed(q, sc, lpc, rng[:, :, 0])
    with pytest.raises(ValueError, match="on cpu"):
        tns.tns_packed(q, sc, lpc.cpu(), rng)
    with pytest.raises(ValueError, match="not contiguous"):
        tns.tns_packed(q, sc, lpc.transpose(0, 1).contiguous().transpose(0, 1),
                       rng)
    with pytest.raises(TypeError, match="tns_range"):
        tns.tns_packed(q, sc, lpc, rng.long())
    x = torch.zeros((2, 4, 1024), device=dev)
    planes = (lpc[:, :, 0].contiguous(), rng[:, :, 0, :, 0].contiguous(),
              rng[:, :, 0, :, 1].contiguous())
    with pytest.raises(ValueError, match="fwd_start: not contiguous"):
        tns.tns(x, planes[0], rng[:, :, 0, :, 0], planes[2], *planes)
    with pytest.raises(ValueError, match="spec: shape"):
        tns.tns(x[..., :512].contiguous(), *planes, *planes)
    with pytest.raises(TypeError, match="spec"):
        tns.tns(x.double(), *planes, *planes)


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


def test_decode_pipelined_on_card_tns_corpus_matches_cpu(dev):
    """Chunks that carry TNS take the TNS kernel and then the tail kernel
    on f32 spectra, once each per chunk."""
    config, streams = TI.tns_serving_corpus(4, 16)
    corpus = [TI.adts_payloads(d) for d in streams]
    chunks = [[corpus[i % 4][k * 8:(k + 1) * 8] for i in range(8)]
              for k in range(2)]
    n0, t0, s0 = tns.launches, tail.launches, synth.launches
    dec = aacjax_torch.BatchDecoder([config] * 8, chunk_frames=8, device=dev)
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False))
    assert tns.launches == n0 + 2
    assert tail.launches + synth.launches == t0 + s0 + 2
    ref = aacjax_torch.BatchDecoder([config] * 8, chunk_frames=8,
                                    device="cpu")
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False))
    for g, w in zip(got, want, strict=True):
        TI.assert_pcm_close(g, w, False)
