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
sign of a zero).  The predictor kernel is held to its plain version bit for
bit, and so are the fused Parametric Stereo decorrelator kernel and the
batched encoder's two scan kernels (the psy spread and the rate-cost grid);
the HE and PS routes are held to the CPU.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.kernels import enc_scans, pred, ps_decorr, synth, tail, tns

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
        tns.tns(x[..., :500].contiguous(), *planes, *planes)
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


@pytest.mark.parametrize("F", [960, 512, 480])
@pytest.mark.parametrize("compact", [False, True])
def test_tns_kernel_other_frame_lengths(dev, F, compact):
    """Frames of 960, 512 and 480 bins: filters in both directions whose
    ranges end at the last bin, reverse ranges in coordinates flipped about
    F, from f32 and from compact spectra (F / 16 scales a row)."""
    rng = np.random.default_rng(F)
    C, T = 3, 4
    x = (rng.standard_normal((C, T, F)) * 1000).astype(np.float32)
    lpc = np.zeros((C, T, 2, 8, 20), np.float32)
    rngs = np.zeros((C, T, 2, 8, 2), np.int32)
    for c in range(C):
        for t in range(T):
            cut = int(rng.integers(40, F - 40))
            for d, (lo, hi, order) in enumerate(((0, cut, 7), (cut, F, 12))):
                lpc[c, t, d, 0, :order] = TI._lpc_from_reflection(
                    rng.uniform(-0.8, 0.8, order))
                rngs[c, t, d, 0] = (F - hi, F - lo) if d else (lo, hi)
    if compact:
        blocks = x.reshape(C, T, F // 16, 16)
        sc = np.maximum(np.abs(blocks).max(-1) / 32767.0,
                        1e-30).astype(np.float32)
        q = np.clip(np.round(blocks / sc[..., None]), -32768,
                    32767).astype(np.int16).reshape(C, T, F)
        args = _on(dev, (q, sc, lpc, rngs))
    else:
        args = _on(dev, (x, None, lpc, rngs))
    out, ref = tns.tns_packed(*args), tns.tns_packed_ref(*args)
    torch.cuda.synchronize()
    assert out.shape == (C, T, F) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert float((out - torch.from_numpy(x).to(dev)).abs().max()) > 1.0


# -- the Main-profile predictor ---------------------------------------------------
def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("C,T,F", [(1024, 16, 1024), (8, 64, 1024),
                                   (3, 5, 1024), (2, 7, 960), (1, 1, 672)])
def test_pred_kernel_equals_plain_bit_for_bit(dev, C, T, F):
    """Three chunks with the state carried, every mode, reset groups, nbins
    below 672; also a frame length of 960 and of exactly the 672 bins."""
    st_k = st_p = pred.pred_state_init(C, dev)
    for k in range(3):
        args = _on(dev, TI.pred_chunk(C + k, C, T, F))
        keep = args[0].clone()
        before = pred.launches
        out, st_k = pred.apply_prediction(*args, st_k)
        assert pred.launches == before + 1
        assert torch.equal(args[0], keep)          # not in place by default
        ref, st_p = pred.apply_prediction_ref(*args, st_p)
        torch.cuda.synchronize()
        assert _bits_equal(out, ref) and _bits_equal(st_k, st_p)
    assert bool(torch.isfinite(out).all())
    assert not torch.equal(st_k, pred.pred_state_init(C, dev))


def test_pred_kernel_in_place_touches_only_the_predicted_bins(dev):
    args = _on(dev, TI.pred_chunk(4, 6, 9))
    state = pred.pred_state_init(6, dev)
    state_keep = state.clone()
    ref, _ = pred.apply_prediction_ref(*args, state)
    above = args[0][..., 672:].clone()
    out, _ = pred.apply_prediction(*args, state, inplace=True)
    torch.cuda.synchronize()
    assert out.data_ptr() == args[0].data_ptr()
    assert _bits_equal(out, ref) and torch.equal(out[..., 672:], above)
    assert torch.equal(state, state_keep)


def test_pred_wrapper_refuses_what_the_kernel_does_not_take(dev):
    spec, mode, reset, nbins, used = _on(dev, TI.pred_chunk(1, 2, 3))
    state = pred.pred_state_init(2, dev)
    with pytest.raises(TypeError, match="used"):
        pred.apply_prediction(spec, mode, reset, nbins, used.float(), state)
    with pytest.raises(TypeError, match="mode"):
        pred.apply_prediction(spec, mode.long(), reset, nbins, used, state)
    with pytest.raises(ValueError, match="spec: shape"):
        pred.apply_prediction(spec[..., :512].contiguous(), mode, reset,
                              nbins, used, state)
    with pytest.raises(ValueError, match="state: shape"):
        pred.apply_prediction(spec, mode, reset, nbins, used, state[:1])
    with pytest.raises(ValueError, match="on cpu"):
        pred.apply_prediction(spec, mode, reset.cpu(), nbins, used, state)
    with pytest.raises(ValueError, match="not contiguous"):
        pred.apply_prediction(spec.transpose(0, 1).contiguous().transpose(0, 1),
                              mode, reset, nbins, used, state)


# -- the routes beyond LC -----------------------------------------------------------
def _chunked(per_stream, T):
    n = min(len(p) for p in per_stream) // T
    return [[p[k * T:(k + 1) * T] for p in per_stream] for k in range(n)]


def test_main_pipelined_on_card_runs_pred_tns_synthesis(dev):
    """Main-profile chunks: one predictor and one synthesis launch a chunk,
    a TNS launch where the chunk carries TNS, no tail launch; PCM and the
    carried states against the CPU route."""
    cfg, corpus = TI.main_serving_corpus(4, 12)
    chunks = _chunked([corpus[i % 4] for i in range(8)], 4)
    p0, s0, t0, n0 = (pred.launches, synth.launches, tail.launches,
                      tns.launches)
    dec = aacjax_torch.BatchDecoder([cfg] * 8, chunk_frames=4, device=dev)
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False))
    assert pred.launches == p0 + 3 and synth.launches == s0 + 3
    assert tail.launches == t0 and tns.launches > n0
    ref = aacjax_torch.BatchDecoder([cfg] * 8, chunk_frames=4, device="cpu")
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False))
    for g, w in zip(got, want, strict=True):
        TI.assert_pcm_close(g, w, False)
    a, b = dec.save_state(), ref.save_state()
    # TNS follows prediction, so the predictor sees the parser's exact
    # spectra on both devices
    assert np.array_equal(a["pred_state"].view(np.uint32),
                          b["pred_state"].view(np.uint32))
    TI.assert_pcm_close(a["overlap"] / 32768, b["overlap"] / 32768, False)


def test_main_kernel_route_equals_plain_route_on_card(dev):
    cfg, corpus = TI.main_serving_corpus(2, 8)
    a = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=4, device=dev)
    b = aacjax_torch.BatchDecoder([cfg] * 2, chunk_frames=4, device=dev)
    for chunk in _chunked(corpus, 4):
        TI.assert_pcm_close(a.step_raw(chunk, use_pallas=True),
                            b.step_raw(chunk, use_pallas=False), False)
    assert np.array_equal(a.save_state()["pred_state"],
                          b.save_state()["pred_state"])


@pytest.mark.parametrize("chan_config", [6, 7])
def test_multichannel_coupling_on_card_matches_cpu(dev, chan_config):
    cfg = TI.multichannel_config(chan_config)
    per_stream = [TI.multichannel_payloads(chan_config, 4, s, coupling=True)
                  for s in (1, 2, 3)]
    chunks = _chunked(per_stream, 2)
    s0, t0 = synth.launches, tail.launches
    dec = aacjax_torch.BatchDecoder([cfg] * 3, chunk_frames=2, cce_slots=2,
                                    device=dev)
    parsed = dec._parse_native(chunks[0])
    assert parsed["_has_cce_post"] and parsed["_has_cce_time"]
    dec = aacjax_torch.BatchDecoder([cfg] * 3, chunk_frames=2, cce_slots=2,
                                    device=dev)
    got = list(dec.decode_pipelined(iter(chunks), out_int16=False))
    assert synth.launches == s0 + 2 and tail.launches == t0
    ref = aacjax_torch.BatchDecoder([cfg] * 3, chunk_frames=2, cce_slots=2,
                                    device="cpu")
    want = list(ref.decode_pipelined(iter(chunks), out_int16=False))
    for g, w in zip(got, want, strict=True):
        TI.assert_pcm_close(g, w, False)


def test_delegated_main_stream_on_card_runs_decode_step_kernels(dev):
    data = TI.main_stereo_adts(8, seed=3, intensity=True)
    p0, s0, n0 = pred.launches, synth.launches, tns.launches
    got, rate = aacjax_torch.decode_adts(data, chunk_frames=4, device=dev)
    assert pred.launches > p0 and synth.launches > s0 and tns.launches > n0
    want, _ = aacjax_torch.decode_adts(data, chunk_frames=4, device="cpu")
    TI.assert_pcm_close(got, want, False)


@pytest.mark.parametrize("profile,frame_length", [(17, 960), (23, 512),
                                                  (23, 480), (39, 512),
                                                  (39, 480)])
def test_decode_loas_on_card_matches_cpu(dev, profile, frame_length):
    cfg = TI.er_config(profile, frame_length, 2)
    loas = TI.enc.loas_stream(TI.er_payloads(cfg, 7, seed=profile), cfg)
    got, rate = aacjax_torch.decode_loas(loas, chunk_frames=3, device=dev)
    want, want_rate = aacjax_torch.decode_loas(loas, chunk_frames=3,
                                               device="cpu")
    assert rate == want_rate and got.shape == (7 * frame_length, 2)
    TI.assert_pcm_close(got, want, False)


@pytest.mark.parametrize("kind", ["ltp", "three_blocks"])
def test_decode_adts_on_card_ltp_and_multi_block_match_cpu(dev, kind):
    """AAC-LTP with TNS (the host's float64 decoder on either device, so
    the two calls are equal) and ADTS frames of three raw_data_blocks with
    crc_check, through decode_adts on the card against the CPU."""
    data = (TI.ltp_adts(8, seed=5, tns=True) if kind == "ltp"
            else TI.multi_rdb_adts(9, crc=True))
    got, rate = aacjax_torch.decode_adts(data, device=dev)
    want, want_rate = aacjax_torch.decode_adts(data, device="cpu")
    assert rate == want_rate and float(np.abs(want).max()) > 0
    if kind == "ltp":
        np.testing.assert_array_equal(got, want)
    else:
        TI.assert_pcm_close(got, want, False)


def test_streaming_decoder_on_card_matches_cpu(dev):
    """Block by block (T = 1): the native streaming route and the python
    parser, the predictor state advancing one frame a step."""
    def drain(data, device):
        dec = aacjax_torch.AACDecoder(device=device)
        out = []
        for i in range(0, len(data), 500):
            dec.feed(data[i:i + 500])
            while (c := dec.read_chunk()) is not None:
                out.append(c)
        return np.stack(out)

    for data in (TI.main_stereo_adts(6, seed=0), TI.multi_rdb_adts(6, crc=True),
                 TI.tns_short_adts(5, seed=1)):
        TI.assert_pcm_close(drain(data, dev), drain(data, "cpu"), False)


def test_reset_and_state_on_card(dev):
    """request_reset inside decode_pipelined and save / restore of the
    predictor state between a card decoder and a CPU decoder."""
    cfg, corpus = TI.main_serving_corpus(3, 8)
    a, b, c = corpus
    dec = aacjax_torch.BatchDecoder([cfg, cfg], chunk_frames=2, device=dev)

    def source():
        for i in range(4):
            if i == 2:
                dec.request_reset(0)
            yield [a[2 * i:2 * i + 2] if i < 2 else c[2 * i - 4:2 * i - 2],
                   b[2 * i:2 * i + 2]]

    got = [p.copy() for p in dec.decode_pipelined(source(), out_int16=False)]
    fresh = aacjax_torch.BatchDecoder([cfg], chunk_frames=2, device=dev)
    TI.assert_pcm_close(got[2][:2], fresh.step_raw([c[:2]]), False)
    TI.assert_pcm_close(got[3][:2], fresh.step_raw([c[2:4]]), False)
    cpu = aacjax_torch.BatchDecoder([cfg, cfg], chunk_frames=2, device="cpu")
    cpu.restore_state(dec.save_state())
    nxt = [c[4:6], b[6:8]]
    TI.assert_pcm_close(dec.step_raw(nxt), cpu.step_raw(nxt), False)


# -- HE-AAC v1 (SBR) ---------------------------------------------------------
# The SBR program and the QMF banks are PyTorch (the reference computes them
# as plain XLA, with no Pallas kernel); on the card they are held to the
# same calls on the CPU on the same inputs, f32 within 2e-4 * max(1,
# max|ref|) (the envelope gains divide by the patched bands' energies),
# int16 within 1 LSB on < 2% of the samples.  Whole HE decodes are held to
# the CPU within 1e-3 * max(1, max|ref|): their cores also differ, by the
# kernels' FFT IMDCT against the plain versions' dense product, and the same
# division amplifies that (TI.HE_ROUTE_TOL).  The HE core runs the tail (or
# synthesis) and TNS kernels.  The int16 PCM of a core on the kernel route
# against one on the plain route is held to the HE bound, TI.HE_I16_ONSET /
# HE_I16_STEADY, which tests/test_torch_he_bound.py derives.


def _he_serving_chunks(ps):
    """16 streams of the HE (or, with `ps`, the PS) serving corpus, two
    unique, in 2 chunks of 8 frames: (config, chunks)."""
    make = TI.ps_serving_corpus if ps else TI.he_serving_corpus
    config, corpus = make(2, 1.0, 16)
    return config, [[corpus[i % 2][8 * k:8 * (k + 1)] for i in range(16)]
                    for k in range(2)]


def _assert_he_bound(pairs):
    """HE int16 (got, want, first frame) pairs within TI.HE_I16_ONSET on a
    stream's frames 0-1 and TI.HE_I16_STEADY on later frames."""
    stats = TI.he_i16_stats(pairs)
    for part, (limit, share) in (("onset", TI.HE_I16_ONSET),
                                 ("steady", TI.HE_I16_STEADY)):
        assert stats[part][0] <= limit and stats[part][1] < share, stats


def _he_close(got, want, what="", tol=2e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def test_qmf_on_card_matches_cpu(dev):
    """The serving shape: B = 1024 channels, S = 256 slots (8 frames)."""
    from aacjax_torch.kernels import qmf
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1024, 32 * 256)).astype(
        np.float32) * 3000)
    h = torch.from_numpy(rng.standard_normal((1024, 288)).astype(
        np.float32) * 3000)
    want = qmf.analysis(x, h)
    got = qmf.analysis(x.to(dev), h.to(dev))
    for g, w in zip(got, want):
        _he_close(g.cpu(), w, "analysis")
    xr, xi = (torch.from_numpy(rng.standard_normal((1024, 256, 64)).astype(
        np.float32) * 300) for _ in range(2))
    vh = torch.from_numpy(rng.standard_normal((1024, 9, 128)).astype(
        np.float32) * 30)
    want = qmf.synthesis(xr, xi, vh)
    got = qmf.synthesis(xr.to(dev), xi.to(dev), vh.to(dev))
    for g, w in zip(got, want):
        _he_close(g.cpu(), w, "synthesis")


@pytest.mark.parametrize("ps", [False, True])
@pytest.mark.parametrize("out_int16", [False, True])
def test_sbr_apply_on_card_matches_cpu(dev, out_int16, ps):
    """One chunk of the HE serving corpus at the serving shape (512 stereo
    streams, C = 1024, T = 8), compact planes; with `ps`, sbr_ps_apply on
    one chunk of the PS serving corpus (512 mono streams and their pairs,
    C = 1024, T = 8, 20-band), its PCM and both states."""
    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import sbr_batch as SB
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    if ps:
        core, planes, ps_in, cfg, state, ps_state = TI.sbr_ps_apply_inputs(
            512, 8, dev)
        got, *got_state = PB.sbr_ps_apply(core, planes, ps_in, state,
                                          ps_state, cfg, out_int16)
        want, *want_state = PB.sbr_ps_apply(
            core.cpu(), cpu(planes), cpu(ps_in), cpu(state), cpu(ps_state),
            cpu(cfg), out_int16)
    else:
        core, planes, cfg, state = TI.sbr_apply_inputs(512, 8, dev,
                                                       compact=True)
        got, *got_state = SB.sbr_apply(core, planes, state, cfg, out_int16)
        want, *want_state = SB.sbr_apply(core.cpu(), cpu(planes), cpu(state),
                                         cpu(cfg), out_int16)
    if out_int16:
        TI.assert_pcm_close(got.cpu(), want, True)
    else:
        _he_close(got.cpu(), want, "pcm")
    for g, w in zip(got_state, want_state, strict=True):
        for k in w:
            _he_close(g[k].cpu(), w[k], k)


def test_decode_he_pipelined_on_card_matches_cpu(dev):
    """16 HE streams, 2 chunks of 8: the q/sf core through the tail kernel
    once a chunk, then the SBR program.  int16 PCM equals step_he_raw's on
    the card; f32 PCM matches the CPU."""
    config, chunks = _he_serving_chunks(False)

    def decoder(device):
        return aacjax_torch.BatchDecoder([config] * 16, chunk_frames=8,
                                         device=device)
    before = tail.launches
    got = list(decoder(dev).decode_he_pipelined(iter(chunks), out_int16=True))
    assert tail.launches == before + 2
    step = decoder(dev)
    for g, c in zip(got, chunks, strict=True):
        TI.assert_pcm_close(g, step.step_he_raw(c, out_int16=True), True)
    got = decoder(dev).decode_he_pipelined(iter(chunks), out_int16=False)
    want = decoder("cpu").decode_he_pipelined(iter(chunks), out_int16=False)
    for g, w in zip(got, want, strict=True):
        _he_close(g, w, "pipelined", TI.HE_ROUTE_TOL)


def test_he_routes_on_card_match_cpu(dev):
    """decode_adts on an HE stream whose core carries TNS, the streaming
    decoder, and step_he_raw over a mid-chunk SBR header change (the slot
    replays one chunk on the float64 path and re-adopts)."""
    from aacjax_torch.host import sbr as S
    stream = TI.he_stream(8, ch=2, tns=True)
    n0 = tns.launches
    got, rate = aacjax_torch.decode_adts(stream, chunk_frames=4, device=dev)
    assert tns.launches > n0 and rate == 44100
    want, _ = aacjax_torch.decode_adts(stream, chunk_frames=4, device="cpu")
    _he_close(got, want, "decode_adts", TI.HE_ROUTE_TOL)

    def streaming(device):
        d = aacjax_torch.AACDecoder(device=device)
        d.feed(TI.he_stream(5, ch=1))
        out = []
        while (c := d.read_chunk()) is not None:
            out.append(c)
        return np.concatenate(out)
    _he_close(streaming(dev), streaming("cpu"), "AACDecoder",
              TI.HE_ROUTE_TOL)

    h2 = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0,
                     limiter_gains=1)
    payloads = TI.adts_payloads(TI.he_stream(8, ch=1, header_at={4: h2}))
    config = TI.parse_asc(TI.adts.synthesize_cookie(
        TI.adts.split_frames(TI.he_stream(1, ch=1))[0][0]))
    decs = [aacjax_torch.BatchDecoder([config], chunk_frames=3, device=d)
            for d in (dev, "cpu")]
    for k in range(3):
        outs = [d.step_he_raw([payloads[3 * k:3 * k + 3]]) for d in decs]
        assert [d._sbr_np_sticky[0] for d in decs] == [k == 1] * 2, k
        _he_close(outs[0], outs[1], f"header change chunk {k}",
                  TI.HE_ROUTE_TOL)


# -- HE-AAC v2 (Parametric Stereo) ------------------------------------------------
def _decorr_args(dev, seed, B, S, is34):
    """Planes, state and constants of the fused decorrelator on `dev`."""
    from aacjax_torch.kernels import ps_batch as PB
    s_r, s_i, state = TI.ps_decorr_inputs(seed, B, S, is34)
    return (torch.from_numpy(s_r).to(dev), torch.from_numpy(s_i).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in state.items()},
            PB._consts(is34, dev), PB._SDB[is34])


@pytest.mark.parametrize("B,T", [(1024, 8), (5, 2), (3, 1), (1, 1), (7, 3)])
@pytest.mark.parametrize("is34", [False, True])
def test_ps_decorr_kernel_equals_plain_bit_for_bit(dev, is34, B, T):
    """The fused decorrelator, two calls with the state carried (the
    second on the planes reversed along the slots); d and every state
    tensor bit for bit (one f32 operation at a time in the same order).
    Includes T = 1 (one tile: the history only from the state) and B that
    no multiple of a few rows covers."""
    s_r, s_i, state, c, sdb = _decorr_args(dev, B + T + is34, B, 32 * T,
                                           is34)
    st_k = st_p = state
    for k in range(2):
        x = ((s_r, s_i) if k == 0
             else tuple(a.flip(1).contiguous() for a in (s_r, s_i)))
        before = ps_decorr.launches
        got = ps_decorr.decorrelate_chunk(*x, st_k, c, sdb)
        assert ps_decorr.launches == before + 1
        want = ps_decorr.decorrelate_chunk_ref(*x, st_p, c, sdb)
        torch.cuda.synchronize()
        for i in range(2):
            assert _bits_equal(got[i], want[i]), (k, i, float(
                (got[i] - want[i]).abs().max()))
        for key in ps_decorr.STATE_KEYS:
            assert _bits_equal(got[2][key], want[2][key]), (k, key)
        assert bool(torch.isfinite(got[0]).all())
        st_k, st_p = got[2], want[2]


def test_ps_decorr_one_launch_per_chunk_and_mode(dev):
    """One launch per sbr_ps_apply, two per dual (20 + 34-band) chunk."""
    from aacjax_torch.kernels import ps_batch as PB
    core, planes, ps, cfg, state, ps20 = TI.sbr_ps_apply_inputs(8, 2, dev)
    ps34 = PB.ps_state_init(core.shape[0], True, dev)
    before = ps_decorr.launches
    PB.sbr_ps_apply(core, planes, ps, state, ps20, cfg)
    assert ps_decorr.launches == before + 1
    mixed = dict(ps, slot_is34=(torch.arange(core.shape[0], device=dev) % 2
                                ).float())
    PB.sbr_ps_apply_dual(core, planes, mixed, state, ps20, ps34, cfg)
    torch.cuda.synchronize()
    assert ps_decorr.launches == before + 3


def test_ps_decorr_wrapper_refuses_what_the_kernel_does_not_take(dev):
    s_r, s_i, state, c, sdb = _decorr_args(dev, 1, 4, 32, False)
    run = ps_decorr.decorrelate_chunk
    with pytest.raises(TypeError, match="s_r"):
        run(s_r.double(), s_i, state, c, sdb)
    with pytest.raises(ValueError, match="ap_r"):
        run(s_r, s_i, dict(state, ap_r=state["ap_r"][:, :-1]), c, sdb)
    wide = torch.zeros(4, 32, s_i.shape[2] + 1, device=dev)
    with pytest.raises(ValueError, match="s_i: not contiguous"):
        run(s_r, wide[..., :-1], state, c, sdb)
    flat = torch.zeros(s_i.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="s_i: address not aligned"):
        run(s_r, flat[1:].view(s_i.shape), state, c, sdb)
    with pytest.raises(ValueError, match="on cpu"):
        run(s_r, s_i, state,
            dict(c, **{k: c[k].cpu() for k in ps_decorr.CONST_KEYS}), sdb)
    with pytest.raises(ValueError, match="whole frames"):
        run(s_r[:, :16].contiguous(), s_i[:, :16].contiguous(), state, c, sdb)


def test_decode_he_pipelined_ps_on_card_matches_cpu(dev):
    """16 HE-AAC v2 streams (C = 32 slots), 2 chunks of 8: one tail and one
    decorrelator launch a chunk; int16 PCM equals step_he_raw's on the card
    and f32 PCM matches the CPU."""
    config, chunks = _he_serving_chunks(True)

    def decoder(device):
        return aacjax_torch.BatchDecoder([config] * 16, chunk_frames=8,
                                         cce_slots=1, device=device)
    before = (tail.launches, ps_decorr.launches)
    got = list(decoder(dev).decode_he_pipelined(iter(chunks), out_int16=True))
    assert (tail.launches, ps_decorr.launches) == (before[0] + 2,
                                                   before[1] + 2)
    step = decoder(dev)
    for g, c in zip(got, chunks, strict=True):
        TI.assert_pcm_close(g, step.step_he_raw(c, out_int16=True), True)
    got = decoder(dev).decode_he_pipelined(iter(chunks), out_int16=False)
    want = decoder("cpu").decode_he_pipelined(iter(chunks), out_int16=False)
    for g, w in zip(got, want, strict=True):
        _he_close(g, w, "pipelined", TI.HE_ROUTE_TOL)


def test_ps_routes_on_card_match_cpu(dev):
    """decode_adts on a 20-band and a 34-band stream with IPD/OPD, a mixed
    20/34 batch through the dual program, a band-scheme flip (sticky for
    one chunk, re-adopted), the streaming decoder and a save / restore
    mid-stream, each on the card against the same calls on the CPU."""
    specs = TI.ps_specs()
    for name in ("20-band", "34-band"):
        stream = TI.ps_stream(specs[name])
        got, rate = aacjax_torch.decode_adts(stream, chunk_frames=4,
                                             device=dev)
        want, _ = aacjax_torch.decode_adts(stream, chunk_frames=4,
                                           device="cpu")
        assert rate == 44100 and got.shape[1] == 2
        _he_close(got, want, f"decode_adts {name}", TI.HE_ROUTE_TOL)

    def batch(streams, chunk, device, hook=None):
        pays = [TI.adts_payloads(s) for s in streams]
        cfg = TI.parse_asc(TI.adts.synthesize_cookie(
            TI.adts.split_frames(streams[0])[0][0]))
        d = aacjax_torch.BatchDecoder([cfg] * len(streams), chunk_frames=chunk,
                                      cce_slots=1, device=device)
        n = min(len(p) for p in pays) // chunk
        outs = []
        for k in range(n):
            outs.append(d.step_he_raw([p[k * chunk:(k + 1) * chunk]
                                       for p in pays]))
            if hook:
                hook(k, d)
        return np.concatenate(outs, axis=1), d

    mixed = [TI.ps_stream(specs["20-band 2 env"], 6, 1),
             TI.ps_stream(specs["34-band 2 env"], 6, 2)]
    got, d = batch(mixed, 3, dev)
    assert not any(d._sbr_np_sticky) and d._ps_slot_is34[2] is True
    _he_close(got, batch(mixed, 3, "cpu")[0], "mixed 20/34",
              TI.HE_ROUTE_TOL)
    sticky = []
    flip = [TI.ps_flip_stream([2] * 4 + [1] * 4)]
    got, d = batch(flip, 2, dev, lambda k, d: sticky.append(
        d._sbr_np_sticky[0]))
    assert sticky == [False, False, True, False]
    _he_close(got, batch(flip, 2, "cpu")[0], "flip", TI.HE_ROUTE_TOL)

    stream = TI.ps_stream(specs["20-band"], 6, 3)

    def streaming(device):
        d = aacjax_torch.AACDecoder(device=device)
        d.feed(stream)
        out = []
        while (c := d.read_chunk()) is not None:
            out.append(c.reshape(-1, d.output_channels))
        return np.concatenate(out)
    got = streaming(dev)
    assert got.shape[1] == 2
    _he_close(got, streaming("cpu"), "AACDecoder", TI.HE_ROUTE_TOL)

    pays = TI.adts_payloads(stream)
    cfg = TI.parse_asc(TI.adts.synthesize_cookie(
        TI.adts.split_frames(stream)[0][0]))
    outs = {}
    for device in (dev, "cpu"):
        d = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                      device=device)
        d.step_he_raw([pays[:3]])
        d2 = aacjax_torch.BatchDecoder([cfg], chunk_frames=3, cce_slots=1,
                                       device=device)
        d2.restore_state(d.save_state())
        outs[device] = d2.step_he_raw([pays[3:6]])
        np.testing.assert_array_equal(outs[device], d.step_he_raw([pays[3:6]]))
    _he_close(outs[dev], outs["cpu"], "after restore", TI.HE_ROUTE_TOL)


@pytest.mark.parametrize("ps", [False, True])
def test_he_kernel_core_within_the_he_bound_of_the_plain_core(dev, ps):
    """Each chunk's host phase once, its core on the kernel route (the tail
    kernel's FFT IMDCT) and on the plain route (the dense IMDCT) of two
    decoders on the card, each core through its decoder's SBR (and PS)
    program to int16 PCM: frames 0-1 of a stream within TI.HE_I16_ONSET,
    later frames within TI.HE_I16_STEADY."""
    config, chunks = _he_serving_chunks(ps)
    ver, plain = (aacjax_torch.BatchDecoder([config] * 16, chunk_frames=8,
                                            cce_slots=int(ps), device=dev)
                  for _ in range(2))
    plain._sbr_init()     # it runs no host phase of its own: ver's feeds both
    pairs = []
    for k, chunk in enumerate(chunks):
        parsed, dense, ctx = ver._he_host_phase(chunk, True)
        core_k = ver._device_step(ver._upload_batch(dict(parsed)))
        core_p = plain._device_step(plain._upload_batch(dict(parsed)),
                                    use_pallas=False)
        pairs.append((ver._sbr_stage(core_k, dense, ctx, True).copy(),
                      plain._sbr_stage(core_p, dense, ctx, True).copy(),
                      8 * k))
    _assert_he_bound(pairs)


# -- the user surfaces ------------------------------------------------------------
def _tone_adts():
    """24 frames of an LC stereo tone as ADTS."""
    return TI.encode_adts(TI.tone_pcm(1024 * 24), target_sf=120)


@pytest.mark.parametrize("kind", ["lc", "he"])
def test_decode_m4a_on_card_matches_cpu(dev, kind):
    """An LC .m4a (its gapless trim exact) and an HE .m4a (explicit SBR)
    decoded on the card against the same call on the CPU."""
    pcm = TI.tone_pcm(1024 * 24)
    data = (aacjax_torch.encode_m4a(pcm, 44100) if kind == "lc" else
            aacjax_torch.HEAACEncoder(44100, 2, 40_000).encode_m4a(pcm))
    got, rate = aacjax_torch.decode_m4a(data, device=dev)
    want, want_rate = aacjax_torch.decode_m4a(data, device="cpu")
    assert rate == want_rate
    if kind == "lc":
        assert got.shape[0] == pcm.shape[0]
        TI.assert_pcm_close(got, want, False)
    else:
        _he_close(got, want, "decode_m4a HE", TI.HE_ROUTE_TOL)


def test_aac_file_reads_on_card_equal_a_full_decode(dev):
    """AACFile's ranged reads of an LC stream equal the same slices of a
    full decode on the card bit for bit; an HE seek read (an SBR header in
    every frame) converges to the full decode (> 60 dB)."""
    from aacjax_torch.host import sbr as S
    stream = _tone_adts()
    full, _ = aacjax_torch.decode_adts(stream, device=dev)
    f = aacjax_torch.AACFile(stream, device=dev)
    for start, n in ((0, 1024), (5 * 1024, 1024), (5 * 1024 + 137, 2000),
                     (22 * 1024 + 512, 4096), (3 * 1024, 1), (9000, 20000)):
        np.testing.assert_array_equal(f.read(start, n),
                                      full[start:start + n])
    hdr = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    he = TI.he_stream(24, ch=2, header_at=dict.fromkeys(range(24), hdr))
    he_full, _ = aacjax_torch.decode_adts(he, chunk_frames=8, device=dev)
    start, n = 20 * 2048, 2 * 2048
    seek = aacjax_torch.AACFile(he, chunk_frames=8, device=dev).read(start, n)
    ref = he_full[start:start + n]
    snr = 10 * np.log10(float(np.sum(ref ** 2)) / max(
        float(np.sum((seek - ref) ** 2)), 1e-30))
    assert snr > 60.0, snr


def test_aurora_pipe_on_card_matches_decode_adts(dev):
    """The ADTS demuxer piped into AuroraDecoder, fed in pieces of 1000
    bytes, against decode_adts on the card (the reference's 2e-4)."""
    from aacjax_torch import aurora
    stream = _tone_adts()
    full, _ = aacjax_torch.decode_adts(stream, device=dev)
    demux = aurora.ADTSDemuxer()
    dec = demux.pipe(aurora.AuroraDecoder(device=dev))
    chunks = []
    dec.on("data", chunks.append)
    for off in range(0, len(stream), 1000):
        demux.feed(stream[off:off + 1000])
        dec.decode_all()
    demux.end()
    piped = np.concatenate(chunks).reshape(-1, 2)
    assert piped.shape == full.shape
    assert float(np.abs(piped - full).max()) <= 2e-4


def test_cli_info_and_decode_on_card(dev, tmp_path, capsys):
    """`aacjax_torch.cli info` names the card and both native libraries;
    `python -m aacjax_torch.cli decode` by subprocess (on the card, its
    default) writes every sample."""
    import json
    import pathlib
    import subprocess
    import sys
    from aacjax_torch import cli
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["cuda_device"] == torch.cuda.get_device_name(0), info
    assert info["native_parser"] and info["native_writer"], info
    stream = _tone_adts()
    src = tmp_path / "in.aac"
    src.write_bytes(stream)
    r = subprocess.run([sys.executable, "-m", "aacjax_torch.cli", "decode",
                        str(src), str(tmp_path / "out.wav")],
                       capture_output=True, text=True, timeout=300,
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr[-800:]
    decoded = json.loads(r.stdout.strip().splitlines()[-1])
    full, _ = aacjax_torch.decode_adts(stream, device=dev)
    assert decoded["samples"] == full.shape[0], decoded


def test_good_stream_beside_garbage_on_card_equals_its_solo_decode(dev):
    """Two copies of a good stream in one batch with two streams of random
    bytes: the garbage streams fail, the good ones decode as the stream
    does alone."""
    stream = _tone_adts()
    rng = np.random.default_rng(3)
    cfg = TI.lc_stereo_config()
    good = TI.adts_payloads(stream)[:16]
    garbage = [rng.integers(0, 256, size=200).astype(np.uint8).tobytes()
               for _ in range(16)]
    both = aacjax_torch.BatchDecoder([cfg] * 4, chunk_frames=16, device=dev)
    pcm = both.step_raw([good, garbage, garbage, good], out_int16=False)
    assert [st.failed for st in both.streams] == [False, True, True, False]
    solo = aacjax_torch.BatchDecoder([cfg], chunk_frames=16, device=dev)
    want = solo.step_raw([good], out_int16=False)
    peak = max(float(np.abs(want[:2]).max()), 1e-9)
    for rows in (pcm[:2], pcm[6:8]):
        assert float(np.abs(rows - want[:2]).max()) / peak <= 1e-5


# -- the mesh -------------------------------------------------------------------
def _virtual_mesh(n_stream, n_frame):
    """An n_stream x n_frame mesh of virtual shards of card 0."""
    from aacjax_torch.runtime import mesh as meshlib
    return meshlib.make_mesh(n_stream, n_frame, devices=[
        torch.device("cuda", 0)] * (n_stream * n_frame))


def _mesh_run(configs, chunks, mesh, dev):
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=8, device=dev)
    outs = list(dec.decode_pipelined(iter(chunks), out_int16=True,
                                     mesh=mesh))
    return outs, dec


@pytest.mark.parametrize("shards", [2, 4])
def test_virtual_mesh_bit_equal_to_unsharded(dev, shards):
    """A 2x1 and a 4x1 mesh of virtual shards on one card: 32 stereo
    streams (32 or 16 slots a shard, the fused tail on every shard as
    unsharded), every chunk bit-equal to the unsharded run, one tail launch
    a shard a chunk."""
    from aacjax_torch.testing.streams import make_lc_payload_chunks
    configs, chunks = make_lc_payload_chunks(n_streams=32, chunk_frames=8,
                                             n_chunks=3, seed=2)
    want, d0 = _mesh_run(configs, chunks, None, dev)
    m = _virtual_mesh(shards, 1)
    before = tail.launches
    got, d1 = _mesh_run(configs, chunks, m, dev)
    assert tail.launches - before == shards * len(chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert torch.equal(d1.overlap, d0.overlap)


def test_two_card_mesh_matches_unsharded(dev):
    """A 2x1 mesh of two cards (peer copies of the state between them at a
    mesh change): every chunk bit-equal to one card's run, and the decoder
    goes on without a mesh afterwards."""
    n = torch.cuda.device_count()
    if n < 2:
        reason = f"needs 2 CUDA devices, this machine has {n}"
        print(reason)
        pytest.skip(reason)
    from aacjax_torch.runtime import mesh as meshlib
    from aacjax_torch.testing.streams import make_lc_payload_chunks
    configs, chunks = make_lc_payload_chunks(n_streams=32, chunk_frames=8,
                                             n_chunks=3, seed=2)
    want, d0 = _mesh_run(configs, chunks, None, dev)
    m = meshlib.make_mesh(2, 1)
    assert m.row_devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    got, d1 = _mesh_run(configs, chunks, m, dev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert d1._ov.devices == m.row_devices
    assert torch.equal(d1.overlap, d0.overlap)
    assert d1.overlap.device == torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["lc", "main"])
def test_virtual_mesh_frame_axis_matches_unsharded(dev, kind):
    """A 2x2 mesh of virtual shards of one card, the frame axis (the
    overlap and, for Main, the predictor's state handed from frame shard to
    frame shard), against the unsharded card run, one launch a shard a
    chunk.  LC: int16 PCM within 1 LSB on < 2% of samples, and the carry
    after each of three chunks, stepped, within 3e-3; Main: f32 PCM within
    5e-5 * max(1, max|ref|), a predictor and a synthesis launch a shard,
    no tail."""
    from aacjax_torch.testing.streams import make_lc_payload_chunks
    m = _virtual_mesh(2, 2)
    if kind == "lc":
        configs, chunks = make_lc_payload_chunks(n_streams=8, chunk_frames=8,
                                                 n_chunks=3, seed=2)
        T, out_int16 = 8, True
    else:
        cfg, corpus = TI.main_serving_corpus(4, 12)
        chunks = _chunked([corpus[i % 4] for i in range(8)], 4)
        configs, T, out_int16 = [cfg] * 8, 4, False

    def decoder():
        return aacjax_torch.BatchDecoder(configs, chunk_frames=T, device=dev)

    def run(mesh):
        return [o.copy() for o in decoder().decode_pipelined(
            iter(chunks), out_int16=out_int16, mesh=mesh)]
    want = run(None)
    before = (tail.launches, pred.launches, synth.launches)
    got = run(m)
    n = 4 * len(chunks)
    counted = (tail.launches - before[0], pred.launches - before[1],
               synth.launches - before[2])
    assert counted == ((n, 0, 0) if kind == "lc" else (0, n, n)), counted
    for g, w in zip(got, want, strict=True):
        TI.assert_pcm_close(g, w, out_int16)
    if kind == "lc":
        a, b = decoder(), decoder()
        for chunk in chunks:
            a.step_raw(chunk, out_int16=True)
            b.finalize_step(b._device_step(
                b._parse_native(chunk, compact=True), True, mesh=m))
            assert float((a.overlap - b.overlap).abs().max()) <= 3e-3


@pytest.mark.parametrize("ps", [False, True])
def test_virtual_mesh_he_matches_unsharded(dev, ps):
    """HE-AAC v1 and v2 (16 streams, 2 chunks of 8) through
    decode_he_pipelined on a 4x1 mesh of virtual shards of one card against
    the unsharded card run: f32 PCM within 1e-5 * max(1, max|ref|) (the
    reference's dry-run bar), int16 PCM within the HE bound; one tail and,
    for PS, one decorrelator launch a shard a chunk."""
    config, chunks = _he_serving_chunks(ps)
    m = _virtual_mesh(4, 1)

    def run(mesh, out_int16):
        dec = aacjax_torch.BatchDecoder([config] * 16, chunk_frames=8,
                                        cce_slots=int(ps), device=dev)
        return [o.copy() for o in dec.decode_he_pipelined(
            iter(chunks), out_int16=out_int16, mesh=mesh)]
    for out_int16 in (False, True):
        want = run(None, out_int16)
        before = (tail.launches, ps_decorr.launches)
        got = run(m, out_int16)
        assert (tail.launches - before[0], ps_decorr.launches - before[1]) \
            == (8, 8 if ps else 0)
        if out_int16:
            _assert_he_bound([(g, w, 8 * k) for k, (g, w) in
                              enumerate(zip(got, want, strict=True))])
        else:
            for k, (g, w) in enumerate(zip(got, want, strict=True)):
                _he_close(g, w, f"chunk {k}", 1e-5)


def test_dryrun_multichip_on_virtual_shards(dev):
    """graft_entry.dryrun_multichip(4) on four virtual shards of one card:
    the reference's five sharded paths, each held to its unsharded call."""
    from aacjax_torch import graft_entry
    lines = graft_entry.dryrun_multichip(
        4, devices=[torch.device("cuda", 0)] * 4)
    text = "\n".join(lines)
    assert lines[0].startswith("mesh 2x2")
    for path in ("decode_step pcm", "decode_spec_step", "HE-AAC core+SBR",
                 "encode_pipelined", "HE-AAC v2 SBR+PS"):
        assert path in text, path


# -- the compiled programs (runtime/graphs.py) -------------------------------------
def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _same_bits(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, i)


def _counts():
    return (tail.launches, synth.launches, tns.launches, pred.launches,
            ps_decorr.launches, enc_scans.spread_count.launches,
            enc_scans.rate_cost_count.launches)


def _program_case(name, dev):
    """(program, its eager function, call, owners, reset rows): call(fn,
    inputs, state) -> (outputs, new state); each owner is (its chunks'
    inputs, its first state), as two decoders or two virtual shards of a
    card would call one program."""
    import dataclasses
    from aacjax_torch.kernels import pipeline as P
    from aacjax_torch.kernels import ps_batch as PB
    from aacjax_torch.kernels import sbr_batch as SB
    from aacjax_torch.runtime import mesh as meshlib

    def on_dev(b):
        return {k: meshlib.packed_tensor(k, v, dev) for k, v in b.items()}

    if name.startswith("decode_spec_step"):
        kind = dict(tns=True, pred=True) if "pred" in name else dict(i16=True)
        flags = P.PipelineFlags(has_stereo=False, use_pallas=True,
                                out_int16="pred" not in name,
                                spec_i16="pred" not in name,
                                has_tns="pred" in name,
                                has_pred="pred" in name)
        C, T = 16, 4
        rng = np.random.default_rng(5)
        owners = []
        for o in range(2):
            ov = torch.from_numpy(rng.standard_normal((C, 1024)).astype(
                np.float32) * 100).to(dev)
            st = (ov, pred.pred_state_init(C, dev)) if flags.has_pred \
                else (ov,)
            owners.append(([on_dev(TI.spec_step_chunk(10 * o + k, C, T,
                                                      **kind))
                            for k in range(3)], st))
        return (P.jitted_decode_spec_step(flags),
                lambda b, *s: P.decode_spec_step(b, *s[:1], flags, *s[1:]),
                lambda fn, b, s: ((o := fn(b, *s))[0], o[1:]), owners, 2)
    if name == "decode_step":
        chunks = [TI.packed_step_chunks(2, 4, 3, seed=s) for s in (2, 7)]
        flags = chunks[0][0][0][1]
        for f in (f for ch, _ in chunks for _, f in ch):
            flags = dataclasses.replace(
                flags, has_short=flags.has_short or f.has_short,
                has_tns=flags.has_tns or f.has_tns)
        flags = dataclasses.replace(flags, use_pallas=True)
        C = chunks[0][1]
        owners = [([on_dev(b) for b, _ in ch],
                   (torch.zeros((C, 1024), device=dev),
                    pred.pred_state_init(C, dev))) for ch, _ in chunks]
        return (P.jitted_decode_step(flags),
                lambda b, *s: P.decode_step(b, s[0], flags, s[1]),
                lambda fn, b, s: ((o := fn(b, *s))[0], o[1:]), owners, 2)
    if name.startswith("sbr_apply"):
        i16 = name.endswith("i16")
        chunks, C = TI.he_program_chunks(4, 4, 6, dev)
        owners = [([(c["core"], c["dense"], c["cfg"]) for c in chunks[a:a + 3]],
                   (SB.sbr_state_init(C, dev),)) for a in (0, 3)]
        return (SB.jitted_sbr_apply(i16),
                lambda c, d, s, g: SB.sbr_apply(c, d, s, g, i16),
                lambda fn, x, s: ((o := fn(x[0], x[1], s[0], x[2]))[0],
                                  o[1:]), owners, 2)
    chunks, C = TI.he_program_chunks(4, 4, 6, dev, ps=True)
    if name == "sbr_ps_apply_dual":
        mask = (torch.arange(C, device=dev) % 2).float()
        owners = [([(c["core"], c["dense"], dict(c["ps"], slot_is34=mask),
                     c["cfg"]) for c in chunks[a:a + 3]],
                   (SB.sbr_state_init(C, dev), PB.ps_state_init(C, False, dev),
                    PB.ps_state_init(C, True, dev))) for a in (0, 3)]
        return (PB.jitted_sbr_ps_apply_dual(True),
                lambda c, d, p, s, a, b, g: PB.sbr_ps_apply_dual(
                    c, d, p, s, a, b, g, True),
                lambda fn, x, s: ((o := fn(*x[:3], *s, x[3]))[0], o[1:]),
                owners, 2)
    is34 = name.endswith("34")
    owners = [([(c["core"], c["dense"], c["ps"], c["cfg"])
                for c in chunks[a:a + 3]],
               (SB.sbr_state_init(C, dev), PB.ps_state_init(C, is34, dev)))
              for a in (0, 3)]
    return (PB.jitted_sbr_ps_apply(True, is34),
            lambda c, d, p, s, q, g: PB.sbr_ps_apply(c, d, p, s, q, g, True,
                                                     is34),
            lambda fn, x, s: ((o := fn(*x[:3], *s, x[3]))[0], o[1:]),
            owners, 2)


@pytest.mark.parametrize("name", ["decode_spec_step", "decode_spec_step_pred",
                                  "decode_step", "sbr_apply",
                                  "sbr_apply_i16", "sbr_ps_apply_20",
                                  "sbr_ps_apply_34", "sbr_ps_apply_dual"])
def test_graph_replays_equal_eager(dev, name):
    """Each compiled program against its eager function on the card, bit
    for bit, over three chunks of distinct inputs (a stale static input
    shows), with every chunk's outputs held until the end (a replay that
    overwrote an earlier chunk's shows), the carried state's first rows
    zeroed in place before the last chunk (what reset_stream writes), and
    two owners with their own state calling one graph in turn (two
    decoders, or two virtual shards of one card).  The launch counters
    count each replay's kernels as the eager call's."""
    from aacjax_torch.runtime import graphs
    # earlier tests' programs would fill the cache, and an entry evicted
    # mid-test (least recently used, graphs.MAX_ENTRIES) takes its replays
    # out of the count
    graphs.clear(dev)
    prog, eager, call, owners, reset_rows = _program_case(name, dev)
    replays = sum(e["replays"] for e in graphs.entries()
                  if e["name"] == prog.name)
    routes = dict(graph=prog, eager=eager)
    state = {(o, r): _clone(s) for o, (_, s) in enumerate(owners)
             for r in routes}
    held = {r: [] for r in routes}
    counted = {r: [] for r in routes}
    for k in range(3):
        if k == 2:
            for st in state.values():
                for t in _leaves(st):
                    t[:reset_rows] = 0
        for o, (chunks, _) in enumerate(owners):
            for r, fn in routes.items():
                before = _counts()
                out, state[o, r] = call(fn, _clone(chunks[k]), state[o, r])
                counted[r].append(tuple(b - a for a, b in
                                        zip(before, _counts())))
                held[r].append(out)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(held["graph"], held["eager"])):
        _same_bits(g, w, f"{name} call {k}")
    for o in range(len(owners)):
        _same_bits(state[o, "graph"], state[o, "eager"], f"{name} state {o}")
    assert counted["graph"] == counted["eager"]
    now = sum(e["replays"] for e in graphs.entries()
              if e["name"] == prog.name)
    assert now - replays >= 3 * len(owners) - 1


def test_encoder_graphs_equal_eager(dev):
    """The encoder's analysis and quantize programs against their eager
    functions on the card, bit for bit, over three chunks of two owners,
    every output held until the end."""
    from aacjax_torch import encode_batch as EB
    from aacjax_torch.runtime import graphs
    graphs.clear(dev)        # one entry a name; none evicted mid-test
    enc, chunks = TI.encoder_program_chunks(4, 4, 6)
    nF = 4
    psy = enc._psy_key()
    prog = EB._jitted_analysis(enc._si, enc._cutoff_bin, EB.FRAME, nF, psy)
    eager = EB._analysis_fn(enc._si, enc._cutoff_bin, EB.FRAME, nF, psy, dev)
    quant, quant_eager = EB._jitted_quantize(enc._w8), EB._quantize_fn(enc._w8)
    held = {"graph": [], "eager": []}
    n0 = {e["name"]: e["replays"] for e in graphs.entries()}
    for k in range(3):
        for o in (0, 3):
            ins = [torch.from_numpy(a).to(dev) for a in chunks[o + k]]
            outs = {r: fn(*_clone(ins)) for r, fn in
                    (("graph", prog), ("eager", eager))}
            off, _ = enc._rate_choice(outs["eager"][3].cpu().numpy(), nF)
            q_in = (*[outs["eager"][i] for i in (0, 1, 2, 4)],
                    torch.from_numpy(off).to(dev), ins[2].reshape(-1))
            for r, fn in (("graph", quant), ("eager", quant_eager)):
                held[r].append((outs[r], fn(*_clone(q_in))))
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(held["graph"], held["eager"])):
        _same_bits(g, w, f"encoder call {k}")
    now = {e["name"]: e["replays"] for e in graphs.entries()}
    for name in ("encode_analysis", "encode_quantize"):
        assert now[name] - n0.get(name, 0) >= 5, name


def test_graph_capture_failure_raises(dev):
    """A program that synchronises with the host cannot be captured: the
    call raises (its warm-up ran, its capture failed), nothing is kept, and
    the device goes on working."""
    from aacjax_torch.runtime import graphs
    prog = graphs.Program("host_sync", lambda x: x * float(x.sum()))
    x = torch.ones(4, device=dev)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="host_sync: CUDA graph "
                                                "capture failed"):
            prog(x)
    assert "host_sync" not in [e["name"] for e in graphs.entries()]
    torch.cuda.synchronize()
    assert float((torch.ones(3, device=dev) * 2).sum()) == 6.0


# -- the batched encoder's scan kernels --------------------------------------------
def _psy_rolloffs():
    """(up, down, smr) as the analysis program makes them from PsyParams."""
    from aacjax_torch.encode import PsyParams
    p = PsyParams()
    return tuple(float(np.float32(10.0 ** (-db / 10.0))) for db in (
        p.spread_up_db, p.spread_down_db, p.smr_db))


# (N, sample rate, cutoff bin, share of short rows): ENC-512's chunk, and two
# odd shapes (a mono 32 kHz chunk of 37 streams x 3 frames; one short row at
# 48 kHz, whose long rows would pad)
ENC_SCAN_SHAPES = [(16384, 44100, 542, 0.25), (111, 32000, 746, 0.3),
                   (1, 48000, 826, 1.0)]


@pytest.mark.parametrize("N,sample_rate,cutoff_bin,short_share",
                         ENC_SCAN_SHAPES)
def test_enc_spread_kernel_equals_plain_bit_for_bit(dev, N, sample_rate,
                                                    cutoff_bin, short_share):
    d = TI.enc_scans_random(N, N, sample_rate, cutoff_bin, short_share)
    e = torch.from_numpy(d["e"]).to(dev)
    before = enc_scans.spread_count.launches
    got = enc_scans.spread(e, *_psy_rolloffs())
    assert enc_scans.spread_count.launches == before + 1
    want = enc_scans.spread_ref(e, *_psy_rolloffs()).contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("N,sample_rate,cutoff_bin,short_share",
                         ENC_SCAN_SHAPES)
def test_enc_rate_cost_kernel_equals_plain_bit_for_bit(dev, N, sample_rate,
                                                       cutoff_bin,
                                                       short_share):
    from aacjax_torch import encode_batch as EB
    d = TI.enc_scans_random(N, N, sample_rate, cutoff_bin, short_share)
    args = [torch.from_numpy(d[k]).to(dev) for k in (
        "t34", "is_short", "regions", "base", "fit_sf", "zero_sf")]
    offsets = tuple(EB.OFF_GRID.tolist())
    before = enc_scans.rate_cost_count.launches
    got = enc_scans.rate_cost(*args, offsets)
    assert enc_scans.rate_cost_count.launches == before + 1
    t34, is_short, regions = args[:3]
    region = torch.where(is_short[:, None], regions[1], regions[0])
    want = enc_scans.rate_cost_ref(
        t34, region, *args[3:], enc_scans._constants(offsets, dev)["lut"],
        offsets)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (seed, N, Pe, nb, share of short rows, odd band edges, K): one offset and
# 32 (two passes over each row), the widest coded region with the most bands,
# Ns that no block of four rows divides, all-short and all-long rows, and
# band edges inside pairs (a pair's bins in two bands)
GRID_SHAPES = [(1, 4099, 544, 36, 0.25, False, 1),
               (2, 4099, 544, 36, 0.25, False, 32),
               (3, 2049, 1024, 63, 0.3, False, 16),
               (4, 1023, 768, 49, 1.0, False, 16),
               (5, 1023, 768, 49, 0.0, False, 16),
               (6, 515, 1024, 63, 0.5, True, 32)]


@pytest.mark.parametrize("seed,N,Pe,nb,short_share,odd_bands,K", GRID_SHAPES)
def test_enc_rate_cost_kernel_at_every_shape_it_takes(dev, seed, N, Pe, nb,
                                                      short_share, odd_bands,
                                                      K):
    d = TI.enc_grid_random(seed, N, Pe, nb, short_share, odd_bands)
    args = [torch.from_numpy(d[k]).to(dev) for k in (
        "t34", "is_short", "regions", "base", "fit_sf", "zero_sf")]
    offsets = tuple(float(o) for o in np.round(np.linspace(-60, 64, K)))
    before = enc_scans.rate_cost_count.launches
    got = enc_scans.rate_cost(*args, offsets)
    assert enc_scans.rate_cost_count.launches == before + 1
    t34, is_short, regions = args[:3]
    region = torch.where(is_short[:, None], regions[1], regions[0])
    want = enc_scans.rate_cost_ref(
        t34, region, *args[3:], enc_scans._constants(offsets, dev)["lut"],
        offsets)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("N,nb", [(1, 49), (16385, 36), (16385, 63)])
def test_enc_spread_kernel_at_edge_row_counts(dev, N, nb):
    """One row, and one row past ENC-512's 16384 (a last block of one row),
    at the widest band layout too."""
    rng = np.random.default_rng(N + nb)
    e = (np.exp(rng.normal(0.0, 3.0, (N, nb))) * 1e4).astype(np.float32)
    e[rng.random((N, nb)) < 0.1] = 0.0
    e = torch.from_numpy(e).to(dev)
    before = enc_scans.spread_count.launches
    got = enc_scans.spread(e, *_psy_rolloffs())
    assert enc_scans.spread_count.launches == before + 1
    want = enc_scans.spread_ref(e, *_psy_rolloffs()).contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_enc_scan_wrappers_refuse_what_the_kernels_do_not_take(dev):
    e = torch.zeros((4, 36), device=dev)
    with pytest.raises(ValueError, match="nb"):
        enc_scans.spread(torch.zeros((4, 64), device=dev), 0.5, 0.5, 0.5)
    with pytest.raises(TypeError, match="dtype"):
        enc_scans.spread(e.double(), 0.5, 0.5, 0.5)
    d = TI.enc_scans_random(0, 4)
    args = [torch.from_numpy(d[k]).to(dev) for k in (
        "t34", "is_short", "regions", "base", "fit_sf", "zero_sf")]
    with pytest.raises(ValueError, match="Pe even"):
        enc_scans.rate_cost(args[0][:, :-1].contiguous(), *args[1:], (0.0,))
    with pytest.raises(ValueError, match="offsets"):
        enc_scans.rate_cost(*args, tuple([0.0] * 33))
    with pytest.raises(ValueError, match="regions"):
        enc_scans.rate_cost(*args[:2], args[2][:, :-2].contiguous(),
                            *args[3:], (0.0,))


def test_analysis_replays_count_each_scan_kernel_once(dev):
    """_jitted_analysis against its eager function over three chunks, bit for
    bit: every call, the first (warm-up and capture) and each replay, counts
    one launch of each scan kernel."""
    from aacjax_torch import encode_batch as EB
    enc, chunks = TI.encoder_program_chunks(3, 3, 3)
    key = (enc._si, enc._cutoff_bin, EB.FRAME, 3, enc._psy_key())
    prog = EB._jitted_analysis(*key)
    eager = EB._analysis_fn(*key, dev)
    for k, chunk in enumerate(chunks):
        ins = [torch.from_numpy(a).to(dev) for a in chunk]
        before = (enc_scans.spread_count.launches, enc_scans.rate_cost_count.launches)
        got = prog(*_clone(ins))
        assert (enc_scans.spread_count.launches, enc_scans.rate_cost_count.launches) == (
            before[0] + 1, before[1] + 1), k
        _same_bits(got, eager(*ins), f"analysis chunk {k}")


def test_batch_encoder_virtual_mesh_byte_identical(dev):
    """BatchEncoder on a 4x1 mesh of virtual shards of one card (4 channel
    rows a shard) against one device: two chunks byte-identical, one launch
    of each scan kernel a shard a chunk."""
    n = 4 * 1024
    pcm = TI.encode_serving_pcm(8, 2 * n)
    chunks = [pcm[:, k * n:(k + 1) * n] for k in range(2)]
    outs, launches = {}, {}
    for name, mesh in (("unsharded", None), ("4x1", _virtual_mesh(4, 1))):
        enc = aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=8,
                                        mesh=mesh)
        before = (enc_scans.spread_count.launches, enc_scans.rate_cost_count.launches)
        outs[name] = [enc.encode_chunk(c) for c in chunks]
        launches[name] = (enc_scans.spread_count.launches - before[0],
                          enc_scans.rate_cost_count.launches - before[1])
    assert outs["4x1"] == outs["unsharded"]
    assert launches == {"unsharded": (2, 2), "4x1": (8, 8)}


@pytest.mark.parametrize("sample_rate,channels,bitrate,S,frames", [
    (44100, 2, 128_000, 8, 16),   # the ENC traffic's chunk, fewer streams
    (32000, 1, 64_000, 37, 3),    # mono 32 kHz: N = 111, nb = 43, Pe = 768
])
def test_enc_scan_kernels_on_analysis_intermediates(dev, sample_rate,
                                                    channels, bitrate, S,
                                                    frames):
    """Both scan kernels on what the eager analysis program hands them for
    a real chunk, bit for bit against their plain versions."""
    enc = aacjax_torch.BatchEncoder(sample_rate, channels, bitrate,
                                    n_streams=S, device=dev)
    pcm = TI.encode_serving_pcm(S, frames * 1024)[:, :, :channels]
    seen, _ = TI.enc_scans_inputs(enc, pcm, dev)
    spread_args, spread_out = seen["spread"]
    rc_args, rc_out = seen["rate_cost"]
    t34, is_short, regions, base, fit_sf, zero_sf, offsets = rc_args
    region = torch.where(is_short[:, None], regions[1], regions[0])
    lut = enc_scans._constants(offsets, dev)["lut"]
    for got, want in (
            (spread_out, enc_scans.spread_ref(*spread_args)),
            (rc_out, enc_scans.rate_cost_ref(t34, region, base, fit_sf,
                                             zero_sf, lut, offsets))):
        assert got.shape == want.shape
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32))


def test_batch_encoder_analysis_on_card_matches_cpu(dev):
    """One chunk's analysis (64 stereo streams of 16 frames) on the card
    against the CPU: coefs within 1e-5 * max|coefs|; base and fit_sf equal
    on >= 99.9% of (row, band) entries, never more than one step apart; est
    within 1% of each row's largest.  Then the quantize on both devices fed
    the CPU's analysis: q equal on >= 99.99% of bins, never more than one
    step apart; sf equal."""
    from aacjax_torch import encode_batch as EB
    S = 64
    enc = aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=S,
                                    device=dev)
    _, pcm_i16, w_idx, is_short, nF = enc._prep_chunk(
        TI.encode_serving_pcm(S, 16 * 1024))
    host = [torch.from_numpy(a) for a in (pcm_i16, w_idx.astype(np.int64),
                                          is_short)]
    outs = {}
    for d in (dev, torch.device("cpu")):
        fn = EB._analysis_fn(enc._si, enc._cutoff_bin, EB.FRAME, nF,
                             enc._psy_key(), d)
        outs[d.type] = fn(*(a.to(d) for a in host))
    (c, b, f, e, bb), (c0, b0, f0, e0, bb0) = (
        [a.cpu().numpy() for a in outs[d]] for d in ("cuda", "cpu"))
    np.testing.assert_array_equal(bb, bb0)
    assert float(np.abs(c - c0).max()) <= 1e-5 * float(np.abs(c0).max())
    for got, want in ((b, b0), (f, f0)):
        diff = np.abs(got - want)
        assert float((diff != 0).mean()) <= 1e-3 and float(diff.max()) <= 1
    row = np.maximum(np.abs(e0).max(axis=1, keepdims=True), 1.0)
    assert float((np.abs(e - e0) / row).max()) <= 0.01
    cpu_enc = aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=S,
                                        device="cpu")
    off, _ = cpu_enc._rate_choice(e0, nF)
    short = torch.from_numpy(is_short.reshape(-1))
    q = {}
    for d, coder in ((dev, enc), (torch.device("cpu"), cpu_enc)):
        a = [t.to(d) for t in outs["cpu"]]
        q[d.type] = [t.cpu().numpy() for t in coder._quantize(
            a[0], a[1], a[2], a[4], torch.from_numpy(off).to(d),
            short.to(d))]
    np.testing.assert_array_equal(q["cuda"][1], q["cpu"][1])
    dq = np.abs(q["cuda"][0].astype(np.int32) - q["cpu"][0])
    assert float((dq != 0).mean()) <= 1e-4 and int(dq.max()) <= 1


def _encode_snrs(outs, pcm, config, T, device):
    """Each stream's SNR (dB) of `outs` (encode_chunk results, chunks of T
    frames) decoded through decode_pipelined on `device`, against its
    source pcm [S, n, 2]: the decode lags the source by one frame; the
    first chunk, where the bit estimate's calibration warms, and the last
    frame are left out."""
    S, L = pcm.shape[0], T * 1024
    payloads = [[p for o in outs for p in o[s]] for s in range(S)]
    dec = aacjax_torch.BatchDecoder([config] * S, chunk_frames=T,
                                    device=device)
    pcm_out = [o.copy() for o in dec.decode_pipelined(iter(
        [[p[k * T:(k + 1) * T] for p in payloads] for k in range(len(outs))]),
        out_int16=False)]
    snrs = []
    for s in range(S):
        got = np.concatenate([dec.stream_pcm(o, s, T) for o in pcm_out])
        ref = pcm[s, L:len(outs) * L - 1024].astype(np.float64)
        err = got[L + 1024:] * 32768.0 - ref
        snrs.append(float(10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2))))
    return snrs


def test_batch_encoder_pipelined_on_card(dev):
    """encode_pipelined on the card (8 stereo streams, 3 chunks of 8
    frames) against sequential encode_chunk on the card, byte for byte, one
    launch of each scan kernel a chunk; every stream decoded on the card
    (one tail launch a chunk) at an SNR within 0.5 dB of the same stream
    encoded and decoded on the CPU route."""
    S, T, n = 8, 8, 3
    L = T * 1024
    pcm = TI.encode_serving_pcm(S, n * L)
    chunks = [pcm[:, k * L:(k + 1) * L] for k in range(n)]

    def encoder(device):
        return aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=S,
                                         device=device)
    before = (enc_scans.spread_count.launches,
              enc_scans.rate_cost_count.launches)
    got = list(encoder(dev).encode_pipelined(iter(chunks)))
    assert (enc_scans.spread_count.launches,
            enc_scans.rate_cost_count.launches) == (before[0] + n,
                                                    before[1] + n)
    seq = encoder(dev)
    assert [seq.encode_chunk(c) for c in chunks] == got
    cpu = encoder("cpu")
    want = [cpu.encode_chunk(c) for c in chunks]
    t0 = tail.launches
    card = _encode_snrs(got, pcm, seq.config, T, dev)
    assert tail.launches == t0 + n
    ref = _encode_snrs(want, pcm, cpu.config, T, "cpu")
    assert max(abs(a - b) for a, b in zip(card, ref, strict=True)) <= 0.5
