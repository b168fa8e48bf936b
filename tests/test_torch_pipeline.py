"""The port's device steps against the JAX package's, on the CPU:
`decode_spec_step` for every flag the native route can set (prediction,
coupling entries after TNS and on the PCM, the q/sf transfer, the ELD
filterbank, frame lengths 960 / 512 / 480) on numpy-seeded chunks, and
`decode_step` on what `pack_frames` packs from python-parsed frames (M/S,
intensity, the three coupling points, TNS, prediction).

Tolerances: f32 PCM within 5e-5 * max(1, max|ref|); the carried overlap
within 3e-3 absolute on the random chunks (spectra of amplitude 300) and
within the PCM rule relative to its own peak on the packed frames, whose
synthetic audio reaches 1e8; the predictor state and the dequantized
spectra bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aacjax.host import native
from aacjax.kernels import pipeline as JP
from aacjax.runtime import pack as jpack
from aacjax.host import syntax as jsyntax
from aacjax.host.bitio import BitReader as JBitReader
from aacjax_torch import testing as TI
from aacjax_torch.host.bitio import BitReader
from aacjax_torch.host.syntax import decode_frame
from aacjax_torch.kernels import pipeline as P
from aacjax_torch.kernels import pred
from aacjax_torch.runtime.pack import pack_frames
from aacjax_torch.testing import assert_pcm_close


def chunk(seed, C, T, F=1024, has_short=True, amp=300.0, ragged=True):
    """A random native-format chunk: spec [C,T,F], meta [C,T,6] (all window
    sequences, EIGHT_SHORT only with has_short), the overlap [C,F].  With
    `ragged` channel 0 has no valid frame and the others a random count."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (C, T))
    if not has_short:
        seq = np.where(seq == 2, 0, seq)
    shape = rng.integers(0, 2, (C, T))
    prev = rng.integers(0, 2, (C, T))
    nval = rng.integers(1, T + 1, C) if ragged else np.full(C, T)
    if ragged:
        nval[0] = 0
        nval[-1] = T
    valid = np.arange(T)[None, :] < nval[:, None]
    meta = np.stack([seq * 2 + prev, seq * 2 + shape, shape, prev, seq == 2,
                     valid], axis=-1).astype(np.int32)
    return dict(
        spec=(rng.standard_normal((C, T, F)) * amp).astype(np.float32),
        meta=meta), (rng.standard_normal((C, F)) * amp / 3).astype(np.float32)


def run_both(batch, overlap, flags, pred_state=None):
    """decode_spec_step of both packages on the same numpy batch."""
    jflags = JP.PipelineFlags(**dataclasses.asdict(flags))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    extra_j = () if pred_state is None else (jnp.asarray(pred_state),)
    extra_t = () if pred_state is None else (torch.from_numpy(pred_state),)
    want = JP.decode_spec_step(jb, jnp.asarray(overlap), jflags, *extra_j)
    got = P.decode_spec_step(tb, torch.from_numpy(overlap), flags, *extra_t)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def check(want, got, out_int16=False, ov_atol=3e-3):
    assert len(want) == len(got)
    assert_pcm_close(got[0], want[0], out_int16)
    assert np.abs(got[1] - want[1]).max() <= ov_atol
    if len(want) == 3:       # the predictor state, bit for bit
        np.testing.assert_array_equal(got[2].view(np.uint32),
                                      want[2].view(np.uint32))


def pred_planes(seed, C, T):
    rng = np.random.default_rng(seed)
    mode = rng.choice([0, 1, 1, 1, 2], size=(C, T))
    reset = np.where(rng.random((C, T)) < 0.3, rng.integers(1, 31, (C, T)), 0)
    nbins = rng.choice([672, 640, 200], size=(C, T))
    return dict(
        pred_meta=np.stack([mode, reset, nbins], -1).astype(np.int32),
        pred_used_u8=np.repeat(rng.random((C, T, 42)) < 0.5, 16,
                               axis=-1).astype(np.uint8))


def tns_planes(seed, C, T):
    _, _, lpc, rng_ = TI.serving_tns_chunk(seed, C, T)
    return dict(tns_lpc=lpc, tns_range=rng_)


def test_unpack_spec_batch_matches_reference():
    batch, _ = chunk(0, 3, 5)
    batch.update(pred_planes(1, 3, 5))
    batch["cce_post_idx"] = np.array([[2, 0, 1], [2, 1, 4]], np.int32)
    batch["cce_time_idx"] = np.array([[1, 0, 0]], np.int32)
    want = JP._unpack_spec_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = P.unpack_spec_batch({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for k in ("f_idx", "s_idx", "shape_idx", "prev_shape_idx", "last_valid",
              "pred_mode", "pred_reset", "pred_nbins", "cce_post_src",
              "cce_post_dst", "cce_post_t", "cce_time_src", "cce_time_dst",
              "cce_time_t"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("is_short", "valid", "pred_used"):
        np.testing.assert_array_equal(got[k].numpy() != 0,
                                      np.asarray(want[k]) != 0, k)
    assert got["pred_used"].dtype == torch.uint8


@pytest.mark.parametrize("has_tns", [False, True])
def test_spec_step_prediction_matches_reference(has_tns):
    """Two chunks with the state carried; the second starts from the first
    chunk's state of each package (they are equal bit for bit)."""
    C, T = 4, 6
    state = np.array(JP.pred_state_init(C))
    flags = P.PipelineFlags(has_stereo=False, has_pred=True, has_tns=has_tns)
    for k in range(2):
        batch, overlap = chunk(10 + k, C, T)
        batch.update(pred_planes(20 + k, C, T))
        if has_tns:
            batch.update(tns_planes(30 + k, C, T))
        want, got = run_both(batch, overlap, flags, state)
        check(want, got)
        state = got[2]
    assert not np.array_equal(state, np.array(JP.pred_state_init(C)))


def test_spec_step_plain_route_leaves_the_batch_unchanged():
    batch, overlap = chunk(3, 2, 4)
    batch.update(pred_planes(4, 2, 4))
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    P.decode_spec_step(tb, torch.from_numpy(overlap),
                       P.PipelineFlags(has_stereo=False, has_pred=True),
                       pred.pred_state_init(2))
    for k, v in batch.items():
        np.testing.assert_array_equal(tb[k].numpy(), v)


def test_spec_step_coupling_after_tns_matches_reference():
    """Entries after TNS, two of them onto one (dst, t); a zero-gain entry
    does nothing."""
    C, T = 5, 4
    batch, overlap = chunk(5, C, T, ragged=False)
    batch.update(tns_planes(6, C, T))
    rng = np.random.default_rng(7)
    batch["cce_post_idx"] = np.array(
        [[4, 0, 1], [4, 1, 1], [3, 0, 1], [4, 2, 3], [4, 2, 0]], np.int32)
    gain = rng.uniform(0.2, 1.5, (5, 1024)).astype(np.float32)
    gain[4] = 0.0
    batch["cce_post_gain"] = gain
    flags = P.PipelineFlags(has_stereo=False, has_tns=True, has_cce_post=True)
    want, got = run_both(batch, overlap, flags)
    check(want, got)
    _, plain = run_both({k: v for k, v in batch.items() if "cce" not in k},
                        overlap, dataclasses.replace(flags,
                                                     has_cce_post=False))
    assert np.abs(got[0][0, 1] - plain[0][0, 1]).max() > 1e-4
    np.testing.assert_array_equal(got[0][2, 0], plain[0][2, 0])


def test_spec_step_coupling_on_pcm_matches_reference():
    C, T = 4, 3
    batch, overlap = chunk(8, C, T, ragged=False)
    batch["cce_time_idx"] = np.array([[3, 0, 0], [3, 1, 0], [2, 0, 0],
                                      [3, 1, 2]], np.int32)
    batch["cce_time_gain"] = np.array([0.5, -1.25, 2.0, 0.75], np.float32)
    flags = P.PipelineFlags(has_stereo=False, has_cce_time=True)
    want, got = run_both(batch, overlap, flags)
    check(want, got)


def test_spec_step_every_stage_together_matches_reference():
    C, T = 6, 8
    batch, overlap = chunk(9, C, T)
    batch.update(pred_planes(10, C, T))
    batch.update(tns_planes(11, C, T))
    batch["cce_post_idx"] = np.array([[5, 1, 2], [5, 2, 2]], np.int32)
    batch["cce_post_gain"] = np.random.default_rng(12).uniform(
        0.1, 1.0, (2, 1024)).astype(np.float32)
    batch["cce_time_idx"] = np.array([[4, 3, 1]], np.int32)
    batch["cce_time_gain"] = np.array([0.6], np.float32)
    flags = P.PipelineFlags(has_stereo=False, has_pred=True, has_tns=True,
                            has_cce_post=True, has_cce_time=True,
                            out_int16=True)
    want, got = run_both(batch, overlap, flags, np.array(JP.pred_state_init(C)))
    check(want, got, out_int16=True)


def qsf_chunk(seed, C, T, F=1024):
    rng = np.random.default_rng(seed)
    q = rng.integers(-40, 41, (C, T, F))
    q = np.where(rng.random((C, T, F)) < 0.02,
                 rng.integers(-8191, 8192, (C, T, F)), q).astype(np.int16)
    q[0, 0, :4] = (0, 8191, -8191, 1)
    sf = rng.integers(0, 256, (C, T, F // 4)).astype(np.uint8)
    sf[0, 0, 0] = 100
    return q, sf


def test_dequant_qsf_matches_reference_bit_for_bit():
    q, sf = qsf_chunk(13, 3, 4)
    want = np.asarray(JP.dequant_qsf(jnp.asarray(q), jnp.asarray(sf)))
    got = P.dequant_qsf(torch.from_numpy(q), torch.from_numpy(sf)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    iq, sfl = (np.asarray(a) for a in JP._qsf_luts())
    assert got[0, 0, 1] == iq[8191] * sfl[100] and got[0, 0, 2] == -got[0, 0, 1]


def test_spec_step_qsf_equals_the_f32_route_bit_for_bit():
    """spec_qsf through the step gives the bits of the same step on the
    dequantized f32 spectra, and matches the reference's step."""
    C, T = 4, 5
    batch, overlap = chunk(14, C, T)
    q, sf = qsf_chunk(15, C, T)
    sf = np.minimum(sf, 140).astype(np.uint8)        # keep the PCM finite
    meta = batch["meta"]
    flags = P.PipelineFlags(has_stereo=False, spec_qsf=True)
    want, got = run_both(dict(spec_q=q, spec_sf=sf, meta=meta), overlap, flags)
    check(want, got, ov_atol=5e-5 * float(np.abs(want[1]).max()))
    spec = P.dequant_qsf(torch.from_numpy(q), torch.from_numpy(sf)).numpy()
    _, f32 = run_both(dict(spec=spec, meta=meta), overlap,
                      P.PipelineFlags(has_stereo=False))
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  f32[0].view(np.uint32))
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  f32[1].view(np.uint32))


@pytest.mark.parametrize("N", [512, 480])
@pytest.mark.parametrize("T", [1, 2, 3, 16])
def test_spec_step_eld_matches_reference(N, T):
    """The low-delay filterbank at both ELD lengths: T = 1 (the streaming
    decoder), 2 and 3 (the short forms of the shifted add) and 16; channel 0
    has no valid frame and keeps its [3N] carry."""
    C = 4
    batch, _ = chunk(16 + T, C, T, F=N, has_short=False)
    overlap = (np.random.default_rng(N + T).standard_normal((C, 3 * N))
               * 100).astype(np.float32)
    flags = P.PipelineFlags(has_stereo=False, eld=True, has_short=False)
    want, got = run_both(batch, overlap, flags)
    assert got[1].shape == (C, 3 * N)
    check(want, got)
    np.testing.assert_array_equal(got[1][0], overlap[0])
    assert not np.array_equal(got[1][1], overlap[1])


@pytest.mark.parametrize("F,has_short", [(960, True), (512, False),
                                         (480, False)])
@pytest.mark.parametrize("out_int16", [False, True])
def test_spec_step_other_frame_lengths_match_reference(F, has_short,
                                                       out_int16):
    """960 with short windows (120 samples), the LD lengths long-only; with
    use_pallas set as the runtime sets it: these lengths take the plain
    filterbank, as in the reference."""
    C, T = 4, 5
    batch, overlap = chunk(F, C, T, F=F, has_short=has_short)
    flags = P.PipelineFlags(has_stereo=False, has_short=has_short,
                            out_int16=out_int16, use_pallas=True)
    want, got = run_both(batch, overlap, flags)
    check(want, got, out_int16=out_int16)


def test_spec_step_compact_spectra_at_960_match_reference():
    C, T, F = 3, 4, 960
    batch, overlap = chunk(21, C, T, F=F)
    blocks = batch.pop("spec").reshape(C, T, F // 16, 16)
    sc = np.maximum(np.abs(blocks).max(-1) / 32767.0, 1e-30).astype(np.float32)
    batch["spec_i16"] = np.clip(np.round(blocks / sc[..., None]), -32768,
                                32767).astype(np.int16).reshape(C, T, F)
    batch["spec_scale"] = sc
    want, got = run_both(batch, overlap,
                         P.PipelineFlags(has_stereo=False, spec_i16=True))
    check(want, got)


# -- decode_step on python-parsed, packed frames ------------------------------
def packed_both(payloads, jcfg, cfg, n_slots):
    """Parse with each package's python parser and pack with each packer;
    the two numpy batches must be equal."""
    jframes = [jsyntax.decode_frame(JBitReader(p), jcfg, [0] * n_slots)
               for p in payloads]
    frames = [decode_frame(BitReader(p), cfg, [0] * n_slots)
              for p in payloads]
    T = len(payloads)
    jb, jflags = jpack.pack_frames([(0, jframes)], n_slots, T)
    tb, flags = pack_frames([(0, frames)], n_slots, T)
    assert dataclasses.asdict(jflags) == dataclasses.asdict(flags)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k], k)
    return jb, tb, flags


def step_both(jb, tb, flags, C, overlap=None):
    jflags = JP.PipelineFlags(**dataclasses.asdict(flags))
    ov = np.zeros((C, 1024), np.float32) if overlap is None else overlap
    extra_j = (JP.pred_state_init(C),) if flags.has_pred else ()
    extra_t = (pred.pred_state_init(C),) if flags.has_pred else ()
    want = JP.decode_step({k: jnp.asarray(v) for k, v in jb.items()},
                          jnp.asarray(ov), jflags, *extra_j)
    tdev = {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.bool_
                                else v) for k, v in tb.items()}
    got = P.decode_step(tdev, torch.from_numpy(ov), flags, *extra_t)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def check_packed(want, got):
    assert_pcm_close(got[0], want[0], False)
    assert_pcm_close(got[1] / 32768.0, want[1] / 32768.0, False)
    if len(want) == 3:
        np.testing.assert_array_equal(got[2].view(np.uint32),
                                      want[2].view(np.uint32))


def test_decode_step_main_with_intensity_matches_reference():
    """Main-profile CPE frames with M/S, prediction, intensity, short
    windows and TNS: M/S, then the predictor, then intensity."""
    from aacjax.host.asc import make_asc, parse_asc
    payloads = TI.main_stereo_payloads(10, seed=0)
    payloads += TI.main_stereo_payloads(4, seed=5, intensity=True)
    jb, tb, flags = packed_both(payloads, parse_asc(make_asc(1, 4, 2)),
                                TI.main_config(2), 2)
    assert flags.has_pred and flags.has_tns and flags.has_stereo
    assert tb["is_scale"].any() and tb["ms_mask"].any()
    assert (tb["pred_mode"] == 2).any() and tb["pred_reset"].any()
    check_packed(*step_both(jb, tb, flags, 2))


@pytest.mark.parametrize("point", [0, 1, 2])
def test_decode_step_coupling_point_matches_reference(point):
    """A CPE with TNS and a CCE coupled onto both channels, before TNS,
    after TNS and on the PCM."""
    from aacjax.host.asc import make_asc, parse_asc
    payloads = TI.cce_stereo_payloads(3, seed=40 + point, point=point,
                                      target_tns=True)
    jb, tb, flags = packed_both(payloads, parse_asc(make_asc(2, 4, 2)),
                                TI.lc_stereo_config(), 3)
    assert flags.has_cce
    key = ("cce_gain_pre", "cce_gain_post", "cce_gain_time")[point]
    assert np.abs(tb[key]).max() > 0
    check_packed(*step_both(jb, tb, flags, 3))


def test_decode_step_int16_and_carried_overlap_match_reference():
    from aacjax.host.asc import make_asc, parse_asc
    pcm = TI.tone_pcm(1024 * 4)
    from aacjax_torch.testing import encoder as enc
    cfg = TI.lc_stereo_config()
    payloads = enc.encode_pcm_frames(pcm, cfg, target_sf=120)
    jb, tb, flags = packed_both(payloads, parse_asc(make_asc(2, 4, 2)), cfg, 2)
    flags = dataclasses.replace(flags, out_int16=True)
    ov = (np.random.default_rng(0).standard_normal((2, 1024)) * 500).astype(
        np.float32)
    want, got = step_both(jb, tb, flags, 2, ov)
    assert_pcm_close(got[0], want[0], True)
    assert np.abs(got[1] - want[1]).max() <= 3e-3


def test_pipeline_exports_what_the_packer_imports():
    assert (P.TNS_SLOTS, P.TNS_ORDER, P.PRED_BINS) == (
        JP.TNS_SLOTS, JP.TNS_ORDER, JP.PRED_BINS)
    assert [f.name for f in dataclasses.fields(P.PipelineFlags)] == [
        f.name for f in dataclasses.fields(JP.PipelineFlags)]
    assert native.TNS_SLOTS == P.TNS_SLOTS
