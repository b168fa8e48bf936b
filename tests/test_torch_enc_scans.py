"""The batched encoder's two scans (aacjax_torch/kernels/enc_scans.py) on
the CPU: the plain versions against independent float32 numpy versions of
the reference's `step_up` / `step_dn` and `est_at`
(aacjax/encode_batch.py:176-188, :364-387) and `spread_ref` against the
reference's own `spread` (its two `lax.scan`s, XLA on the CPU), all bit for
bit; the refactored analysis program against the loops it ran before, bit
for bit; the wrappers' CPU route.  The CUDA kernels are held to the plain
versions in tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: none.  Every comparison is of float32 bit patterns.
"""
import numpy as np
import pytest
import torch

import aacjax_torch
from aacjax_torch import encode_batch as TE
from aacjax_torch import testing as TI
from aacjax_torch.encode import _COST_LUTS, PsyParams
from aacjax_torch.kernels import enc_scans

F32 = np.float32
# the encoder's psy key (smr, up, down in dB) and its rolloffs as the
# analysis program makes them: up, down, smr
PSY_DB = (PsyParams().smr_db, PsyParams().spread_up_db,
          PsyParams().spread_down_db)
PSY = tuple(F32(10.0 ** (-v / 10.0)) for v in PSY_DB[1:] + PSY_DB[:1])
# (sample rate, cutoff bin) of BatchEncoder's stereo configurations:
# ENC-512's 44.1 kHz at 128 kbps (long and short rows code 544 bins), 22.05
# kHz at 64 kbps (short rows pad 736 bins to 768) and 48 kHz at 256 kbps
# (long rows pad 832 bins to 896)
CONFIGS = [(44100, 542), (22050, 728), (48000, 826)]


def assert_bits_equal(got, want, what=""):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    assert got.shape == want.shape, what
    diff = got.view(np.uint32) != want.view(np.uint32)
    assert not diff.any(), (f"{what}: {int(diff.sum())} of {diff.size} "
                            f"differ, first at {np.argwhere(diff)[0]}")


# -- independent numpy versions of the reference's scans -----------------------
def spread_np(e, up, down, smr):
    """step_up then step_dn over the bands, float32 numpy."""
    e = np.asarray(e, F32)
    eu, ed = np.empty_like(e), np.empty_like(e)
    carry = np.zeros(e.shape[0], F32)
    for k in range(e.shape[1]):
        eu[:, k] = np.maximum(e[:, k], carry * up)
        carry = eu[:, k]
    carry = np.zeros(e.shape[0], F32)
    for k in range(e.shape[1] - 1, -1, -1):
        ed[:, k] = np.maximum(eu[:, k], carry * down)
        carry = ed[:, k]
    return ed * smr


def torch_exp2(x):
    """torch.exp2 over a float32 array of the same shape as the plain
    version's: PyTorch's CPU exp2 rounds 16 of the 256 exponents differently
    in its vector path and its scalar tail, and numpy's is a third library,
    so the model shares this one call with the plain version."""
    return torch.exp2(torch.from_numpy(np.ascontiguousarray(x, F32))).numpy()


def est_np(t34, region, base, fit_sf, zero_sf, offsets):
    """est_at over the offsets, float32 numpy and integer counts: book 11's
    pair LUT over the pairs of nonzero bands (the even bin's band), a sign
    bit a nonzero value, 2 floor(log2 a) - 3 escape bits a value >= 16, 6
    bits a nonzero band.  Returns (est [N, K], what the inputs reached)."""
    lut = _COST_LUTS[11][0].astype(np.int64)
    N = t34.shape[0]

    def per_bin(v, fill):
        ext = np.concatenate([v, np.full((N, 1), fill, F32)], axis=1)
        return np.take_along_axis(ext, region, axis=1)

    b_b, f_b, z_b = (per_bin(base, 255.0), per_bin(fit_sf, 255.0),
                     per_bin(zero_sf, 0.0))
    est = np.empty((N, len(offsets)), F32)
    seen = dict(clamp_8191=0, pair_clamp_16=0, escapes=0, zero_bands=0)
    for k, o in enumerate(offsets):
        sfb = np.minimum(np.maximum(b_b + F32(o), f_b), F32(255.0))
        scale = torch_exp2((F32(100.0) - sfb) * F32(0.1875))
        a = np.minimum(np.floor(t34 * scale + F32(0.4054)), F32(8191.0))
        q = a.astype(np.int64)
        nz = sfb < z_b
        p = np.minimum(q, 16)
        bits = np.where(nz[:, 0::2], lut[p[:, 0::2] * 17 + p[:, 1::2]],
                        0).sum(1)
        bits += (q > 0).sum(1)
        log2 = np.frexp(np.maximum(q, 1).astype(np.float64))[1] - 1
        bits += np.where(q >= 16, 2 * log2 - 3, 0).sum(1)
        side = np.minimum(np.maximum(base + F32(o), fit_sf), F32(255.0))
        bits += 6 * (side < zero_sf).sum(1)
        est[:, k] = bits.astype(F32)
        seen["clamp_8191"] += int((q == 8191).sum())
        seen["pair_clamp_16"] += int((q > 16).sum())
        seen["escapes"] += int((q >= 16).sum())
        seen["zero_bands"] += int((~nz & (region < base.shape[1])).sum())
    return est, seen


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the spread ---------------------------------------------------------------
@pytest.mark.parametrize("nb", [12, 36, 49])
def test_spread_ref_matches_numpy(nb):
    """spread_ref against step_up / step_dn in numpy over 301 rows, some
    all-zero and some with zero bands, bit for bit."""
    rng = np.random.default_rng(nb)
    e = (np.exp(rng.normal(0.0, 4.0, (301, nb))) * 1e3).astype(F32)
    e[rng.random(e.shape) < 0.2] = 0.0
    e[::7] = 0.0
    got = enc_scans.spread_ref(_t(e), *map(float, PSY))
    assert_bits_equal(got, spread_np(e, *PSY), f"spread nb={nb}")


@pytest.mark.parametrize("sample_rate,cutoff_bin", CONFIGS)
def test_spread_ref_matches_reference_scans(sample_rate, cutoff_bin):
    """spread_ref against the reference's own `spread` (two lax.scans, XLA
    on the CPU) at a configuration's band count, bit for bit."""
    from aacjax import encode_batch as JE
    d = TI.enc_scans_random(3, 257, sample_rate, cutoff_bin)
    si = int(np.argmin(np.abs(TE.tables.SAMPLE_RATES[:12] - sample_rate)))
    fn = JE._analysis_fn(si, cutoff_bin, 1024, 2, PSY_DB)
    ref_spread = dict(zip(fn.__code__.co_freevars,
                          (c.cell_contents for c in fn.__closure__)))["spread"]
    want = np.asarray(ref_spread(d["e"]))
    got = enc_scans.spread_ref(_t(d["e"]), *map(float, PSY))
    assert_bits_equal(got, want, f"spread at {sample_rate} Hz")


# -- the rate-cost grid ---------------------------------------------------------
@pytest.mark.parametrize("short_share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("sample_rate,cutoff_bin", CONFIGS)
def test_rate_cost_ref_matches_numpy(sample_rate, cutoff_bin, short_share):
    """rate_cost_ref against est_at in numpy over OFF_GRID, bit for bit, on
    long and short rows with silent and uncoded bands, padding bins, and
    values that reach the escapes and both clamps."""
    d = TI.enc_scans_random(11, 203, sample_rate, cutoff_bin, short_share)
    region = np.where(d["is_short"][:, None], d["regions"][1],
                      d["regions"][0])
    offsets = tuple(TE.OFF_GRID.tolist())
    want, seen = est_np(d["t34"], region, d["base"], d["fit_sf"],
                        d["zero_sf"], offsets)
    lut = _t(_COST_LUTS[11][0].astype(F32).reshape(-1))
    got = enc_scans.rate_cost_ref(_t(d["t34"]), _t(region), _t(d["base"]),
                                  _t(d["fit_sf"]), _t(d["zero_sf"]), lut,
                                  offsets)
    assert_bits_equal(got, want, "est")
    assert min(seen.values()) > 0, seen
    if short_share > 0:                     # bands short rows do not code
        assert (d["base"] == 255.0).any()
    if sample_rate != 44100 and 0 < short_share < 1:
        assert (region == d["nb"]).any()    # padding bins


# -- the analysis program --------------------------------------------------------
def spread_pre(e, up, down, smr):
    """The analysis program's spread loop before the scans became kernels,
    as it stood in encode_batch._analysis_fn."""
    eT = e.t().contiguous()                            # [nb, N]
    eu = torch.empty_like(eT)
    tmp = torch.zeros_like(eT[0])
    for k in range(eT.shape[0]):
        torch.maximum(eT[k], tmp, out=eu[k])
        torch.mul(eu[k], up, out=tmp)
    ed = torch.empty_like(eT)
    tmp.zero_()
    for k in range(eT.shape[0] - 1, -1, -1):
        torch.maximum(eu[k], tmp, out=ed[k])
        torch.mul(ed[k], down, out=tmp)
    return ed.t() * smr


def grid_pre(arr, t34, sel, base, fit_sf, zero_sf):
    """The analysis program's cost-grid loop before the scans became
    kernels, with its region maps, as it stood in
    encode_batch._analysis_fn."""
    nb, S, N = arr["nb"], 128, t34.shape[0]
    cut_l = int(arr["ptr_l"][-1])
    cut_s = int(arr["cfg"].swb_offsets_short[arr["max_sfb_s"]])
    Pe = max(cut_l, 8 * cut_s)
    bbe_l = torch.as_tensor(np.concatenate([
        np.asarray(arr["bb_l"])[:cut_l], np.full(Pe - cut_l, nb, np.int64)]))
    bbe_s = torch.as_tensor(np.concatenate([
        np.asarray(arr["bb_s"]).reshape(8, S)[:, :cut_s].reshape(-1),
        np.full(Pe - 8 * cut_s, nb, np.int64)]))
    lut11 = torch.as_tensor(_COST_LUTS[11][0].astype(np.float32).reshape(-1))

    def with_fill(v, fill):
        return torch.cat([v, v.new_full((v.shape[0], 1), fill)], dim=1)

    region = torch.where(sel, bbe_s, bbe_l)                    # [N, Pe]
    b_b = with_fill(base, 255.0).gather(1, region)
    f_b = with_fill(fit_sf, 255.0).gather(1, region)
    z_b = with_fill(zero_sf, 0.0).gather(1, region)

    est = torch.empty((N, len(TE.OFF_GRID)), dtype=torch.float32)
    for k, o in enumerate(TE.OFF_GRID.tolist()):
        sfb = torch.maximum(b_b + o, f_b).clamp_(max=255.0)
        c = torch.floor(t34 * torch.exp2((100.0 - sfb) * 0.1875)
                        + 0.4054)
        a = torch.clamp(c, max=8191.0)
        pair_nz = (sfb < z_b)[:, 0::2]
        p = torch.clamp(a, max=16.0).to(torch.int64)
        lut_bits = torch.where(pair_nz, lut11[p[:, 0::2] * 17
                                              + p[:, 1::2]], 0.0).sum(1)
        signs = (a > 0).sum(1)
        nbits = torch.clamp(torch.floor(torch.log2(
            torch.clamp(a, min=1.0))), min=4.0)
        extra = torch.where(a >= 16.0, 2.0 * nbits - 3.0, 0.0).sum(1)
        side_nz = (torch.maximum(base + o, fit_sf).clamp_(max=255.0)
                   < zero_sf)
        side = 6.0 * side_nz.sum(1).to(torch.float32)
        est[:, k] = (lut_bits + signs) + extra + side
    return est, torch.stack([bbe_l, bbe_s])


@pytest.mark.parametrize("sample_rate,channels,bitrate,streams,frames", [
    (44100, 2, 128_000, 3, 6), (32000, 1, 64_000, 5, 3)])
def test_analysis_equals_pre_kernel_loops(sample_rate, channels, bitrate,
                                          streams, frames):
    """The analysis program on the CPU with the scans behind their wrappers
    equals the loops it ran before on the same intermediates, bit for bit:
    the spread's output, the region maps and the estimate it returns."""
    rng = np.random.default_rng(frames)
    n = frames * 1024
    t = np.arange(n) / sample_rate
    pcm = np.stack([np.stack([6000 * np.sin(2 * np.pi * (300 + 170 * s + 90 * c)
                                            * t)
                              + rng.normal(0, 300 * (s + 1), n)
                              for c in range(channels)], axis=1)
                    for s in range(streams)])
    pcm[:, n // 2: n // 2 + 200] += 15000           # an attack: short windows
    enc = aacjax_torch.BatchEncoder(sample_rate, channels, bitrate,
                                    n_streams=streams, device="cpu")
    seen, outs = TI.enc_scans_inputs(enc, pcm, "cpu")
    (e, up, down, smr), spread_out = seen["spread"]
    assert_bits_equal(spread_out, spread_pre(e, up, down, smr), "spread")
    (t34, is_short, regions, base, fit_sf, zero_sf, offsets), est = \
        seen["rate_cost"]
    assert is_short.any() and not is_short.all()
    assert offsets == tuple(TE.OFF_GRID.tolist())
    arr = TE._arrangement(enc._si, enc._cutoff_bin)
    want, maps = grid_pre(arr, t34, is_short[:, None], base, fit_sf, zero_sf)
    assert torch.equal(regions, maps)
    assert_bits_equal(est, want, "est")
    assert_bits_equal(outs[3], want, "the analysis's est")


# -- the wrappers ----------------------------------------------------------------
def test_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors spread is spread_ref and rate_cost is rate_cost_ref on
    each row's region map, and neither counts a launch."""
    d = TI.enc_scans_random(5, 67, 32000, 746, 0.4)
    counts = (enc_scans.spread_count.launches, enc_scans.rate_cost_count.launches)
    up, down, smr = map(float, PSY)
    assert_bits_equal(enc_scans.spread(_t(d["e"]), up, down, smr),
                      enc_scans.spread_ref(_t(d["e"]), up, down, smr))
    offsets = tuple(TE.OFF_GRID.tolist())
    region = np.where(d["is_short"][:, None], d["regions"][1],
                      d["regions"][0])
    want = enc_scans.rate_cost_ref(
        _t(d["t34"]), _t(region), _t(d["base"]), _t(d["fit_sf"]),
        _t(d["zero_sf"]), _t(_COST_LUTS[11][0].astype(F32).reshape(-1)),
        offsets)
    got = enc_scans.rate_cost(_t(d["t34"]), _t(d["is_short"]),
                              _t(d["regions"]), _t(d["base"]),
                              _t(d["fit_sf"]), _t(d["zero_sf"]), offsets)
    assert_bits_equal(got, want)
    assert (enc_scans.spread_count.launches, enc_scans.rate_cost_count.launches) == counts


def test_wrappers_refuse_other_devices():
    """Tensors neither on the CPU nor on a CUDA device are refused."""
    e = torch.zeros((4, 36), device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        enc_scans.spread(e, 0.5, 0.5, 0.5)
    t34 = torch.zeros((4, 544), device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        enc_scans.rate_cost(t34, None, None, e, e, e, (0.0,))
