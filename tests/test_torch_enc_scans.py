"""The batched encoder's two scans (aacjax_torch/kernels/enc_scans.py) on
the CPU: the plain versions against independent float32 numpy versions of
the reference's `step_up` / `step_dn` and `est_at`
(aacjax/encode_batch.py:176-188, :364-387) and `spread_ref` against the
reference's own `spread` (its two `lax.scan`s, XLA on the CPU), all bit for
bit; the refactored analysis program against the loops it ran before, bit
for bit; the wrappers' CPU route.  The CUDA kernels are held to the plain
versions on the card in tests/test_torch_cuda.py.

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


# -- the grid kernel's arithmetic (enc_scans.bin_code / pair_table /
# rate_cost_model, the numpy model of csrc/enc_scans.cu) ----------------------
F8191 = F32(8191.0)
# y at and just below each class edge: 1, 16 and the escape lengths' powers
# of two up to 4096, the 8191 clamp and past it, and t34 = 0's y
EDGES = [F32(1.0), F32(16.0), *(F32(2.0 ** e) for e in range(5, 13)),
         F8191, F32(8192.0)]
EDGE_Y = np.array([F32(0.4054), F32(0.5), *EDGES,
                   *(np.nextafter(v, F32(0.0)) for v in EDGES),
                   F32(12345.5), F32(1e30), F32(np.inf)], F32)


def magnitude(y):
    """a = min(floor(y), 8191), as the plain version quantizes."""
    return np.minimum(np.floor(np.asarray(y, np.float64)), 8191).astype(
        np.int64)


def test_bin_code_identities_at_the_class_edges():
    """The identities the kernel uses in place of conversions, at every
    class edge: the magic add rounded down is floor(min(y, 16)); the
    exponent field E of min(y, 8191) gives a > 0 iff E >= 127, a >= 16 iff
    E >= 131 and then floor(log2 a) = E - 127; and the pair table, read at
    a bin's code beside a zero bin, holds its sign and escape bits (plus
    book 11's cost of (min(a, 16), 0) in the nonzero half)."""
    a = magnitude(EDGE_Y)
    r = np.floor(np.minimum(EDGE_Y, F32(16.0)).astype(np.float64)
                 + np.float64(enc_scans.MAGIC)).astype(F32)
    assert np.array_equal(r.view(np.uint32) - enc_scans.MAGIC.view(np.uint32),
                          np.minimum(a, 16))
    E = (np.minimum(EDGE_Y.view(np.uint32), F8191.view(np.uint32))
         >> 23).astype(np.int64)
    assert np.array_equal(E >= 127, a > 0)
    assert np.array_equal(E >= 131, a >= 16)
    big = a >= 1
    assert np.array_equal(E[big] - 127, np.floor(np.log2(a[big])))
    codes = enc_scans.bin_code(EDGE_Y)
    assert codes.min() >= 0 and codes.max() < enc_scans.CODES
    table = enc_scans.pair_table()
    zero_code = int(enc_scans.bin_code(F32(0.4054)))
    bits = (a > 0) + np.where(a >= 16, 2 * np.floor(np.log2(np.maximum(
        a, 1))).astype(np.int64) - 3, 0)
    lut = _COST_LUTS[11][0].astype(np.int64)
    assert np.array_equal(table[1][codes, zero_code], bits)
    assert np.array_equal(table[0][codes, zero_code],
                          bits + lut[np.minimum(a, 16) * 17])
    # two ys share a code only if they share the class: a, or a >= 16 with
    # the same floor(log2 a)
    cls = np.where(a >= 16, 16 + np.floor(np.log2(np.maximum(a, 1))), a)
    for c in np.unique(codes):
        assert len(np.unique(cls[codes == c])) == 1, c


def _t34_reaching(y_target, scale):
    """The smallest float32 t34 >= 0 whose fl(fl(t34 * scale) + 0.4054) is
    >= y_target (bisection over the bit patterns; y is monotone in t34)."""
    lo = np.zeros(y_target.shape, np.int64)
    hi = np.full(y_target.shape, int(F32(3e38).view(np.uint32)), np.int64)
    while (hi > lo).any():
        mid = (lo + hi) // 2
        t = mid.astype(np.uint32).view(F32)
        y = (t * scale).astype(F32) + F32(0.4054)
        ok = y >= y_target
        hi, lo = np.where(ok, mid, hi), np.where(ok, lo, mid + 1)
    return lo.astype(np.uint32).view(F32)


def edge_inputs():
    """16 rows of 64 bins in 8 bands of 8 (N * Pe = 1024, so PyTorch's CPU
    exp2 runs wholly in its vector path, as for the 256-entry table), long
    and short rows, at OFF_GRID.  Bands 0..5's scalefactor at the grid's
    offset 0 is base, at fit_sf (base + o below it), at zero_sf (the zero
    band's edge), 255 (the clamp), base just below zero_sf and a silent
    band; their bins' t34 put y at offset 0 at each class edge (EDGES: the
    smallest y >= the edge) and just below it (the largest y < the edge),
    at 12345.5, 1e30 and inf, with t34 = 0 between them."""
    rng = np.random.default_rng(14)
    N, nb, Pe = 16, 8, 64
    regions = np.stack([np.repeat(np.arange(nb), 8),
                        np.repeat(np.arange(nb)[::-1], 8)]).astype(np.int64)
    is_short = np.arange(N) % 3 == 0
    fit = rng.integers(0, 100, (N, nb)).astype(F32)
    zero = fit + F32(73.0)
    base = fit + F32(20.0)
    base[:, 1] = fit[:, 1] - 30.0          # s = fit_sf
    base[:, 2] = zero[:, 2]                # s = zero_sf: a zero band
    base[:, 3], zero[:, 3] = 250.0, 400.0  # s clamps to 255 at offsets > 5
    base[:, 4] = zero[:, 4] - 1.0          # the last nonzero scalefactor
    fit[:, 5], zero[:, 5], base[:, 5] = 0.0, -294.0, -294.0   # silent
    region = np.where(is_short[:, None], regions[1], regions[0])
    s0 = np.take_along_axis(
        np.concatenate([np.minimum(np.maximum(base, fit), 255.0),
                        np.full((N, 1), 255.0, F32)], 1), region, 1)
    scale = torch_exp2((F32(100.0) - s0.astype(F32)) * F32(0.1875))
    # per bin a target y and whether to step one float below its t34
    targets = np.array([*EDGES, F32(12345.5), F32(1e30)], F32)
    kinds = np.array([(v, b) for v in range(len(targets)) for b in (0, 1)]
                     + [(-1, 0), (-2, 0)])       # t34 = 0, t34 = 3e38
    pick = kinds[rng.integers(0, len(kinds), (N, Pe))]
    for i, (v, below) in enumerate(kinds[:-2]):  # every kind at least once
        pick[i % N, 2 * i % Pe] = (v, below)
    t34 = np.zeros((N, Pe), F32)
    live = pick[..., 0] >= 0
    t_at = _t34_reaching(targets[np.maximum(pick[..., 0], 0)], scale)
    t_below = np.nextafter(t_at, F32(0.0))
    t34[live] = np.where(pick[..., 1] == 1, t_below, t_at)[live]
    t34[pick[..., 0] == -2] = F32(3e38)
    return dict(t34=t34, is_short=is_short, regions=regions,
                base=base.astype(F32), fit_sf=fit, zero_sf=zero.astype(F32),
                scale=scale, region=region, pick=pick, targets=targets)


def test_rate_cost_model_matches_ref_at_the_edges():
    """The numpy model of the grid kernel (band table with the nonzero flag
    in the magic constant, bin codes, pair table) against rate_cost_ref,
    bit for bit, where y at offset 0 reaches every class edge and falls
    just short of it, and the bands sit at fit_sf, at zero_sf, at 255 and
    silent."""
    d = edge_inputs()
    offsets = tuple(TE.OFF_GRID.tolist())
    t34, region, pick = d["t34"], d["region"], d["pick"]
    with np.errstate(over="ignore"):
        y0 = (t34 * d["scale"]).astype(F32) + F32(0.4054)
    for v, edge in enumerate(d["targets"]):
        at = y0[(pick[..., 0] == v) & (pick[..., 1] == 0)]
        below = y0[(pick[..., 0] == v) & (pick[..., 1] == 1)]
        assert at.size and below.size, edge
        assert (at >= edge).all() and (below < edge).all(), edge
        if edge <= 8192:                    # the class changes at the edge
            assert (magnitude(at) == min(edge, 8191)).all(), edge
            assert (magnitude(below) == edge - 1).all(), edge
    assert np.isinf(y0[pick[..., 0] == -2]).any()
    exp2 = torch_exp2((F32(100.0) - np.arange(256, dtype=F32)) * F32(0.1875))
    # the plain version's exp2 of each bin's scalefactor is the table's
    N = t34.shape[0]

    def per_bin(v, fill):
        return np.take_along_axis(
            np.concatenate([v, np.full((N, 1), fill, F32)], 1), region, 1)

    for o in offsets:
        sfb = np.minimum(np.maximum(per_bin(d["base"], 255.0) + F32(o),
                                    per_bin(d["fit_sf"], 255.0)), F32(255.0))
        assert_bits_equal(torch_exp2((F32(100.0) - sfb) * F32(0.1875)),
                          exp2[sfb.astype(np.int64)], f"exp2 at {o}")
    with np.errstate(over="ignore"):
        got = enc_scans.rate_cost_model(t34, d["is_short"], d["regions"],
                                        d["base"], d["fit_sf"], d["zero_sf"],
                                        exp2, offsets)
    want = enc_scans.rate_cost_ref(
        _t(t34), _t(region), _t(d["base"]), _t(d["fit_sf"]),
        _t(d["zero_sf"]), _t(_COST_LUTS[11][0].astype(F32).reshape(-1)),
        offsets)
    assert_bits_equal(got, want, "est")


# (seed, N, Pe, nb, share of short rows, odd band edges, K): the card tests'
# shapes (tests/test_torch_cuda.py GRID_SHAPES) at fewer rows
@pytest.mark.parametrize("seed,N,Pe,nb,short_share,odd_bands,K", [
    (1, 7, 544, 36, 0.25, False, 1), (2, 7, 544, 36, 0.25, False, 32),
    (3, 9, 1024, 63, 0.3, False, 16), (4, 5, 768, 49, 1.0, False, 16),
    (5, 5, 768, 49, 0.0, False, 16), (6, 11, 1024, 63, 0.5, True, 32)])
def test_rate_cost_model_matches_ref_at_every_shape(seed, N, Pe, nb,
                                                    short_share, odd_bands,
                                                    K):
    """The model against rate_cost_ref, bit for bit, at one offset and 32,
    the widest region and band layout, all-short and all-long rows and
    pairs that straddle two bands."""
    d = TI.enc_grid_random(seed, N, Pe, nb, short_share, odd_bands)
    offsets = tuple(float(o) for o in np.round(np.linspace(-60, 64, K)))
    region = np.where(d["is_short"][:, None], d["regions"][1],
                      d["regions"][0])
    want = enc_scans.rate_cost_ref(
        _t(d["t34"]), _t(region), _t(d["base"]), _t(d["fit_sf"]),
        _t(d["zero_sf"]), _t(_COST_LUTS[11][0].astype(F32).reshape(-1)),
        offsets)
    exp2 = torch_exp2((F32(100.0) - np.arange(256, dtype=F32)) * F32(0.1875))
    got = enc_scans.rate_cost_model(d["t34"], d["is_short"], d["regions"],
                                    d["base"], d["fit_sf"], d["zero_sf"],
                                    exp2, offsets)
    assert_bits_equal(got, want, "est")
