"""The batched encoder's two scans, with CUDA kernels.

Counterpart of the two `lax.scan`s of the analysis program in
`aacjax/encode_batch.py` `_analysis_fn`:

  * `spread` (:176-188): the directional masking spread, per channel-frame
    a max-recurrence up the bands, m = max(e, carry * up), then one down
    them with `down`, then the product with `smr`;
  * the rate-cost grid (`est_at` scanned over the offsets of OFF_GRID,
    :364-387): per channel-frame and offset o, the exact book-11 cost of
    the coded region quantized at scalefactors base + o (pair LUT over the
    nonzero bands, signs, escapes) plus 6 bits of side info a nonzero band.

`spread` and `rate_cost` run `csrc/enc_scans.cu` on CUDA tensors (one
launch each) and their plain PyTorch versions, `spread_ref` and
`rate_cost_ref` (the loops the analysis program ran before, in the
reference's order), on CPU tensors.  Every summed term of the grid is a
small integer, so its f32 sums are exact in any order; the kernel takes
exp2 from a table `torch.exp2` makes on the same device and so equals the
plain version bit for bit, as does the spread (each step one f32 product
and one maximum).

The grid kernel never converts a float to an integer: it names each
quantized bin's class by a code made of two bit patterns (`bin_code`: the
magic-add floor of min(y, 16) and the exponent field of min(y, 8191)) and
reads a pair's whole cost, book 11's pair LUT where the band is nonzero
plus both bins' sign and escape bits, from one byte of `pair_table`.
`rate_cost_model` is the kernel's arithmetic in numpy, step for step.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from aacjax_torch.encode import _COST_LUTS
from aacjax_torch.kernels import _build

MAX_BANDS = 63      # the kernels' widest band layout (nb; the grid adds a pad)
MAX_BINS = 1024     # the grid kernel's widest coded region
MAX_OFFSETS = 32

# the grid kernel's class codes: c = p + E - 125 for p = floor(min(y, 16))
# and E the exponent field of min(y, 8191), y >= 0.4054
CODES = 31
MAGIC = np.float32(1.5 * 2 ** 23)              # __fadd_rd(v, MAGIC): floor
BITS_8191 = int(np.float32(8191.0).view(np.uint32))

# each kernel's launches since the last reset
spread_count = types.SimpleNamespace(launches=0)
rate_cost_count = types.SimpleNamespace(launches=0)


def spread_ref(e, up: float, down: float, smr: float):
    """Plain PyTorch spread of band energies e f32 [N, nb]: a max-recurrence
    up the bands, then one down, each step carry * rolloff then the maximum,
    in the reference's order (so with its roundings); times smr."""
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


def rate_cost_ref(t34, region, base, fit_sf, zero_sf, lut11, offsets):
    """Plain PyTorch rate-cost grid.  t34 f32 [N, Pe] (|coef|^0.75 of the
    coded region), region int64 [N, Pe] (each bin's band, nb for padding),
    base / fit_sf / zero_sf f32 [N, nb], lut11 f32 [289] (book 11's pair
    costs), offsets a sequence of K floats.  Returns est f32 [N, K]."""
    N = t34.shape[0]

    def with_fill(v, fill):
        return torch.cat([v, v.new_full((N, 1), fill)], dim=1)

    b_b = with_fill(base, 255.0).gather(1, region)
    f_b = with_fill(fit_sf, 255.0).gather(1, region)
    z_b = with_fill(zero_sf, 0.0).gather(1, region)
    est = torch.empty((N, len(offsets)), dtype=torch.float32,
                      device=t34.device)
    for k, o in enumerate(offsets):
        sfb = torch.maximum(b_b + o, f_b).clamp_(max=255.0)
        c = torch.floor(t34 * torch.exp2((100.0 - sfb) * 0.1875) + 0.4054)
        a = torch.clamp(c, max=8191.0)
        # sfb < zero_sf  <=>  the band's max magnitude quantizes to >= 1
        pair_nz = (sfb < z_b)[:, 0::2]
        p = torch.clamp(a, max=16.0).to(torch.int64)
        lut_bits = torch.where(pair_nz, lut11[p[:, 0::2] * 17 + p[:, 1::2]],
                               0.0).sum(1)
        signs = (a > 0).sum(1)
        nbits = torch.clamp(torch.floor(torch.log2(torch.clamp(a, min=1.0))),
                            min=4.0)
        extra = torch.where(a >= 16.0, 2.0 * nbits - 3.0, 0.0).sum(1)
        side_nz = torch.maximum(base + o, fit_sf).clamp_(max=255.0) < zero_sf
        side = 6.0 * side_nz.sum(1).to(torch.float32)
        est[:, k] = (lut_bits + signs) + extra + side
    return est


def _sign_escape_bits(a):
    """A quantized magnitude's sign bit and escape bits, as est_at counts
    them: 1 if a > 0, plus 2 floor(log2 a) - 3 if a >= 16."""
    a = np.asarray(a, np.int64)
    log2 = np.frexp(np.maximum(a, 1).astype(np.float64))[1] - 1
    return (a > 0) + np.where(a >= 16, 2 * log2 - 3, 0)


def bin_code(y, magic=MAGIC):
    """The kernel's class code of y f32 (>= 0.4054) at a band whose magic
    constant is `magic` (MAGIC, or MAGIC + CODES for a zero band): the bits
    of __fadd_rd(min(y, 16), magic) plus the exponent field of min(y,
    8191), less bits(MAGIC) + 125.  The round-down add is exact in float64
    and then floored to the float32 grid, whose step is 1 there."""
    y = np.asarray(y, np.float32)
    r = np.floor(np.minimum(y, np.float32(16.0)).astype(np.float64)
                 + np.asarray(magic, np.float64)).astype(np.float32)
    e = np.minimum(y.view(np.uint32), np.uint32(BITS_8191)) >> 23
    return (r.view(np.uint32).astype(np.int64) + e.astype(np.int64)
            - int(MAGIC.view(np.uint32)) - 125)


def pair_table() -> np.ndarray:
    """The grid kernel's pair costs, u8 [2, CODES, CODES]: entry [z, c0, c1]
    is both bins' sign and escape bits plus, for z = 0 (the even bin's band
    nonzero), book 11's cost of the pair (min(a0, 16), min(a1, 16)), for
    the classes the codes c0, c1 name; codes no y reaches hold 0."""
    lut = _COST_LUTS[11][0].astype(np.int64).reshape(17, 17)
    # one value of each class: a = 0 at exponents 125 and 126, a = 1..15,
    # and a power of two for each escape length
    reps = np.float32([0.4054, 0.5, *range(1, 16),
                       *(2.0 ** e for e in range(4, 13))])
    codes = bin_code(reps)
    a = np.minimum(np.floor(reps), 8191).astype(np.int64)
    assert len(set(codes.tolist())) == len(reps) and codes.max() < CODES
    table = np.zeros((2, CODES, CODES), np.uint8)
    sym = np.minimum(a, 16)
    bits = _sign_escape_bits(a)
    both = bits[:, None] + bits[None, :]
    table[0][np.ix_(codes, codes)] = both + lut[np.ix_(sym, sym)]
    table[1][np.ix_(codes, codes)] = both
    return table


def rate_cost_model(t34, is_short, regions, base, fit_sf, zero_sf,
                    exp2_table, offsets) -> np.ndarray:
    """The grid kernel's arithmetic in numpy (float32 where the kernel
    rounds): per row and offset the band table {exp2 scale, magic} with the
    nonzero flag in the magic, per bin the class code (`bin_code`), per
    pair one byte of `pair_table` at the index the kernel forms from the
    two codes, plus 6 bits a nonzero band.  Arguments as `rate_cost`'s, as
    numpy arrays, with exp2_table f32 [256] the device's exp2((100 - s) *
    0.1875).  Returns est f32 [N, K]."""
    t34 = np.maximum(np.asarray(t34, np.float32), np.float32(0.0))
    N, nb = base.shape
    table = pair_table().reshape(-1)
    region = np.where(np.asarray(is_short)[:, None], regions[1], regions[0])

    def with_fill(v, fill):
        return np.concatenate([v, np.full((N, 1), fill, np.float32)], 1)

    b, f, z = (with_fill(base, 255.0), with_fill(fit_sf, 255.0),
               with_fill(zero_sf, 0.0))
    est = np.empty((N, len(offsets)), np.float32)
    for k, o in enumerate(offsets):
        s = np.minimum(np.maximum(b + np.float32(o), f), np.float32(255.0))
        nz = s < z
        scale = np.asarray(exp2_table, np.float32)[
            np.clip(s, 0, 255).astype(np.int64)]
        magic = np.where(nz, MAGIC, MAGIC + np.float32(CODES))
        sc, mg = (np.take_along_axis(v, region, 1) for v in (scale, magic))
        y = t34 * sc + np.float32(0.4054)
        c0 = bin_code(y[:, 0::2], mg[:, 0::2])
        c1 = bin_code(y[:, 1::2])
        bits = table[c0 * CODES + c1].astype(np.int64).sum(1)
        est[:, k] = bits + 6 * nz[:, :nb].sum(1)
    return est


@_build.per_device
def _constants(offsets: tuple, device: torch.device) -> dict:
    """The grid's constants on `device`: book 11's pair LUT f32 [289], the
    offsets f32 [K] and, for the kernel, exp2((100 - s) * 0.1875) for s =
    0..255 as torch.exp2 computes it there (the plain version's roundings)
    and `pair_table` as bytes padded to whole 4-byte words."""
    lut = torch.as_tensor(_COST_LUTS[11][0].astype(np.float32).reshape(-1),
                          device=device)
    out = dict(lut=lut, offsets=torch.tensor(offsets, dtype=torch.float32,
                                             device=device))
    if device.type == "cuda":
        s = torch.arange(256, dtype=torch.float32, device=device)
        out["exp2"] = torch.exp2((100.0 - s) * 0.1875)
        pairs = pair_table().reshape(-1)
        pairs = np.concatenate([pairs, np.zeros(-len(pairs) % 4, np.uint8)])
        out["pairs"] = torch.as_tensor(pairs, device=device)
        # made on the caller's stream, read on any: wait for it once here
        torch.cuda.current_stream(device).synchronize()
    return out


def spread(e, up: float, down: float, smr: float):
    """Directional masking spread of band energies e f32 [N, nb] (finite,
    >= 0), nb <= MAX_BANDS: `spread_ref` on CPU tensors, one launch of
    `aacjax_enc_spread` on CUDA tensors.  up, down and smr are f32 values.
    Returns f32 [N, nb]."""
    if e.device.type == "cpu":
        return spread_ref(e, up, down, smr)
    _build.require_cuda(e, "spread")
    if e.dim() != 2 or not 1 <= e.shape[1] <= MAX_BANDS:
        raise ValueError(f"e: shape {tuple(e.shape)}, expected [N, nb] with "
                         f"1 <= nb <= {MAX_BANDS}")
    N, nb = e.shape
    dev = e.device
    x = _build.check(e, "e", torch.float32, (N, nb), dev)
    out = torch.empty((N, nb), dtype=torch.float32, device=dev)
    spread_count.launches += _build.launch(
        "aacjax_enc_spread", dev, x, out.data_ptr(), N, nb, up, down, smr,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def rate_cost(t34, is_short, regions, base, fit_sf, zero_sf, offsets: tuple):
    """The rate-cost grid: t34 f32 [N, Pe] (Pe even, <= MAX_BINS), is_short
    bool [N], regions int64 [2, Pe] (the long and the short rows' bin ->
    band maps, nb for padding), base / fit_sf / zero_sf f32 [N, nb] holding
    integers, fit_sf >= 0 (so that every scalefactor base + o clamped to
    [fit_sf, 255] indexes the exp2 table), t34 >= 0 (|coef|^0.75; the
    kernel reads a negative or NaN t34 as 0), offsets a tuple of K <=
    MAX_OFFSETS integer floats.  `rate_cost_ref` on CPU tensors, one launch
    of `aacjax_enc_rate_cost` on CUDA tensors.  Returns est f32 [N, K]."""
    if t34.device.type == "cpu":
        region = torch.where(is_short[:, None], regions[1], regions[0])
        return rate_cost_ref(t34, region, base, fit_sf, zero_sf,
                             _constants(offsets, t34.device)["lut"], offsets)
    _build.require_cuda(t34, "rate_cost")
    if t34.dim() != 2 or t34.shape[1] % 2 or not 0 < t34.shape[1] <= MAX_BINS:
        raise ValueError(f"t34: shape {tuple(t34.shape)}, expected [N, Pe] "
                         f"with Pe even and <= {MAX_BINS}")
    if base.dim() != 2 or not 1 <= base.shape[1] <= MAX_BANDS:
        raise ValueError(f"base: shape {tuple(base.shape)}, expected [N, nb] "
                         f"with nb <= {MAX_BANDS}")
    if not 0 < len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets; the kernel takes 1 to "
                         f"{MAX_OFFSETS}")
    (N, Pe), nb, K = t34.shape, base.shape[1], len(offsets)
    dev = t34.device
    ck = _build.check
    ptrs = [ck(t34, "t34", torch.float32, (N, Pe), dev, align=8),
            ck(is_short, "is_short", torch.bool, (N,), dev, align=1),
            ck(regions, "regions", torch.int64, (2, Pe), dev, align=8)]
    for name, a in (("base", base), ("fit_sf", fit_sf), ("zero_sf", zero_sf)):
        ptrs.append(ck(a, name, torch.float32, (N, nb), dev))
    c = _constants(offsets, dev)
    est = torch.empty((N, K), dtype=torch.float32, device=dev)
    rate_cost_count.launches += _build.launch(
        "aacjax_enc_rate_cost", dev, *ptrs, c["pairs"].data_ptr(),
        c["exp2"].data_ptr(), c["offsets"].data_ptr(), est.data_ptr(), N, Pe,
        nb, K, torch.cuda.current_stream(dev).cuda_stream)
    return est

