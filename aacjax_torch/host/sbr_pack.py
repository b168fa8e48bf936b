"""Host-side packing of parsed SBR frames into dense, static-shaped
arrays for the batched device pipeline (aacjax.kernels.sbr_batch).

Mirrors the per-channel numpy reference (aacjax.host.sbr_decode) exactly
— equality between the two paths is enforced by tests/test_sbr_batch.py
— but emits per-slot/per-band tensors so the device program is
branch-free:

  per channel-frame (all [64]-band axes padded to the full QMF range):
    env_id[32]      envelope index of each output slot (0..4)
    e_orig[5,64]    target envelope energies, mapped per subband
    q_map[5,64]     noise-floor energies, mapped per subband
    s_idx[5,64]     sinusoid present in this exact subband
    s_map[5,64]     sinusoid anywhere in the subband's (freq-res) band
    delta[5]        the gain formula's noise-delta flag per envelope
    bw[64]          chirp factor per target subband (host-smoothed state)
    noise_base[32]  noise table base index per slot (sequential counter)
    sine_idx[32]    sinusoid phase index per slot
    interp[ ]       header interpol flag, static

The sequential cross-frame state (envelope/noise scalefactor carry,
chirp smoothing, l_A carry, sinusoid persistence, noise/sine counters)
lives here on the host; the device carries only the QMF FIFOs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from aacjax_torch.host import sbr as S
from aacjax_torch.host import sbr_decode as SD

MAX_ENV = 5
BANDS = 64
SLOTS = 32


@dataclass
class SBRHostState:
    """Per-channel host-side sequential state for the batched path."""
    bw: np.ndarray = field(default_factory=lambda: np.zeros(5))
    invf_prev: np.ndarray | None = None
    index_noise: int = 0
    index_sine: int = 0
    la_prev: int = -1
    s_index_prev: np.ndarray | None = None
    t_env_last: int = 0     # previous frame's final border (Y-carry)


# adjusted slots per frame: 32 output + up to 6 VAR-class overhang
YSLOTS = 38


@dataclass
class SBRDense:
    """Dense arrays for [B, T] channel-frames."""
    env_id: np.ndarray      # [B,T,38] i32 (32 output + 6 overhang slots)
    e_orig: np.ndarray      # [B,T,5,64] f32
    q_map: np.ndarray       # [B,T,5,64] f32
    s_idx: np.ndarray       # [B,T,5,64] f32 (0/1)
    s_map: np.ndarray       # [B,T,5,64] f32 (0/1)
    delta: np.ndarray       # [B,T,5] f32 (0/1)
    transient: np.ndarray   # [B,T,5] f32 (1 = transient envelope: no noise)
    bw: np.ndarray          # [B,T,64] f32
    noise_base: np.ndarray  # [B,T,38] i32
    sine_idx: np.ndarray    # [B,T,32] i32
    covered: np.ndarray     # [B,T,32] f32 (slot belongs to an envelope)
    has_sbr: np.ndarray     # [B,T] f32 (0 -> passthrough upsample)
    i_temp: np.ndarray      # [B,T] i32: first slots take the previous
                            # frame's adjusted overhang (Y double-buffer)


def alloc_dense(B: int, T: int) -> SBRDense:
    return SBRDense(
        env_id=np.zeros((B, T, YSLOTS), np.int32),
        e_orig=np.zeros((B, T, MAX_ENV, BANDS), np.float32),
        q_map=np.zeros((B, T, MAX_ENV, BANDS), np.float32),
        s_idx=np.zeros((B, T, MAX_ENV, BANDS), np.float32),
        s_map=np.zeros((B, T, MAX_ENV, BANDS), np.float32),
        delta=np.zeros((B, T, MAX_ENV), np.float32),
        transient=np.zeros((B, T, MAX_ENV), np.float32),
        bw=np.zeros((B, T, BANDS), np.float32),
        noise_base=np.zeros((B, T, YSLOTS), np.int32),
        sine_idx=np.zeros((B, T, YSLOTS), np.int32),
        covered=np.zeros((B, T, YSLOTS), np.float32),
        has_sbr=np.zeros((B, T), np.float32),
        i_temp=np.zeros((B, T), np.int32),
    )


_TBL_MAPS: dict = {}
_AR64 = np.arange(BANDS)


def _tbl_maps(tbl) -> dict:
    """Per-SBRTables constant band maps, computed once (SBRTables is a
    frozen hashable dataclass cached by derive_tables; ~12k redundant
    searchsorted/clip calls per 128-stream chunk otherwise dominate the
    pack loop)."""
    maps = _TBL_MAPS.get(tbl)
    if maps is None:
        kx, m = tbl.kx, tbl.m
        karr = np.arange(kx, kx + m)
        nb = np.clip(np.searchsorted(np.asarray(tbl.f_noise), karr,
                                     side="right") - 1, 0, tbl.n_q - 1)
        f_high = np.asarray(tbl.f_high, np.int64)
        mm = (f_high[:-1] + f_high[1:]) // 2 - kx          # [n_high]
        fi = {}
        fedge = {}
        for res in (0, 1):
            ftab = tbl.freq_table(res)
            fi[res] = np.clip(np.searchsorted(ftab, karr, side="right")
                              - 1, 0, len(ftab) - 2)
            fedge[res] = np.asarray(ftab, np.int64) - kx
        if len(_TBL_MAPS) > 64:
            _TBL_MAPS.clear()
        maps = dict(nb=nb, mm=mm, fi=fi, fedge=fedge)
        _TBL_MAPS[tbl] = maps
    return maps


def pack_channel_frame(dense: SBRDense, b: int, t: int,
                       state: SBRHostState, frame: S.SBRFrame, ch: int,
                       e_orig_q: tuple[np.ndarray, np.ndarray]) -> None:
    """Pack one channel's SBR frame into dense[b, t], advancing the
    host-side sequential state exactly like sbr_decode.process_channel."""
    tbl = frame.tables
    g = frame.channels[ch].grid
    cd = frame.channels[ch]
    e_orig, q_orig = e_orig_q
    kx, m = tbl.kx, tbl.m
    la = S.l_a(g)
    num_env = g.num_env
    maps = _tbl_maps(tbl)
    # VAR-class borders may overhang the frame (t_env up to 19); the
    # adjusted overhang slots carry into the next frame via the kernel's
    # Y double-buffer (dense.i_temp + the y_tail device state)
    t_env = np.minimum(g.t_env[: num_env + 1], 19)
    t_q = np.minimum(g.t_q[: g.num_noise + 1], 19)
    dense.i_temp[b, t] = max(0, 2 * state.t_env_last - 32)
    state.t_env_last = int(t_env[num_env]) if num_env else 0

    # chirp (host-sequential; identical smoothing to the numpy path) —
    # SBRHostState carries exactly the .bw/.invf_prev fields _chirp
    # mutates, so it ducks for SBRChannelProc directly
    bw_bands = SD._chirp(state, cd.invf_mode)
    nb = maps["nb"]
    dense.bw[b, t, kx: kx + m] = bw_bands[nb]

    # sinusoid index mapping with persistence: s_index[e, mm[band]] for
    # every signalled harmonic band, set where e >= la or it persisted
    s_prev = state.s_index_prev
    if s_prev is None or len(s_prev) != m:
        s_prev = np.zeros(m, bool)
    s_index = np.zeros((num_env, m), bool)
    add_mm = maps["mm"][np.asarray(cd.add_harmonic[: tbl.n_high], bool)]
    if add_mm.size and num_env:
        on = (np.arange(num_env)[:, None] >= la) | s_prev[add_mm][None, :]
        s_index[:, add_mm] |= on
    state.s_index_prev = s_index[-1].copy() if num_env else s_prev

    prev_la = state.la_prev
    for e in range(num_env):
        res = int(g.freq_res[e + 1])
        fi = maps["fi"][res]
        dense.e_orig[b, t, e, kx: kx + m] = e_orig[e][fi]
        nenv = 1 if (g.num_noise > 1 and g.t_env[e] >= t_q[1]) else 0
        dense.q_map[b, t, e, kx: kx + m] = q_orig[nenv][nb]
        dense.s_idx[b, t, e, kx: kx + m] = s_index[e]
        # s_map: 1 over every (freq-res) band containing a sinusoid —
        # cumsum instead of a python loop of ~20 tiny .any() slices
        # (393k such calls per chunk dominated the pack loop)
        cs = np.zeros(m + 1, np.int32)
        np.cumsum(s_index[e], out=cs[1:])
        fedge = maps["fedge"][res]
        band_any = cs[fedge[1:]] > cs[fedge[:-1]]
        dense.s_map[b, t, e, kx: kx + m] = band_any[fi]
        transient = (e == la or e == prev_la)
        dense.delta[b, t, e] = 0.0 if transient else 1.0
        dense.transient[b, t, e] = 1.0 if transient else 0.0
        lo_s, hi_s = RATE_T(t_env[e]), RATE_T(t_env[e + 1])
        ns = hi_s - lo_s
        dense.env_id[b, t, lo_s:hi_s] = e
        dense.covered[b, t, lo_s:hi_s] = 1.0
        dense.noise_base[b, t, lo_s:hi_s] = (
            state.index_noise + m * _AR64[:ns]) & 0x1FF
        dense.sine_idx[b, t, lo_s:hi_s] = (
            state.index_sine + _AR64[:ns]) & 3
        state.index_noise = (state.index_noise + m * ns) & 0x1FF
        state.index_sine = (state.index_sine + ns) & 3
    state.la_prev = 0 if la == num_env else -1
    dense.has_sbr[b, t] = 1.0


def RATE_T(t_units) -> int:
    return int(t_units) * 2


_COMPACT_SCRATCH: dict = {}


def _compact_scratch(shape, slot: int = 0) -> dict:
    """Cached scratch for compact_dense, keyed by (shape, slot).  The
    int16 output plane (`qi`) is handed to the caller and may still be
    in flight on the H2D link while the next chunk's host phase runs —
    the pipelined path passes alternating `slot` values so the two
    chunks never alias (same double-buffer discipline as
    native.SpecBatchArrays)."""
    B, T, E, K = shape
    key = (B, T, E, K, slot)
    sc = _COMPACT_SCRATCH.get(key)
    if sc is None:
        sc = dict(eq=np.empty((B, T, 2, E, K), np.float32),
                  l2=np.empty((B, T, 2, E, K), np.float32),
                  qi=np.empty((B, T, 2, E, K), np.int16))
        if len(_COMPACT_SCRATCH) > 8:
            _COMPACT_SCRATCH.clear()
        _COMPACT_SCRATCH[key] = sc
    return sc


def compact_dense(dense: SBRDense, buf_slot: int = 0) -> dict:
    """Compact-transfer encoding of the dense SBR planes (~3x fewer H2D
    bytes; the device expands inside the jitted program, fused for free):

      eq_l2   [B,T,2,5,64] i16 — e_orig/q_map as
              round(1024*(log2(v) - eq_off[b,t,plane])), sentinel
              -32768 for exact zero; eq_off f32 [B,T,2] is each plane's
              max exponent, so the grid is 1/1024 log2 anchored per
              channel-frame (range 32 octaves below the plane max —
              2^-32 relative contributes nothing to a gain).  Relative
              error <= 2^(1/2048) (~3.4e-4 energy, ~-75 dB amplitude —
              far below the envelope quantizer's own step of 2^(1/2))
      sbits   [B,T,5,64] i8 — bit0 = s_idx, bit1 = s_map (exact)
      dtbits  [B,T,5]    i8 — bit0 = delta, bit1 = transient (exact)
      covered/has_sbr i8, env_id/sine_idx i8, noise_base i16 (exact)
      bw stays f32 (64 of ~1400 values; the chirp factor feeds pow
      chains where log-grid rounding would compound)
    """
    sc = _compact_scratch(dense.e_orig.shape, buf_slot)
    eq, l2, qi = sc["eq"], sc["l2"], sc["qi"]
    eq[:, :, 0] = dense.e_orig
    eq[:, :, 1] = dense.q_map
    # clamp zeros to a normal float BEFORE log2: >80% of the plane is
    # exact 0.0 (unused envelope slots / bands below kx), and every 0.0
    # drops numpy's vectorized log2 into its scalar special-value
    # fallback — measured 14.7 s/chunk vs ~0.3 s clamped on this host.
    # The clamped values only feed the sentinel branch below (eq > 0
    # masks them out), so the result is bit-identical.  All ops run
    # in-place on cached scratch: the 42-84 MB temporaries otherwise
    # churn the allocator/page cache on a memory-tight 1-core host
    # (first-call 3.6 s vs 0.2 s steady was allocation, not math).
    np.maximum(eq, np.float32(1e-30), out=l2)
    np.log2(l2, out=l2)
    off = np.max(l2, axis=(3, 4)).astype(np.float32)   # [B,T,2]
    l2 -= off[:, :, :, None, None]
    l2 *= np.float32(1024.0)
    np.rint(l2, out=l2)
    np.clip(l2, -32767.0, 0.0, out=l2)
    np.copyto(l2, np.float32(-32768.0), where=eq <= 0.0)
    qi[...] = l2
    return dict(
        eq_l2=qi,
        eq_off=off,
        sbits=(dense.s_idx + 2.0 * dense.s_map).astype(np.int8),
        dtbits=(dense.delta + 2.0 * dense.transient).astype(np.int8),
        covered=dense.covered.astype(np.int8),
        has_sbr=dense.has_sbr.astype(np.int8),
        env_id=dense.env_id.astype(np.int8),
        sine_idx=dense.sine_idx.astype(np.int8),
        noise_base=dense.noise_base.astype(np.int16),
        # copies, not references: the caller may reuse `dense`'s storage
        # for the next chunk while this dict is still in flight on the
        # H2D link (the astype() fields above are fresh for the same
        # reason)
        bw=dense.bw.copy(),
        i_temp=dense.i_temp.copy(),
    )


def alloc_dense_cached(B: int, T: int, slot: int,
                       _cache: dict = {}) -> SBRDense:
    """Zeroed SBRDense backed by per-(B,T,slot) cached storage — avoids
    reallocating ~90 MB of planes every chunk (page-fault churn on a
    memory-tight host).  ONLY safe when the dense arrays themselves are
    not handed to the device path by reference (i.e. the compact_dense
    route, which copies/re-encodes every field); the non-compact route
    must keep alloc_dense.  `slot` follows the pipelined double-buffer
    discipline."""
    key = (B, T, slot)
    d = _cache.get(key)
    if d is None:
        if len(_cache) > 8:
            _cache.clear()
        d = alloc_dense(B, T)
        _cache[key] = d
        return d
    for a in vars(d).values():
        a.fill(0)
    return d
