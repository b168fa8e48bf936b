"""SBR (Spectral Band Replication) host layer: bitstream parse, frequency
band tables, and dequantization (ISO/IEC 14496-3 §4.6.18).

The reference never implemented SBR (decoder.js:279-280 throws), so this
layer is spec-driven; parity is validated against libavcodec, which
decodes HE-AAC independently (tests/test_sbr.py).  Spec constants with no
closed form (envelope/noise codebooks, QMF prototype, offset tables,
noise phases) are extracted from libavcodec by ELF symbol —
tools/extract_ffmpeg_tables.py documents the provenance and the
bit-for-bit cross-validation of the extractor.

Structure:
  SBRHeader        — sbr_header() fields + defaults
  SBRTables        — everything derived from (header, sample_rate): the
                     master table, high/low/noise/limiter band tables and
                     the patch map (§4.6.18.3.2) — cached per header
  SBRChannelState  — cross-frame carried state (previous envelope/noise
                     scalefactors, chirp factors, synthesis position)
  read_sbr_extension / SBRFrame — one FIL-extension payload parsed into
                     dense per-envelope arrays, dequantized
"""
from __future__ import annotations

import functools
import math
import pathlib
from dataclasses import dataclass, field

import numpy as np

from portbench.reference.asc import UnsupportedError
from portbench.reference.bitio import BitReader, BitstreamError
from portbench.reference.huffman import HuffmanTable

_NPZ = pathlib.Path(__file__).parent / "sbr_tables.npz"

EXT_SBR_DATA = 13
EXT_SBR_DATA_CRC = 14

FIXFIX, FIXVAR, VARFIX, VARVAR = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Codebooks (bits/codes pairs -> the repo's flat-LUT HuffmanTable; the
# decoded value is symbol_index - LAV)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _books() -> dict:
    d = np.load(_NPZ)
    out = {}
    for name in ("t_huffman_env_1_5dB", "f_huffman_env_1_5dB",
                 "t_huffman_env_bal_1_5dB", "f_huffman_env_bal_1_5dB",
                 "t_huffman_env_3_0dB", "f_huffman_env_3_0dB",
                 "t_huffman_env_bal_3_0dB", "f_huffman_env_bal_3_0dB",
                 "t_huffman_noise_3_0dB", "t_huffman_noise_bal_3_0dB"):
        bits = d[f"{name}_bits"]
        codes = d[f"{name}_codes"]
        n = len(bits)
        lav = (n - 1) // 2
        rows = np.zeros((n, 3), np.int64)
        rows[:, 0] = bits
        rows[:, 1] = codes
        rows[:, 2] = np.arange(n) - lav
        out[name] = HuffmanTable(name, rows)
    return out


def _dec(book: HuffmanTable, r: BitReader) -> int:
    idx = book.decode(r)
    return int(book.values[idx, 0])


@functools.lru_cache(maxsize=None)
def _consts():
    d = np.load(_NPZ)
    return dict(sbr_offset=d["sbr_offset"], bands_warped=d["bands_warped"],
                limgain=d["limgain"], noise_table=d["noise_table"])


# ---------------------------------------------------------------------------
# Header
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SBRHeader:
    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 0
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1


def read_sbr_header(r: BitReader) -> SBRHeader:
    amp_res = r.read(1)
    start_freq = r.read(4)
    stop_freq = r.read(4)
    xover_band = r.read(3)
    r.advance(2)  # bs_reserved
    extra1 = r.read(1)
    extra2 = r.read(1)
    freq_scale, alter_scale, noise_bands = 2, 1, 2
    limiter_bands, limiter_gains, interpol_freq, smoothing_mode = 2, 2, 1, 1
    if extra1:
        freq_scale = r.read(2)
        alter_scale = r.read(1)
        noise_bands = r.read(2)
    if extra2:
        limiter_bands = r.read(2)
        limiter_gains = r.read(2)
        interpol_freq = r.read(1)
        smoothing_mode = r.read(1)
    return SBRHeader(amp_res, start_freq, stop_freq, xover_band, freq_scale,
                     alter_scale, noise_bands, limiter_bands, limiter_gains,
                     interpol_freq, smoothing_mode)


# ---------------------------------------------------------------------------
# Frequency band tables (§4.6.18.3.2)
# ---------------------------------------------------------------------------
def _make_bands(start: int, stop: int, num: int) -> np.ndarray:
    """Geometrically spaced band widths between start and stop."""
    base = (stop / start) ** (1.0 / num)
    prod = float(start)
    previous = start
    widths = np.zeros(num, np.int64)
    for k in range(num - 1):
        prod *= base
        present = int(round(prod))
        widths[k] = present - previous
        previous = present
    widths[num - 1] = stop - previous
    return widths


@dataclass(frozen=True)
class SBRTables:
    k0: int
    k2: int
    kx: int                 # crossover subband (f_high[0])
    m: int                  # number of HF subbands (k2 - kx)
    n_master: int
    f_master: tuple
    n_high: int
    n_low: int
    f_high: tuple
    f_low: tuple
    n_q: int
    f_noise: tuple
    n_lim: int
    f_lim: tuple
    num_patches: int
    patch_num_subbands: tuple
    patch_start_subband: tuple

    def freq_table(self, res: int) -> np.ndarray:
        return np.asarray(self.f_high if res else self.f_low, np.int64)

    def n_bands(self, res: int) -> int:
        return self.n_high if res else self.n_low


@functools.lru_cache(maxsize=None)
def derive_tables(header: SBRHeader, sample_rate: int) -> SBRTables:
    """sample_rate is the SBR (output) rate = 2x the core rate."""
    c = _consts()
    rates = {16000: 0, 22050: 1, 24000: 2, 32000: 3,
             44100: 4, 48000: 4, 64000: 4,
             88200: 5, 96000: 5, 128000: 5, 176400: 5, 192000: 5}
    if sample_rate not in rates:
        raise BitstreamError(f"SBR sample rate {sample_rate} unsupported")
    offsets = c["sbr_offset"][rates[sample_rate]]

    temp = 3000 if sample_rate < 32000 else (4000 if sample_rate < 64000
                                             else 5000)
    start_min = ((temp << 7) + (sample_rate >> 1)) // sample_rate
    stop_min = ((temp << 8) + (sample_rate >> 1)) // sample_rate
    k0 = start_min + int(offsets[header.start_freq])

    if header.stop_freq < 14:
        k2 = stop_min
        stop_dk = np.sort(_make_bands(stop_min, 64, 13))
        k2 += int(np.sum(stop_dk[: header.stop_freq]))
    elif header.stop_freq == 14:
        k2 = 2 * k0
    else:
        k2 = 3 * k0
    k2 = min(64, k2)

    if sample_rate <= 32000:
        max_bands = 48
    elif sample_rate == 44100:
        max_bands = 35
    else:
        max_bands = 32
    if k2 - k0 > max_bands or k2 <= k0:
        raise BitstreamError(f"invalid SBR range k0={k0} k2={k2}")

    # master table
    if header.freq_scale == 0:
        dk = 1 + header.alter_scale
        n_master = (k2 - k0) // dk
        if header.alter_scale:
            n_master = ((k2 - k0 + 2) >> 2) << 1
        else:
            n_master = ((k2 - k0) >> 1) << 1
        k2_achieved = k0 + n_master * dk
        k2_diff = k2 - k2_achieved
        dks = np.full(n_master, dk, np.int64)
        k = n_master - 1
        while k2_diff < 0:
            dks[k] -= 1
            k -= 1
            k2_diff += 1
        k = 0
        while k2_diff > 0:
            dks[k] += 1
            k += 1
            k2_diff -= 1
        f_master = np.concatenate([[k0], k0 + np.cumsum(dks)])
    else:
        half_bands = (12, 10, 8)[header.freq_scale - 1] // 2
        two_regions = 49 * k2 > 110 * k0
        k1 = 2 * k0 if two_regions else k2
        num_bands0 = 2 * int(round(half_bands * math.log2(k1 / k0)))
        if num_bands0 <= 0:
            raise BitstreamError("SBR master table: no bands")
        vdk0 = np.sort(_make_bands(k0, k1, num_bands0))
        if (vdk0 <= 0).any():
            raise BitstreamError("SBR master table: invalid band")
        vk0 = np.concatenate([[k0], k0 + np.cumsum(vdk0)])
        if two_regions:
            warp = (c["bands_warped"][header.alter_scale + 1]
                    if header.alter_scale else c["bands_warped"][0])
            # spec: second region spacing warped by 1.3 when alter_scale
            num_bands1 = 2 * int(round(
                half_bands * math.log2(float(k2) / k1)
                / (1.3 if header.alter_scale else 1.0)))
            if num_bands1 <= 0:
                raise BitstreamError("SBR master table: no bands")
            vdk1 = np.sort(_make_bands(k1, k2, num_bands1))
            if vdk1.size and vdk1[0] < vdk0[-1]:
                # first second-region band must be at least as wide as the
                # widest first-region band
                change = min(int(vdk0[-1] - vdk1[0]),
                             int(vdk1[-1] - vdk1[0]) // 2)
                vdk1[0] += change
                vdk1[-1] -= change
            vk1 = np.concatenate([[k1], k1 + np.cumsum(np.sort(vdk1))])
            f_master = np.concatenate([vk0, vk1[1:]])
            n_master = num_bands0 + num_bands1
        else:
            f_master = vk0
            n_master = num_bands0
    f_master = f_master.astype(np.int64)
    if header.xover_band >= n_master:
        raise BitstreamError("SBR xover_band out of range")

    # derived tables
    n_high = n_master - header.xover_band
    f_high = f_master[header.xover_band:]
    n_low = n_high - (n_high >> 1)
    odd = n_high & 1
    f_low = np.zeros(n_low + 1, np.int64)
    f_low[0] = f_high[0]
    for i in range(1, n_low + 1):
        f_low[i] = f_high[2 * i - odd]
    kx = int(f_high[0])
    m = int(f_high[-1]) - kx
    if kx > 32 or kx + m > 64:
        raise BitstreamError("SBR crossover out of range")

    n_q = max(1, int(round(header.noise_bands * math.log2(k2 / kx)))) \
        if header.noise_bands else 1
    if n_q > 5:
        raise BitstreamError("SBR: too many noise bands")
    f_noise = np.zeros(n_q + 1, np.int64)
    f_noise[0] = f_low[0]
    tmp = 0
    for k in range(1, n_q + 1):
        tmp += (n_low - tmp) // (n_q + 1 - k)
        f_noise[k] = f_low[tmp]

    # patch map (§4.6.18.6.3)
    msb = k0
    usb = kx
    goal_sb = int(round(2.048e6 / sample_rate))
    num_patches = 0
    patch_num = []
    patch_start = []
    if goal_sb < kx + m:
        k = 0
        for i, fm in enumerate(f_master):
            if fm < goal_sb:
                k = i + 1
    else:
        k = n_master
    while True:
        j = k + 1
        while True:
            j -= 1
            sb = int(f_master[j])
            odd2 = (sb - 2 + k0) & 1
            if sb <= k0 - 1 + msb - odd2:
                break
        patch_num.append(max(sb - usb, 0))
        patch_start.append(k0 - odd2 - patch_num[-1])
        if patch_num[-1] > 0:
            usb = sb
            msb = sb
            num_patches += 1
        else:
            patch_num.pop()
            patch_start.pop()
            msb = kx
        if int(f_master[k]) - sb < 3:
            k = n_master
        if sb == kx + m:
            break
        if num_patches > 5:
            raise BitstreamError("SBR: too many patches")
    if num_patches > 1 and patch_num and patch_num[-1] < 3:
        num_patches -= 1
        patch_num.pop()
        patch_start.pop()

    # limiter table (§4.6.18.3.2.3)
    if header.limiter_bands == 0:
        f_lim = np.array([f_low[0], f_low[n_low]], np.int64)
        n_lim = 1
    else:
        warp = float(c["bands_warped"][header.limiter_bands - 1])
        borders = [kx]
        for pn in patch_num:
            borders.append(borders[-1] + pn)
        lim = sorted(set(int(v) for v in f_low)
                     | set(borders[1:-1] if len(borders) > 2 else []))
        lim = np.array(lim, np.int64)
        patch_border_set = set(borders)
        out = [int(lim[0])]
        i = 1
        while i < len(lim):
            cur = int(lim[i])
            if cur >= out[-1] * warp:
                out.append(cur)
            elif cur == out[-1] or cur not in patch_border_set:
                pass  # drop cur
            elif out[-1] not in patch_border_set:
                out[-1] = cur
            else:
                out.append(cur)
            i += 1
        if out[-1] != int(f_low[n_low]):
            out.append(int(f_low[n_low]))
        f_lim = np.array(out, np.int64)
        n_lim = len(f_lim) - 1

    return SBRTables(
        k0=int(k0), k2=int(k2), kx=kx, m=m,
        n_master=int(n_master), f_master=tuple(int(v) for v in f_master),
        n_high=int(n_high), n_low=int(n_low),
        f_high=tuple(int(v) for v in f_high),
        f_low=tuple(int(v) for v in f_low),
        n_q=int(n_q), f_noise=tuple(int(v) for v in f_noise),
        n_lim=int(n_lim), f_lim=tuple(int(v) for v in f_lim),
        num_patches=num_patches,
        patch_num_subbands=tuple(patch_num),
        patch_start_subband=tuple(patch_start))


# ---------------------------------------------------------------------------
# Per-frame data
# ---------------------------------------------------------------------------
NUM_SLOTS = 16  # envelope time grid units per frame (2 QMF slots each)


@dataclass
class SBRGrid:
    frame_class: int = FIXFIX
    num_env: int = 1
    t_env: np.ndarray = field(default_factory=lambda: np.zeros(6, np.int64))
    freq_res: np.ndarray = field(default_factory=lambda: np.zeros(6, np.int64))
    pointer: int = 0
    num_noise: int = 1
    t_q: np.ndarray = field(default_factory=lambda: np.zeros(3, np.int64))
    amp_res: int = 1


def _middle_border(g: SBRGrid) -> int:
    if g.frame_class == FIXFIX:
        return g.num_env // 2
    if g.frame_class == VARFIX:
        if g.pointer == 0:
            return 1
        if g.pointer == 1:
            return g.num_env - 1
        return g.pointer - 1
    # FIXVAR / VARVAR
    if g.pointer > 1:
        return g.num_env + 1 - g.pointer
    return g.num_env - 1


def l_a(g: SBRGrid) -> int:
    """Transient envelope index (−1 = none) — §4.6.18.7.6.  Note the
    value can equal num_env (pointer 1 on a VAR-trailing class): no
    envelope of THIS frame is transient, but the next frame's first
    envelope is (carried via the decoder's la_prev state)."""
    if g.frame_class in (FIXVAR, VARVAR):
        return g.num_env + 1 - g.pointer if g.pointer > 0 else -1
    if g.frame_class == VARFIX:
        return g.pointer - 1 if g.pointer > 1 else -1
    return -1


def read_sbr_grid(r: BitReader, header: SBRHeader) -> SBRGrid:
    g = SBRGrid()
    g.frame_class = r.read(2)
    g.amp_res = header.amp_res
    if g.frame_class == FIXFIX:
        g.num_env = 1 << r.read(2)
        if g.num_env > 4:
            raise BitstreamError("SBR grid: too many envelopes")
        if g.num_env == 1:
            g.amp_res = 0
        g.t_env[0] = 0
        g.t_env[g.num_env] = NUM_SLOTS
        step = (NUM_SLOTS + (g.num_env >> 1)) // g.num_env
        for i in range(g.num_env - 1):
            g.t_env[i + 1] = g.t_env[i] + step
        fr = r.read(1)
        g.freq_res[1: g.num_env + 1] = fr
        g.pointer = 0
    elif g.frame_class == FIXVAR:
        trail = NUM_SLOTS + r.read(2)
        n_rel = r.read(2)
        g.num_env = n_rel + 1
        g.t_env[0] = 0
        g.t_env[g.num_env] = trail
        for i in range(n_rel):
            g.t_env[g.num_env - 1 - i] = (g.t_env[g.num_env - i]
                                          - (2 * r.read(2) + 2))
        g.pointer = r.read(_ceil_log2(g.num_env + 1))
        for i in range(g.num_env):
            g.freq_res[g.num_env - i] = r.read(1)
    elif g.frame_class == VARFIX:
        g.t_env[0] = r.read(2)
        n_rel = r.read(2)
        g.num_env = n_rel + 1
        g.t_env[g.num_env] = NUM_SLOTS
        for i in range(n_rel):
            g.t_env[i + 1] = g.t_env[i] + 2 * r.read(2) + 2
        g.pointer = r.read(_ceil_log2(g.num_env + 1))
        for i in range(g.num_env):
            g.freq_res[i + 1] = r.read(1)
    else:  # VARVAR
        g.t_env[0] = r.read(2)
        trail = NUM_SLOTS + r.read(2)
        n_rel0 = r.read(2)
        n_rel1 = r.read(2)
        g.num_env = n_rel0 + n_rel1 + 1
        if g.num_env > 5:
            raise BitstreamError("SBR grid: too many envelopes")
        g.t_env[g.num_env] = trail
        for i in range(n_rel0):
            g.t_env[i + 1] = g.t_env[i] + 2 * r.read(2) + 2
        for i in range(n_rel1):
            g.t_env[g.num_env - 1 - i] = (g.t_env[g.num_env - i]
                                          - (2 * r.read(2) + 2))
        g.pointer = r.read(_ceil_log2(g.num_env + 1))
        for i in range(g.num_env):
            g.freq_res[i + 1] = r.read(1)
    if (np.diff(g.t_env[: g.num_env + 1]) <= 0).any() or g.t_env[0] < 0:
        raise BitstreamError("SBR grid: non-monotonic envelope borders")
    g.num_noise = 2 if g.num_env > 1 else 1
    g.t_q[0] = g.t_env[0]
    g.t_q[g.num_noise] = g.t_env[g.num_env]
    if g.num_noise > 1:
        g.t_q[1] = g.t_env[_middle_border(g)]
    return g


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


@dataclass
class SBRChannelData:
    grid: SBRGrid
    df_env: np.ndarray
    df_noise: np.ndarray
    invf_mode: np.ndarray            # [n_q]
    env_facs: np.ndarray             # [num_env, n_bands(freq_res)] quantized
    noise_facs: np.ndarray           # [num_noise, n_q] quantized
    add_harmonic: np.ndarray         # [n_high] bool


@dataclass
class SBRChannelState:
    """Cross-frame carried parse/dequant state for one channel."""
    env_facs_last: np.ndarray | None = None   # last envelope (quantized)
    freq_res_last: int = 1
    noise_facs_last: np.ndarray | None = None
    invf_last: np.ndarray | None = None
    bw: np.ndarray | None = None              # smoothed chirp per noise band


def read_sbr_dtdf(r: BitReader, g: SBRGrid) -> tuple[np.ndarray, np.ndarray]:
    df_env = np.array([r.read(1) for _ in range(g.num_env)], np.int64)
    df_noise = np.array([r.read(1) for _ in range(g.num_noise)], np.int64)
    return df_env, df_noise


def read_sbr_invf(r: BitReader, t: SBRTables) -> np.ndarray:
    return np.array([r.read(2) for _ in range(t.n_q)], np.int64)


def read_sbr_envelope(r: BitReader, g: SBRGrid, t: SBRTables,
                      st: SBRChannelState, df_env: np.ndarray,
                      ch: int, coupling: bool) -> np.ndarray:
    """Returns quantized envelope scalefactors [num_env, n_bands(res_e)]
    (rows padded to n_high width)."""
    b = _books()
    delta = 2 if (ch == 1 and coupling) else 1
    if coupling and ch == 1:
        if g.amp_res:
            bits, th, fh = 5, b["t_huffman_env_bal_3_0dB"], b["f_huffman_env_bal_3_0dB"]
        else:
            bits, th, fh = 6, b["t_huffman_env_bal_1_5dB"], b["f_huffman_env_bal_1_5dB"]
    else:
        if g.amp_res:
            bits, th, fh = 6, b["t_huffman_env_3_0dB"], b["f_huffman_env_3_0dB"]
        else:
            bits, th, fh = 7, b["t_huffman_env_1_5dB"], b["f_huffman_env_1_5dB"]

    odd = t.n_high & 1
    out = np.zeros((g.num_env + 1, t.n_high), np.int64)
    # row 0 = previous frame's last envelope, remapped if needed
    prev = st.env_facs_last
    prev_res = st.freq_res_last
    if prev is None:
        prev = np.zeros(t.n_high, np.int64)
        prev_res = 1
    out[0, : len(prev)] = prev[: t.n_high]

    for e in range(g.num_env):
        res = int(g.freq_res[e + 1])
        n = t.n_bands(res)
        if df_env[e]:
            prev_n_res = prev_res if e == 0 else int(g.freq_res[e])
            if res == prev_n_res:
                for j in range(n):
                    out[e + 1, j] = out[e, j] + delta * _dec(th, r)
            elif res:  # low -> high
                for j in range(n):
                    k = (j + odd) >> 1
                    out[e + 1, j] = out[e, k] + delta * _dec(th, r)
            else:      # high -> low
                for j in range(n):
                    k = 2 * j - odd if j else 0
                    out[e + 1, j] = out[e, k] + delta * _dec(th, r)
        else:
            out[e + 1, 0] = delta * r.read(bits)
            for j in range(1, n):
                out[e + 1, j] = out[e + 1, j - 1] + delta * _dec(fh, r)
        if (out[e + 1, :n] < 0).any() or (out[e + 1, :n] > 127).any():
            raise BitstreamError("SBR envelope scalefactor out of range")
    st.env_facs_last = out[g.num_env].copy()
    st.freq_res_last = int(g.freq_res[g.num_env])
    return out[1:]


def read_sbr_noise(r: BitReader, g: SBRGrid, t: SBRTables,
                   st: SBRChannelState, df_noise: np.ndarray,
                   ch: int, coupling: bool) -> np.ndarray:
    b = _books()
    delta = 2 if (ch == 1 and coupling) else 1
    if coupling and ch == 1:
        th = b["t_huffman_noise_bal_3_0dB"]
        fh = b["f_huffman_env_bal_3_0dB"]
    else:
        th = b["t_huffman_noise_3_0dB"]
        fh = b["f_huffman_env_3_0dB"]
    out = np.zeros((g.num_noise + 1, t.n_q), np.int64)
    prev = st.noise_facs_last
    if prev is None:
        prev = np.zeros(t.n_q, np.int64)
    out[0, : len(prev)] = prev[: t.n_q]
    for e in range(g.num_noise):
        if df_noise[e]:
            for j in range(t.n_q):
                out[e + 1, j] = out[e, j] + delta * _dec(th, r)
        else:
            out[e + 1, 0] = delta * r.read(5)
            for j in range(1, t.n_q):
                out[e + 1, j] = out[e + 1, j - 1] + delta * _dec(fh, r)
        if (out[e + 1] < 0).any() or (out[e + 1] > 63).any():
            raise BitstreamError("SBR noise scalefactor out of range")
    st.noise_facs_last = out[g.num_noise].copy()
    return out[1:]


# ---------------------------------------------------------------------------
# sbr_extension_data: the FIL-extension payload
# ---------------------------------------------------------------------------
@dataclass
class SBRFrame:
    header: SBRHeader
    tables: SBRTables
    channels: list[SBRChannelData]
    coupling: bool = False
    # what the caller's readers returned, by extension id
    extensions: dict = field(default_factory=dict)


@dataclass
class SBRContext:
    """Per-stream persistent SBR decode context."""
    sample_rate: int                      # output rate (2x core)
    header: SBRHeader | None = None
    states: list[SBRChannelState] = field(default_factory=list)

    def state(self, ch: int) -> SBRChannelState:
        while len(self.states) <= ch:
            self.states.append(SBRChannelState())
        return self.states[ch]


def read_sbr_extension(r: BitReader, ctx: SBRContext, is_cpe: bool,
                       crc: bool, readers: dict | None = None) -> SBRFrame:
    """Parse one sbr_extension_data payload (reader positioned after the
    4-bit extension_type).

    `readers`: optional callables by bs_extension_id, each called as
    `reader(r, bits_left)` with `r` after the 2-bit id and the bits left
    to the end of the extended data; its result is kept on the frame's
    `extensions`.  Parametric Stereo (id 2, SCE only) with no reader
    raises UnsupportedError; any other id without a reader ends the
    loop."""
    if crc:
        r.advance(10)
    if r.read(1):  # bs_header_flag
        new_header = read_sbr_header(r)
        if new_header != ctx.header:
            # header change resets the carried state (spec: reset)
            ctx.header = new_header
            ctx.states = []
    if ctx.header is None:
        raise BitstreamError("SBR data before any sbr_header")
    header = ctx.header
    tables = derive_tables(header, ctx.sample_rate)

    channels: list[SBRChannelData] = []
    coupling = False
    if not is_cpe:
        if r.read(1):  # bs_data_extra
            r.advance(4)
        channels.append(_read_channel(r, header, tables, ctx, 0, False))
    else:
        if r.read(1):  # bs_data_extra
            r.advance(8)
        coupling = bool(r.read(1))
        if coupling:
            g0 = read_sbr_grid(r, header)
            df0 = read_sbr_dtdf(r, g0)
            df1 = read_sbr_dtdf(r, g0)
            invf0 = read_sbr_invf(r, tables)
            env0 = read_sbr_envelope(r, g0, tables, ctx.state(0), df0[0],
                                     0, True)
            noise0 = read_sbr_noise(r, g0, tables, ctx.state(0), df0[1],
                                    0, True)
            env1 = read_sbr_envelope(r, g0, tables, ctx.state(1), df1[0],
                                     1, True)
            noise1 = read_sbr_noise(r, g0, tables, ctx.state(1), df1[1],
                                    1, True)
            ah0 = _read_add_harmonic(r, tables)
            ah1 = _read_add_harmonic(r, tables)
            channels.append(SBRChannelData(g0, df0[0], df0[1], invf0,
                                           env0, noise0, ah0))
            channels.append(SBRChannelData(g0, df1[0], df1[1], invf0.copy(),
                                           env1, noise1, ah1))
        else:
            g0 = read_sbr_grid(r, header)
            g1 = read_sbr_grid(r, header)
            df0 = read_sbr_dtdf(r, g0)
            df1 = read_sbr_dtdf(r, g1)
            invf0 = read_sbr_invf(r, tables)
            invf1 = read_sbr_invf(r, tables)
            env0 = read_sbr_envelope(r, g0, tables, ctx.state(0), df0[0],
                                     0, False)
            env1 = read_sbr_envelope(r, g1, tables, ctx.state(1), df1[0],
                                     1, False)
            noise0 = read_sbr_noise(r, g0, tables, ctx.state(0), df0[1],
                                    0, False)
            noise1 = read_sbr_noise(r, g1, tables, ctx.state(1), df1[1],
                                    1, False)
            ah0 = _read_add_harmonic(r, tables)
            ah1 = _read_add_harmonic(r, tables)
            channels.append(SBRChannelData(g0, df0[0], df0[1], invf0,
                                           env0, noise0, ah0))
            channels.append(SBRChannelData(g1, df1[0], df1[1], invf1,
                                           env1, noise1, ah1))
    extensions = {}
    if r.read(1):  # bs_extended_data
        cnt = r.read(4)
        if cnt == 15:
            cnt += r.read(8)
        end = r.bit_position + 8 * cnt
        # extension payload loop (Parametric Stereo rides here, id 2)
        while end - r.bit_position > 7:
            ext_id = r.read(2)
            ps = ext_id == 2
            reader = (readers or {}).get(ext_id)
            if ps and is_cpe:                # EXTENSION_ID_PS (SCE only)
                break
            if reader is not None:
                extensions[ext_id] = reader(r, end - r.bit_position)
                continue
            if ps:
                raise UnsupportedError("Parametric Stereo (HE-AAC v2)")
            break
        if r.bit_position > end:
            raise BitstreamError("SBR extension payload overrun")
        r.advance(end - r.bit_position)
    return SBRFrame(header=header, tables=tables, channels=channels,
                    coupling=coupling, extensions=extensions)


def _read_channel(r: BitReader, header: SBRHeader, tables: SBRTables,
                  ctx: SBRContext, ch: int, coupling: bool) -> SBRChannelData:
    g = read_sbr_grid(r, header)
    df_env, df_noise = read_sbr_dtdf(r, g)
    invf = read_sbr_invf(r, tables)
    env = read_sbr_envelope(r, g, tables, ctx.state(ch), df_env, ch, coupling)
    noise = read_sbr_noise(r, g, tables, ctx.state(ch), df_noise, ch,
                           coupling)
    ah = _read_add_harmonic(r, tables)
    return SBRChannelData(g, df_env, df_noise, invf, env, noise, ah)


def _read_add_harmonic(r: BitReader, tables: SBRTables) -> np.ndarray:
    if r.read(1):
        return np.array([r.read(1) for _ in range(tables.n_high)], bool)
    return np.zeros(tables.n_high, bool)


# ---------------------------------------------------------------------------
# Dequantization (§4.6.18.3.5; FFmpeg sbr_dequant semantics)
# ---------------------------------------------------------------------------
def dequant(frame: SBRFrame) -> list[tuple[np.ndarray, np.ndarray]]:
    """Returns per channel (e_orig [num_env, n_bands], q_orig
    [num_noise, n_q]) linear-energy values."""
    out = []
    if frame.coupling:
        c0, c1 = frame.channels
        alpha = 1.0 if c0.grid.amp_res else 0.5
        pan_offset = 12.0 if c0.grid.amp_res else 24.0
        t1 = np.exp2(c0.env_facs * alpha + 7.0)
        t2 = np.exp2((pan_offset - c1.env_facs) * alpha)
        e0 = t1 / (1.0 + t2)
        e1 = e0 * t2
        n1 = np.exp2(6.0 - c0.noise_facs + 1.0)
        n2 = np.exp2(12.0 - c1.noise_facs)
        q0 = n1 / (1.0 + n2)
        q1 = q0 * n2
        out.append((e0, q0))
        out.append((e1, q1))
    else:
        for c in frame.channels:
            alpha = 1.0 if c.grid.amp_res else 0.5
            e = np.exp2(c.env_facs * alpha + 6.0)
            q = np.exp2(6.0 - c.noise_facs)
            out.append((e, q))
    return out
