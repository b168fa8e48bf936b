"""Parametric Stereo (HE-AAC v2) — bitstream parse and parameter
handling (ISO/IEC 14496-3 §8.6.4, baseline PS).

PS rides inside the SBR extension data (bs_extension_id 2) of a mono
HE-AAC stream: the decoder reconstructs stereo in the QMF domain from
the mono signal plus IID (inter-channel intensity difference) and ICC
(inter-channel coherence) parameters per parameter band per envelope.
The reference has no PS (it lists HE-v2 as planned); libavcodec decodes
it independently and arbitrates aacjax's implementation
(tests/test_ps.py).

Spec constants (huffman books, band maps, hybrid filter prototypes,
dequantization tables) are extracted from libavcodec by ELF symbol —
tools/extract_ffmpeg_tables.py.
"""
from __future__ import annotations

import functools
import pathlib
from dataclasses import dataclass, field

import numpy as np

from aacjax_torch.host.bitio import BitReader, BitstreamError
from aacjax_torch.host.huffman import HuffmanTable

_NPZ = pathlib.Path(__file__).parent / "ps_tables.npz"

EXTENSION_ID_PS = 2

# parameter band counts per iid/icc mode 0..5
NR_PAR = (10, 20, 34, 10, 20, 34)
NR_IPDOPD_PAR = (5, 11, 17, 5, 11, 17)


@functools.lru_cache(maxsize=None)
def tables() -> dict:
    d = np.load(_NPZ)
    return {k: d[k] for k in d.files}


@functools.lru_cache(maxsize=None)
def _books() -> dict:
    t = tables()
    out = {}
    for name in ("iid_df0", "iid_dt0", "iid_df1", "iid_dt1",
                 "icc_df", "icc_dt", "ipd_df", "ipd_dt",
                 "opd_df", "opd_dt"):
        bits = t[f"huff_{name}_bits"]
        codes = t[f"huff_{name}_codes"]
        n = len(bits)
        # iid/icc books decode centered deltas; ipd/opd deltas are the raw
        # symbol index taken mod 8 (FFmpeg READ_PAR_DATA offset 0, mask 7)
        lav = 0 if name.startswith(("ipd", "opd")) else (n - 1) // 2
        rows = np.zeros((n, 3), np.int64)
        rows[:, 0] = bits
        rows[:, 1] = codes
        rows[:, 2] = np.arange(n) - lav
        out[name] = HuffmanTable(f"ps_{name}", rows)
    return out


@dataclass
class PSData:
    """One frame's PS parameters (quantized indices, absolute after
    delta resolution)."""
    enable_iid: bool = False
    iid_mode: int = 0
    enable_icc: bool = False
    icc_mode: int = 0
    enable_ext: bool = False
    frame_class: int = 0
    num_env: int = 0
    border_position: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.int64))
    iid_par: np.ndarray | None = None   # [num_env, nr_par] indices
    icc_par: np.ndarray | None = None
    enable_ipdopd: bool = False
    ipd_par: np.ndarray | None = None   # [num_env, nr_ipdopd] in 0..7
    opd_par: np.ndarray | None = None

    @property
    def nr_par(self) -> int:
        return NR_PAR[self.iid_mode] if self.enable_iid else (
            NR_PAR[self.icc_mode] if self.enable_icc else 10)

    @property
    def is34(self) -> bool:
        # 34-band processing engages when EITHER parameter set uses a
        # 34-band mode (FFmpeg ff_ps_read_data: is34bands)
        return ((self.enable_iid and NR_PAR[self.iid_mode] == 34)
                or (self.enable_icc and NR_PAR[self.icc_mode] == 34))


@dataclass
class PSContext:
    """Cross-frame carried PS parse state."""
    header_seen: bool = False
    enable_iid: bool = False
    iid_mode: int = 0
    enable_icc: bool = False
    icc_mode: int = 0
    enable_ext: bool = False
    iid_prev: np.ndarray = field(
        default_factory=lambda: np.zeros(34, np.int64))
    icc_prev: np.ndarray = field(
        default_factory=lambda: np.zeros(34, np.int64))
    enable_ipdopd: bool = False
    ipd_prev: np.ndarray = field(
        default_factory=lambda: np.zeros(17, np.int64))
    opd_prev: np.ndarray = field(
        default_factory=lambda: np.zeros(17, np.int64))
    # full per-envelope phase rows, persisted across frames: libavcodec
    # keeps ipd_par/opd_par in its decoder context, so a frame whose
    # ps_data carries NO extension continues applying the previous
    # frame's phase parameters (enable_ipdopd itself is sticky too) —
    # verified empirically: the oracle's toggle-off output is
    # bit-identical to explicitly re-sending the old parameters
    ipd_rows: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 17), np.int64))
    opd_rows: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 17), np.int64))


_NUM_ENV_TAB = ((0, 1, 2, 4), (1, 2, 3, 4))


def _read_pars(r: BitReader, dt: int, prev: np.ndarray, nr: int,
               book_dt: HuffmanTable, book_df: HuffmanTable,
               lo: int, hi: int) -> np.ndarray:
    out = np.zeros(nr, np.int64)
    if dt:
        for i in range(nr):
            d = int(book_dt.values[book_dt.decode(r)][0])
            out[i] = prev[i] + d
    else:
        acc = 0
        for i in range(nr):
            d = int(book_df.values[book_df.decode(r)][0])
            acc += d
            out[i] = acc
    if (out < lo).any() or (out > hi).any():
        raise BitstreamError("PS parameter out of range")
    return out


def _read_phase_pars(r: BitReader, dt: int, prev: np.ndarray, nr: int,
                     book_dt: HuffmanTable,
                     book_df: HuffmanTable) -> np.ndarray:
    """IPD/OPD parameters: raw-index huffman deltas accumulated mod 8."""
    out = np.zeros(nr, np.int64)
    if dt:
        for i in range(nr):
            d = int(book_dt.values[book_dt.decode(r)][0])
            out[i] = (prev[i] + d) & 7
    else:
        acc = 0
        for i in range(nr):
            d = int(book_df.values[book_df.decode(r)][0])
            acc = (acc + d) & 7
            out[i] = acc
    return out


def read_ps_data(r: BitReader, ctx: PSContext, bits_left: int) -> PSData:
    """Parse one ps_data() payload (FFmpeg ff_ps_read_data semantics)."""
    ps = PSData()
    if r.read(1):  # bs_enable_ps_header
        ctx.header_seen = True
        ctx.enable_iid = bool(r.read(1))
        if ctx.enable_iid:
            ctx.iid_mode = r.read(3)
            if ctx.iid_mode > 5:
                raise BitstreamError("PS iid_mode out of range")
        ctx.enable_icc = bool(r.read(1))
        if ctx.enable_icc:
            ctx.icc_mode = r.read(3)
            if ctx.icc_mode > 5:
                raise BitstreamError("PS icc_mode out of range")
        ctx.enable_ext = bool(r.read(1))
    if not ctx.header_seen:
        raise BitstreamError("PS data before any PS header")
    ps.enable_iid = ctx.enable_iid
    ps.iid_mode = ctx.iid_mode
    ps.enable_icc = ctx.enable_icc
    ps.icc_mode = ctx.icc_mode
    ps.enable_ext = ctx.enable_ext

    ps.frame_class = r.read(1)
    ps.num_env = _NUM_ENV_TAB[ps.frame_class][r.read(2)]
    ps.border_position[0] = -1
    if ps.frame_class:
        for e in range(ps.num_env):
            ps.border_position[e + 1] = r.read(5)
    else:
        for e in range(ps.num_env):
            ps.border_position[e + 1] = (e + 1) * 32 // ps.num_env - 1

    b = _books()
    if ps.enable_iid:
        nr = NR_PAR[ps.iid_mode]
        fine = ps.iid_mode >= 3
        rng = 15 if fine else 7          # legal |iid| range per mode
        dtb = b["iid_dt1"] if fine else b["iid_dt0"]
        dfb = b["iid_df1"] if fine else b["iid_df0"]
        ps.iid_par = np.zeros((max(ps.num_env, 1), nr), np.int64)
        prev = ctx.iid_prev[:nr]
        for e in range(ps.num_env):
            dt = r.read(1)
            ps.iid_par[e] = _read_pars(r, dt, prev, nr, dtb, dfb, -rng, rng)
            prev = ps.iid_par[e]
        ctx.iid_prev[:nr] = prev
    if ps.enable_icc:
        nr = NR_PAR[ps.icc_mode]
        ps.icc_par = np.zeros((max(ps.num_env, 1), nr), np.int64)
        prev = ctx.icc_prev[:nr]
        for e in range(ps.num_env):
            dt = r.read(1)
            ps.icc_par[e] = _read_pars(r, dt, prev, nr, b["icc_dt"],
                                       b["icc_df"], 0, 7)
            prev = ps.icc_par[e]
        ctx.icc_prev[:nr] = prev
    if ps.enable_ext:
        cnt = r.read(4)
        if cnt == 15:
            cnt += r.read(8)
        bits = cnt * 8
        while bits > 7:
            start = r.bit_position
            ext_id = r.read(2)
            if ext_id == 0:
                # IPD/OPD phase parameters (ps_extension id 0)
                ctx.enable_ipdopd = bool(r.read(1))
                if ctx.enable_ipdopd:
                    nr = NR_IPDOPD_PAR[ctx.iid_mode]
                    ps.ipd_par = np.zeros((max(ps.num_env, 1), nr), np.int64)
                    ps.opd_par = np.zeros((max(ps.num_env, 1), nr), np.int64)
                    ipd_prev = ctx.ipd_prev[:nr]
                    opd_prev = ctx.opd_prev[:nr]
                    for e in range(ps.num_env):
                        ps.ipd_par[e] = _read_phase_pars(
                            r, r.read(1), ipd_prev, nr,
                            b["ipd_dt"], b["ipd_df"])
                        ipd_prev = ps.ipd_par[e]
                        ps.opd_par[e] = _read_phase_pars(
                            r, r.read(1), opd_prev, nr,
                            b["opd_dt"], b["opd_df"])
                        opd_prev = ps.opd_par[e]
                    ctx.ipd_prev[:nr] = ipd_prev
                    ctx.opd_prev[:nr] = opd_prev
                    ne = ps.ipd_par.shape[0]
                    ctx.ipd_rows[:ne, :nr] = ps.ipd_par
                    ctx.opd_rows[:ne, :nr] = ps.opd_par
                r.read(1)  # reserved_ps
            bits -= r.bit_position - start
            if bits < 0:
                raise BitstreamError("PS extension overran its count")
        r.advance(bits)
    if ctx.enable_ipdopd and ps.ipd_par is None:
        # no extension this frame: the previous frame's phase rows stay
        # in force (libavcodec context persistence, see PSContext)
        nr = NR_IPDOPD_PAR[ctx.iid_mode]
        ne = max(ps.num_env, 1)
        ps.ipd_par = ctx.ipd_rows[:ne, :nr].copy()
        ps.opd_par = ctx.opd_rows[:ne, :nr].copy()
    ps.enable_ipdopd = ctx.enable_ipdopd

    # Fix up envelopes (FFmpeg ff_ps_read_data): when no envelope reaches
    # the last QMF slot — num_env == 0, or a VAR frame whose final border
    # stops early — append a synthetic envelope at border 31 carrying the
    # most recent parameter values (this frame's last envelope, or the
    # previous frame's when none were transmitted), so the per-slot
    # interpolation always runs toward a defined target.
    if ps.num_env == 0 or ps.border_position[ps.num_env] < 31:
        e = ps.num_env
        ps.num_env += 1
        ps.border_position[ps.num_env] = 31
        if ps.enable_iid:
            nr = NR_PAR[ps.iid_mode]
            rows = ps.iid_par if ps.iid_par is not None else np.zeros(
                (1, nr), np.int64)
            src = rows[e - 1] if e > 0 else ctx.iid_prev[:nr]
            ps.iid_par = np.concatenate([rows[:e], src[None, :]])
        if ps.enable_icc:
            nr = NR_PAR[ps.icc_mode]
            rows = ps.icc_par if ps.icc_par is not None else np.zeros(
                (1, nr), np.int64)
            src = rows[e - 1] if e > 0 else ctx.icc_prev[:nr]
            ps.icc_par = np.concatenate([rows[:e], src[None, :]])
        if ctx.enable_ipdopd:
            nr = NR_IPDOPD_PAR[ctx.iid_mode]
            for name, prev in (("ipd_par", ctx.ipd_prev),
                               ("opd_par", ctx.opd_prev)):
                rows = getattr(ps, name)
                if rows is None:
                    rows = np.zeros((1, nr), np.int64)
                src = rows[e - 1] if e > 0 else prev[:nr]
                setattr(ps, name, np.concatenate([rows[:e], src[None, :]]))
    return ps
