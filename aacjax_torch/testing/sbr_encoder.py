"""SBR bitstream writer (test corpus generation only).

Emits sbr_extension_data payloads inside FIL elements — the implicit
HE-AAC signaling that ADTS streams use.  Covers FIXFIX and FIXVAR frame
classes, delta-freq and delta-time coding, stereo coupling with balance
books, harmonic (sinusoid) flags and all inverse-filtering modes —
enough to build conformance streams that libavcodec decodes, arbitrating
aacjax's SBR decoder sample-exactly (the reference has no SBR at all,
decoder.js:279-280).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from aacjax_torch.host import sbr as sbrmod
from aacjax_torch.host.bitio import BitWriter


def _enc_delta(writer: BitWriter, book, delta: int) -> None:
    ln, code = book.enc[(int(delta),)]
    writer.write(code, ln)


@dataclass
class SBRFrameSpec:
    """One channel's SBR payload."""
    num_env: int = 1                      # FIXFIX: 1/2/4; FIXVAR: 1..4
    freq_res: int = 1                     # all envelopes (both classes)
    invf: list[int] = field(default_factory=lambda: [1])   # per noise band
    env_q: np.ndarray | None = None       # [num_env, n_bands] quantized
    noise_q: np.ndarray | None = None     # [num_noise, n_q] quantized
    df_env: list[int] | None = None       # per env; e=0 must be 0 (no
                                          # cross-frame writer state)
    df_noise: list[int] | None = None
    frame_class: int = sbrmod.FIXFIX      # FIXFIX/FIXVAR/VARFIX/VARVAR
    var_bord_1: int = 0                   # trailing border offset (t=16+x)
    abs_bord_0: int = 0                   # VARFIX/VARVAR leading border
    rel_widths: list[int] | None = None   # trailing-side widths (2a+2)
    rel_widths_lead: list[int] | None = None  # VARVAR leading-side widths
    pointer: int = 0                      # transient pointer
    add_harmonic: np.ndarray | None = None  # [n_high] bool

    def amp_res(self, header: sbrmod.SBRHeader) -> int:
        if self.frame_class == sbrmod.FIXFIX and self.num_env == 1:
            return 0
        return header.amp_res

    @property
    def num_noise(self) -> int:
        return 2 if self.num_env > 1 else 1


def write_sbr_header(w: BitWriter, h: sbrmod.SBRHeader) -> None:
    w.write(h.amp_res, 1)
    w.write(h.start_freq, 4)
    w.write(h.stop_freq, 4)
    w.write(h.xover_band, 3)
    w.write(0, 2)  # reserved
    defaults1 = (h.freq_scale, h.alter_scale, h.noise_bands) == (2, 1, 2)
    defaults2 = (h.limiter_bands, h.limiter_gains, h.interpol_freq,
                 h.smoothing_mode) == (2, 2, 1, 1)
    w.write(0 if defaults1 else 1, 1)
    w.write(0 if defaults2 else 1, 1)
    if not defaults1:
        w.write(h.freq_scale, 2)
        w.write(h.alter_scale, 1)
        w.write(h.noise_bands, 2)
    if not defaults2:
        w.write(h.limiter_bands, 2)
        w.write(h.limiter_gains, 2)
        w.write(h.interpol_freq, 1)
        w.write(h.smoothing_mode, 1)


def _write_grid(w: BitWriter, s: SBRFrameSpec) -> None:
    w.write(s.frame_class, 2)
    if s.frame_class == sbrmod.FIXFIX:
        w.write({1: 0, 2: 1, 4: 2}[s.num_env], 2)
        w.write(s.freq_res, 1)
    elif s.frame_class == sbrmod.FIXVAR:
        w.write(s.var_bord_1, 2)
        n_rel = s.num_env - 1
        w.write(n_rel, 2)
        widths = s.rel_widths or [2] * n_rel
        for wd in widths:
            assert wd % 2 == 0 and 2 <= wd <= 8
            w.write((wd - 2) // 2, 2)
        nbits = max(1, math.ceil(math.log2(s.num_env + 1)))
        w.write(s.pointer, nbits)
        for _ in range(s.num_env):  # reversed order, same value
            w.write(s.freq_res, 1)
    elif s.frame_class == sbrmod.VARFIX:
        w.write(s.abs_bord_0, 2)
        n_rel = s.num_env - 1
        w.write(n_rel, 2)
        for wd in (s.rel_widths_lead or [2] * n_rel):
            assert wd % 2 == 0 and 2 <= wd <= 8
            w.write((wd - 2) // 2, 2)
        nbits = max(1, math.ceil(math.log2(s.num_env + 1)))
        w.write(s.pointer, nbits)
        for _ in range(s.num_env):
            w.write(s.freq_res, 1)
    else:  # VARVAR
        w.write(s.abs_bord_0, 2)
        w.write(s.var_bord_1, 2)
        lead = s.rel_widths_lead or []
        trail = s.rel_widths or []
        assert len(lead) + len(trail) == s.num_env - 1
        w.write(len(lead), 2)
        w.write(len(trail), 2)
        for wd in lead + trail:
            assert wd % 2 == 0 and 2 <= wd <= 8
            w.write((wd - 2) // 2, 2)
        nbits = max(1, math.ceil(math.log2(s.num_env + 1)))
        w.write(s.pointer, nbits)
        for _ in range(s.num_env):
            w.write(s.freq_res, 1)


def _write_dtdf(w: BitWriter, s: SBRFrameSpec) -> None:
    df_env = s.df_env or [0] * s.num_env
    df_noise = s.df_noise or [0] * s.num_noise
    for v in df_env:
        w.write(v, 1)
    for v in df_noise:
        w.write(v, 1)


def _env_books(amp_res: int, balance: bool):
    b = sbrmod._books()
    if balance:
        if amp_res:
            return 5, b["t_huffman_env_bal_3_0dB"], b["f_huffman_env_bal_3_0dB"]
        return 6, b["t_huffman_env_bal_1_5dB"], b["f_huffman_env_bal_1_5dB"]
    if amp_res:
        return 6, b["t_huffman_env_3_0dB"], b["f_huffman_env_3_0dB"]
    return 7, b["t_huffman_env_1_5dB"], b["f_huffman_env_1_5dB"]


def _write_envelope(w: BitWriter, s: SBRFrameSpec, h: sbrmod.SBRHeader,
                    t: sbrmod.SBRTables, balance: bool) -> None:
    """Envelope values: delta-freq rows write a PCM start + freq deltas;
    delta-time rows (e>0 only) code against the previous envelope.  With
    balance (coupled ch1) every written symbol is value/2."""
    bits, th, fh = _env_books(s.amp_res(h), balance)
    n = t.n_bands(s.freq_res)
    env = s.env_q
    d = 2 if balance else 1
    df_env = s.df_env or [0] * s.num_env
    for e in range(s.num_env):
        if df_env[e]:
            assert e > 0, "writer cannot delta-time the first envelope"
            for j in range(n):
                _enc_delta(w, th, (int(env[e, j]) - int(env[e - 1, j])) // d)
        else:
            w.write(int(env[e, 0]) // d, bits)
            for j in range(1, n):
                _enc_delta(w, fh, (int(env[e, j]) - int(env[e, j - 1])) // d)


def _write_noise(w: BitWriter, s: SBRFrameSpec, t: sbrmod.SBRTables,
                 balance: bool) -> None:
    b = sbrmod._books()
    th = b["t_huffman_noise_bal_3_0dB"] if balance else b["t_huffman_noise_3_0dB"]
    fh = (b["f_huffman_env_bal_3_0dB"] if balance
          else b["f_huffman_env_3_0dB"])
    d = 2 if balance else 1
    df_noise = s.df_noise or [0] * s.num_noise
    for e in range(s.num_noise):
        if df_noise[e]:
            assert e > 0
            for j in range(t.n_q):
                _enc_delta(w, th,
                           (int(s.noise_q[e, j]) - int(s.noise_q[e - 1, j])) // d)
        else:
            w.write(int(s.noise_q[e, 0]) // d, 5)
            for j in range(1, t.n_q):
                _enc_delta(w, fh,
                           (int(s.noise_q[e, j]) - int(s.noise_q[e, j - 1])) // d)


def _write_harmonic(w: BitWriter, s: SBRFrameSpec, t: sbrmod.SBRTables) -> None:
    if s.add_harmonic is not None and s.add_harmonic.any():
        w.write(1, 1)
        for b in range(t.n_high):
            w.write(int(bool(s.add_harmonic[b])), 1)
    else:
        w.write(0, 1)


def sbr_payload(specs: list[SBRFrameSpec], h: sbrmod.SBRHeader,
                sample_rate_out: int, write_header: bool = True,
                coupling: bool = False, ps: "PSSpec | None" = None) -> bytes:
    """Build the sbr_extension_data bits for an SCE (1 spec) or CPE
    (2 specs).  With coupling=True both specs must share grid/invf and
    spec[1] carries balance values.  Returns whole bytes (caller wraps in
    a FIL element)."""
    t = sbrmod.derive_tables(h, sample_rate_out)
    w = BitWriter()
    w.write(sbrmod.EXT_SBR_DATA, 4)     # extension_type
    w.write(1 if write_header else 0, 1)
    if write_header:
        write_sbr_header(w, h)
    if len(specs) == 1:
        w.write(0, 1)  # bs_data_extra
        s = specs[0]
        _write_grid(w, s)
        _write_dtdf(w, s)
        for v in s.invf:
            w.write(v, 2)
        _write_envelope(w, s, h, t, balance=False)
        _write_noise(w, s, t, balance=False)
        _write_harmonic(w, s, t)
    else:
        w.write(0, 1)  # bs_data_extra
        w.write(1 if coupling else 0, 1)
        s0, s1 = specs
        if coupling:
            _write_grid(w, s0)
            _write_dtdf(w, s0)
            _write_dtdf(w, s1)
            for v in s0.invf:
                w.write(v, 2)
            _write_envelope(w, s0, h, t, balance=False)
            _write_noise(w, s0, t, balance=False)
            _write_envelope(w, s1, h, t, balance=True)
            _write_noise(w, s1, t, balance=True)
        else:
            _write_grid(w, s0)
            _write_grid(w, s1)
            _write_dtdf(w, s0)
            _write_dtdf(w, s1)
            for v in s0.invf:
                w.write(v, 2)
            for v in s1.invf:
                w.write(v, 2)
            _write_envelope(w, s0, h, t, balance=False)
            _write_envelope(w, s1, h, t, balance=False)
            _write_noise(w, s0, t, balance=False)
            _write_noise(w, s1, t, balance=False)
        _write_harmonic(w, s0, t)
        _write_harmonic(w, s1, t)
    if ps is not None and len(specs) == 1:
        tmp = BitWriter()
        write_ps_data(tmp, ps)
        nbits = tmp.bit_position + 2      # + extension id
        cnt = (nbits + 7) // 8
        w.write(1, 1)  # bs_extended_data
        if cnt >= 15:
            w.write(15, 4)
            w.write(cnt - 15, 8)
        else:
            w.write(cnt, 4)
        w.write(2, 2)  # EXTENSION_ID_PS
        for byte in tmp._buf:
            w.write(byte, 8)
        if tmp._ncached:
            w.write(tmp._cache, tmp._ncached)
        pad = cnt * 8 - nbits
        if pad:
            w.write(0, pad)
    else:
        w.write(0, 1)  # bs_extended_data
    w.align()
    return w.getvalue()


def write_sbr_fil(w: BitWriter, payload: bytes) -> None:
    """Wrap an sbr_extension_data payload in a FIL element
    (decoder.js:187-193 framing; count covers the payload bytes)."""
    count = len(payload)
    w.write(6, 3)  # FIL
    if count >= 15:
        w.write(15, 4)
        w.write(count - 14, 8)
    else:
        w.write(count, 4)
    for b in payload:
        w.write(b, 8)


@dataclass
class PSSpec:
    """Parametric Stereo payload (HE-AAC v2 test streams): baseline PS
    with IID/ICC in delta-freq coding, header on every frame."""
    iid_mode: int = 0                   # 0/1/2 coarse 10/20/34 bands
    icc_mode: int = 0
    num_env: int = 1                    # 0,1,2,4 (frame class 0)
    iid_par: np.ndarray | None = None   # [num_env, nr] quantized indices
    icc_par: np.ndarray | None = None
    ipd_par: np.ndarray | None = None   # [num_env, nr_ipdopd] in 0..7
    opd_par: np.ndarray | None = None   # (written as PS extension id 0)
    ipd_off: bool = False               # write ext with enable_ipdopd=0
                                        # (explicit OFF, vs ext absent)


def write_ps_data(w: BitWriter, spec: PSSpec) -> None:
    from aacjax_torch.host import ps as psmod
    books = psmod._books()

    def enc(book, value):
        ln, code = book.enc[(int(value),)]
        w.write(code, ln)

    w.write(1, 1)                        # bs_enable_ps_header
    w.write(1 if spec.iid_par is not None else 0, 1)
    if spec.iid_par is not None:
        w.write(spec.iid_mode, 3)
    w.write(1 if spec.icc_par is not None else 0, 1)
    if spec.icc_par is not None:
        w.write(spec.icc_mode, 3)
    has_ext = spec.ipd_par is not None or spec.ipd_off
    w.write(1 if has_ext else 0, 1)      # bs_enable_ext
    w.write(0, 1)                        # frame_class FIX
    w.write({0: 0, 1: 1, 2: 2, 4: 3}[spec.num_env], 2)
    if spec.iid_par is not None:
        dfb = books["iid_df1"] if spec.iid_mode >= 3 else books["iid_df0"]
        for e in range(spec.num_env):
            w.write(0, 1)                # delta-freq
            acc = 0
            for v in spec.iid_par[e]:
                enc(dfb, int(v) - acc)
                acc = int(v)
    if spec.icc_par is not None:
        for e in range(spec.num_env):
            w.write(0, 1)
            acc = 0
            for v in spec.icc_par[e]:
                enc(books["icc_df"], int(v) - acc)
                acc = int(v)
    if has_ext:
        # PS extension id 0: IPD/OPD (delta-freq, raw mod-8 symbols)
        ext = BitWriter()
        ext.write(0, 2)                  # ps_extension_id
        ext.write(0 if spec.ipd_off else 1, 1)   # enable_ipdopd
        for e in range(0 if spec.ipd_off else spec.num_env):
            for name, par in (("ipd", spec.ipd_par), ("opd", spec.opd_par)):
                ext.write(0, 1)          # delta-freq
                acc = 0
                for v in par[e]:
                    d = (int(v) - acc) & 7
                    ln, code = books[f"{name}_df"].enc[(d,)]
                    ext.write(code, ln)
                    acc = int(v)
        ext.write(0, 1)                  # reserved_ps
        nbits = ext.bit_position
        cnt = (nbits + 7) // 8
        if cnt >= 15:
            w.write(15, 4)
            w.write(cnt - 15, 8)
        else:
            w.write(cnt, 4)
        ext.align()
        for byte in ext.getvalue():
            w.write(byte, 8)
