"""Public API: `decode_adts` on its AAC-LC route.

Counterpart of `aacjax/api.py` `decode_adts` (the ADTS checks, the HE-AAC
probe and the single-raw_data_block LC route through the pipelined batch
runtime).  The other routes raise NotImplementedError naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from aacjax_torch.host import adts, native
from aacjax_torch.host.asc import UnsupportedError, parse_asc
from aacjax_torch.host.bitio import BitReader, BitstreamError
from aacjax_torch.host.syntax import decode_frame
from aacjax_torch.runtime.batch import LC_PROFILE, BatchDecoder


def _probe_sbr_ps(data: bytes, frames, config) -> tuple[bool, bool]:
    """Implicitly signalled HE-AAC: does the first frame carry an SBR FIL
    extension, and a ps_data payload?  (Throwaway python parse.)"""
    from aacjax_torch.host.sbr import SBRContext
    _, s, e = frames[0]
    try:
        f = decode_frame(BitReader(data[s:e]), config, [0] * config.channels,
                         sbr_ctx=SBRContext(2 * config.sample_rate))
    except Exception:  # noqa: BLE001 — probe only
        return False, False
    sfs = [getattr(el, "sbr", None) for el in f.elements]
    return (any(sf is not None for sf in sfs),
            any(getattr(sf, "ps", None) is not None for sf in sfs))


def decode_adts(data: bytes, chunk_frames: int = 64, cce_slots: int = 2,
                on_error: str = "raise", drc_scale: float = 0.0,
                verify_crc: bool = False,
                device: str | torch.device = "cuda") -> tuple[np.ndarray, int]:
    """Decode a whole AAC-LC ADTS byte stream on `device`.

    Returns (pcm [total_samples, channels] float32 in 1/32768 scale,
    sample_rate).  on_error='raise' aborts on the first malformed frame;
    'skip' conceals it as silence and continues.  verify_crc=True checks
    each protected frame's crc_check first.  drc_scale in [0, 1] applies
    that fraction of any dynamic_range_info gains.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error: {on_error}")
    frames = adts.split_frames(data)
    if not frames:
        raise UnsupportedError("no ADTS frames found")
    if verify_crc:
        checked = []
        for i, (h, s, e) in enumerate(frames):
            # the CRC covers header bits too: rewind to the syncword
            if adts.check_crc(data[s - h.header_bytes: e], h):
                checked.append((h, s, e))
            elif on_error == "raise":
                raise BitstreamError(f"ADTS frame {i}: crc_check mismatch")
            else:
                # an empty payload fails to parse and is concealed
                checked.append((h, s, s))
        frames = checked
    header = frames[0][0]
    config = parse_asc(adts.synthesize_cookie(header))
    if config.profile != LC_PROFILE:
        raise NotImplementedError(
            f"profile {config.profile}: only AAC-LC is ported (LTP: ROADMAP "
            "Queue 1 item 4; Main: item 6)")
    has_sbr, has_ps = _probe_sbr_ps(data, frames, config)
    if has_sbr:
        raise NotImplementedError(
            f"HE-AAC {'v2 (SBR + PS)' if has_ps else 'v1 (SBR)'} is not "
            "ported yet (ROADMAP Queue 1 items 8 and 9)")
    if any(h.num_frames > 1 for h, _, _ in frames):
        raise NotImplementedError(
            "ADTS frames with several raw_data_blocks decode through the "
            "streaming decoder, not ported yet (ROADMAP Queue 1 item 4)")
    dec = BatchDecoder([config], chunk_frames=chunk_frames,
                       cce_slots=cce_slots, drc_scale=drc_scale,
                       device=device)
    payloads = [data[s:e] for _, s, e in frames]
    starts = range(0, len(payloads), chunk_frames)
    sizes = [min(chunk_frames, len(payloads) - i) for i in starts]
    chunks = ([payloads[i:i + chunk_frames]] for i in starts)
    out = []
    for k, pcm in enumerate(dec.decode_pipelined(chunks, out_int16=False,
                                                 compact=False)):
        st = dec.streams[0]
        if st.failed:
            if any(int(c) == native.ERR_DELEGATE for c in dec._last_status):
                raise NotImplementedError(
                    "the native parser delegates this content to the python "
                    "packer path (ROADMAP Queue 1 item 7)")
            if on_error == "raise":
                raise UnsupportedError(f"stream failed: {st.last_error}")
            st.failed = False  # concealed; keep decoding
        out.append(dec.stream_pcm(pcm, 0, sizes[k]))
    return np.concatenate(out, axis=0), config.sample_rate
