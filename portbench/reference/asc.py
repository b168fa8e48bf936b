"""The stream configuration the parse reads: AAC-LC (audio object type 2)
with 1024-sample frames, its sampling-frequency index and channel
configuration.  HE-AAC v1 streams of implicit signalling carry the same
configuration, their SBR found in FIL elements at decode time."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference import tables

AOT_AAC_LC = 2


class UnsupportedError(Exception):
    """Feature present in the bitstream that this reference rejects."""


@dataclass(frozen=True)
class StreamConfig:
    profile: int
    sample_index: int
    sample_rate: int          # core decoder rate (tables are indexed by it)
    chan_config: int
    frame_length: int = 1024

    @property
    def channels(self) -> int:
        # chanConfig equals the channel count for 1..6; 7 is 7.1
        # (ISO/IEC 14496-3 Table 1.19)
        return {7: 8}.get(self.chan_config, self.chan_config)

    @property
    def short_length(self) -> int:
        return self.frame_length // 8

    @property
    def swb_offsets_long(self) -> np.ndarray:
        return tables.SWB_OFFSET_1024[self.sample_index]

    @property
    def swb_offsets_short(self) -> np.ndarray:
        return tables.SWB_OFFSET_128[self.sample_index]

    @property
    def swb_count_long(self) -> int:
        return int(tables.SWB_LONG_WINDOW_COUNT[self.sample_index])

    @property
    def swb_count_short(self) -> int:
        return int(tables.SWB_SHORT_WINDOW_COUNT[self.sample_index])


def stream_config(profile: int, sample_index: int,
                  chan_config: int) -> StreamConfig:
    if profile != AOT_AAC_LC:
        raise UnsupportedError(f"audio object type {profile}")
    if not 1 <= chan_config <= 7:
        raise UnsupportedError(f"channelConfiguration {chan_config}")
    return StreamConfig(profile=profile, sample_index=sample_index,
                        sample_rate=int(tables.SAMPLE_RATES[sample_index]),
                        chan_config=chan_config)
