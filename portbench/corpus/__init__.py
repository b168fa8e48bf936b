"""The frozen corpus and the traffic generator over it.

`load` reads a configuration's ADTS streams (each checked against its
sha256) and its frame table; `assign_slots` gives each of a cell's slots
a (stream, start frame) from the seed; `Feed` hands the program chunk
after chunk, each slot reading its stream from its start frame on and
looping at the end, for as long as the window asks.
"""
from __future__ import annotations

import hashlib
import pathlib
import time
from dataclasses import dataclass

import numpy as np

FLAG_TNS, FLAG_SHORT, FLAG_NOT_QSF = 1, 2, 4


class CorpusError(RuntimeError):
    pass


def adts_payloads(data: bytes) -> list[bytes]:
    """The raw_data_block payloads of an ADTS stream of one block a frame:
    each frame's 7-byte header (9 with CRC) stripped."""
    out, pos = [], 0
    while pos + 7 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] & 0xF6 != 0xF0:
            raise CorpusError(f"no ADTS sync word at byte {pos}")
        head = 7 if data[pos + 1] & 1 else 9
        length = (((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3)
                  | (data[pos + 5] >> 5))
        if data[pos + 6] & 3:
            raise CorpusError("an ADTS frame of several raw_data_blocks")
        out.append(data[pos + head:pos + length])
        pos += length
    return out


@dataclass
class Corpus:
    payloads: list[list[bytes]]       # per stream, per frame
    flags: list[np.ndarray]           # per stream, per frame (FLAG_*)
    files: list[pathlib.Path]


def _checked(root: pathlib.Path, rel: str, sha256: str) -> bytes:
    data = (root / rel).read_bytes()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise CorpusError(f"{rel}: sha256 {got}, the configuration says "
                          f"{sha256}")
    return data


def load(config: dict, root: pathlib.Path) -> Corpus:
    """The configuration's corpus, every file checked against its hash."""
    import json
    spec = config["corpus"]
    table = json.loads(_checked(root, spec["frames_file"],
                                spec["frames_sha256"]))
    payloads, flags, files = [], [], []
    for f in spec["files"]:
        pays = adts_payloads(_checked(root, f["file"], f["sha256"]))
        digits = table[f["file"]]
        if len(pays) != f["frames"] or len(digits) != f["frames"]:
            raise CorpusError(f"{f['file']}: {len(pays)} frames, "
                              f"{len(digits)} flags, {f['frames']} listed")
        payloads.append(pays)
        flags.append(np.array([int(d, 16) for d in digits], np.uint8))
        files.append(root / f["file"])
    return Corpus(payloads, flags, files)


def seed_rng(seed: int, purpose: int) -> np.random.Generator:
    """An independent generator for each use of the run's seed (any whole
    number, negative or past 32 bits)."""
    return np.random.default_rng([int(seed) % 2 ** 64, purpose])


def assign_slots(seed: int, lengths: list[int], n_slots: int,
                 spacing: int) -> list[tuple[int, int]]:
    """Each slot's (stream, start frame).  Slot j reads stream j mod S of
    a seed-shuffled order, so every seed loads every stream with the same
    number of slots (the same work in another order); the k slots of one
    stream start evenly spread around its loop from a seeded phase, at
    least `spacing` frames apart, so no two slots decode the same frame in
    one chunk (and, with `spacing` two chunks, a payload is seen again
    only after a whole chunk of other payloads)."""
    rng = seed_rng(seed, 1)
    n_streams = len(lengths)
    order = rng.permutation(n_streams)
    per = [0] * n_streams
    for j in range(n_slots):
        per[order[j % n_streams]] += 1
    starts = {}
    for s in range(n_streams):
        k, length = per[s], lengths[s]
        if k and length // k < spacing:
            raise CorpusError(f"stream {s}: {k} slots of {length} frames "
                              f"cannot start {spacing} frames apart")
        phase = int(rng.integers(length))
        starts[s] = [(phase + (i * length) // k) % length for i in range(k)]
    slots = [(int(order[j % n_streams]), 0) for j in range(n_slots)]
    taken = {s: 0 for s in range(n_streams)}
    for j, (s, _) in enumerate(slots):
        slots[j] = (s, starts[s][taken[s]])
        taken[s] += 1
    return [slots[i] for i in rng.permutation(n_slots)]


class Feed:
    """The closed loop's iterator: chunk k holds, for every slot, frames
    start + kT ... start + kT + T - 1 of its stream (modulo its length).
    Records when each chunk was handed over; `stop()` ends it at the next
    request."""

    def __init__(self, corpus: Corpus, slots: list[tuple[int, int]],
                 chunk_frames: int):
        self.corpus, self.slots, self.T = corpus, slots, chunk_frames
        self.handed: list[float] = []
        self._stopped = False

    def frames(self, slot: int, k: int) -> list[int]:
        s, start = self.slots[slot]
        n = len(self.corpus.payloads[s])
        return [(start + k * self.T + t) % n for t in range(self.T)]

    def chunk(self, k: int) -> list[list[bytes]]:
        T = self.T
        out = []
        for s, start in self.slots:
            pays = self.corpus.payloads[s]
            n = len(pays)
            lo = (start + k * T) % n
            out.append(pays[lo:lo + T] if lo + T <= n
                       else pays[lo:] + pays[:lo + T - n])
        return out

    def chunk_flags(self, k0: int, k1: int) -> np.ndarray:
        """The OR of the frame flags of chunks k0 ... k1 - 1, [k1 - k0]."""
        ks = np.arange(k0, k1)[:, None] * self.T + np.arange(self.T)
        acc = np.zeros(k1 - k0, np.uint8)
        for s, start in self.slots:
            fl = self.corpus.flags[s]
            acc |= np.bitwise_or.reduce(fl[(start + ks) % len(fl)], axis=1)
        return acc

    def stop(self) -> None:
        self._stopped = True

    def __iter__(self):
        k = 0
        while not self._stopped:
            chunk = self.chunk(k)
            self.handed.append(time.perf_counter())
            yield chunk
            k += 1
