"""The comparison that decides `correct`: the int16 PCM the timed path
yielded in the window against the plain reference (portbench/reference),
which decodes the same corpus bytes in float64, in worker processes, once
the window has closed and the program's state is freed.

Two samples, drawn from the seed:

  * `pairs` (AAC-LC): per chunk the rows of one slot are kept, chunk k's
    the (k mod slots)-th of a seeded order of the slots, so any run of as
    many chunks as slots keeps every slot once; after the window, `pairs`
    of the window's chunks are drawn and each kept (slot, chunk) is
    compared.  An AAC-LC decoder's state
    after frame n - 1 (the overlap and the window shape) is a function of
    frame n - 1 alone, so the reference decodes the chunk's frames after
    the frame before them (none for a slot's first chunk, which starts
    from silence as the program's slot does);
  * `slots` (HE-AAC): the rows of `slots` slots drawn from the seed are
    kept for every chunk; the SBR state (QMF histories, the noise and
    sine indices, the envelope and smoothing state) runs from a stream's
    first frame, so the reference decodes each slot from its start frame
    through the warm-up and every loop wrap to the window's last chunk,
    and every window chunk of it is compared.

The numbers compared: `max_lsb`, the largest |program - reference| over
every compared sample, in int16 steps; `share_ne`, the share of compared
samples that differ at all.  Each has its limit in the configuration
(`check.limits`), set from the readings in PERF.md.

The reference decoder is the module of portbench/reference/ that the
configuration names (registry.reference_file; reference/decode.py says
what it gives).  Stream s's output is rows s * ROWS ... s * ROWS +
OUT_CHANNELS - 1 of the program's PCM, as its route declares
(routes/__init__.py; the configuration's `channels` for both where the
route declares neither).
"""
from __future__ import annotations

import concurrent.futures
import functools
import importlib.util
import multiprocessing
import os
import pathlib
import sys

import numpy as np

from portbench import registry
from portbench.corpus import Feed, adts_payloads, seed_rng


@functools.lru_cache(maxsize=64)
def _stream(path: str) -> list[bytes]:
    return adts_payloads(pathlib.Path(path).read_bytes())


@functools.lru_cache(maxsize=None)
def _reference_module(path: str):
    """The reference decoder module in the file `path`, loaded once a
    process."""
    name = f"portbench_reference_file_{pathlib.Path(path).stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_pcm(path: str, module: str, facts: dict,
                  frames: tuple[int, ...], skip: int,
                  precision: str) -> np.ndarray:
    """The reference's int16 PCM [n - skip, samples, output channels] of
    frames `frames` of the stream at `path`, decoded in order from a fresh
    decoder that the module in the file `module` makes from `facts` in
    `precision`, the first `skip` decoded but not returned.  Runs in a
    worker process: imports nothing of the program."""
    from portbench.reference.decode import to_int16
    pays = _stream(path)
    dec = _reference_module(module).decoder(facts, precision)
    out = [dec.decode(pays[f]) for f in frames]
    return to_int16(np.stack(out[skip:]))


def compare(got: np.ndarray, want: np.ndarray) -> tuple[int, int, int]:
    """(largest |got - want|, samples that differ, samples)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), int((d != 0).sum()), int(d.size)


class Check:
    """Keeps the sampled rows of each chunk the program yields, and after
    the window compares them with the reference."""

    def __init__(self, kind: str, seed: int, feed: Feed, config: dict,
                 spec: dict, files: list[pathlib.Path], sbr: bool,
                 rows: int | None = None, out_channels: int | None = None):
        self.seed, self.feed, self.spec = seed, feed, spec
        self.files = [str(f) for f in files]
        self.rows = rows or config["channels"]
        self.out_channels = out_channels or config["channels"]
        self.module = str(registry.reference_file(config))
        self.facts = {**{k: v for k, v in config.items() if k != "corpus"},
                      "sbr": sbr}
        self.limits = config["check"]["limits"]
        n = len(feed.slots)
        self.kind = kind
        if self.kind == "pairs":
            self._order = seed_rng(seed, 2).permutation(n).tolist()
        elif self.kind == "slots":
            rng = seed_rng(seed, 2)
            self.slots = sorted(rng.choice(n, min(spec["slots"], n),
                                           replace=False).tolist())
        else:
            raise ValueError(f"unknown check kind {self.kind!r}")
        self.kept: dict = {}

    def keep(self, k: int, pcm: np.ndarray) -> None:
        rows, ch = self.rows, self.out_channels
        if self.kind == "pairs":
            s = self._order[k % len(self._order)]
            self.kept[k] = {s: pcm[s * rows:s * rows + ch].copy()}
        else:
            self.kept[k] = {s: pcm[s * rows:s * rows + ch].copy()
                            for s in self.slots}

    def _tasks(self, window: list[int]) -> list[tuple]:
        """(slot, [chunks], frames, skip) per reference call."""
        T = self.feed.T
        if self.kind == "pairs":
            rng = seed_rng(self.seed, 3)
            ks = sorted(rng.choice(window, min(self.spec["pairs"],
                                               len(window)),
                                   replace=False).tolist())
            out = []
            for k in ks:
                for s in sorted(self.kept[k]):
                    frames = self.feed.frames(s, k)
                    if k:
                        frames = self.feed.frames(s, k - 1)[-1:] + frames
                    out.append((s, [k], frames, len(frames) - T))
            return out
        last = window[-1]
        return [(s, window, [f for k in range(last + 1)
                             for f in self.feed.frames(s, k)],
                 window[0] * T) for s in self.slots]

    def run(self, window: list[int], control: str | None = None,
            workers: int | None = None) -> dict:
        """The readings over the window's sample: the program's kept rows
        against the float64 reference, or with `control` (a precision of
        reference/precision.py) the reference in that precision put in
        the program's place."""
        if not window:
            return {"compared_chunks": 0}
        tasks = self._tasks(window)
        want = self._decode(tasks, "exact", workers)
        got = (self._decode(tasks, control, workers) if control else None)
        worst, ne, n = 0, 0, 0
        T = self.feed.T
        for i, (s, ks, _, _) in enumerate(tasks):
            ref = want[i]                       # [chunks * T, samples, ch]
            for j, k in enumerate(ks):
                w = ref[j * T:(j + 1) * T].transpose(2, 0, 1)
                g = (self.kept[k][s] if got is None
                     else got[i][j * T:(j + 1) * T].transpose(2, 0, 1))
                m, d, c = compare(g, w)
                worst, ne, n = max(worst, m), ne + d, n + c
        return {"max_lsb": worst, "share_ne": ne / n, "samples": n,
                "compared_chunks": sum(len(t[1]) for t in tasks),
                "compared_slots": len({t[0] for t in tasks})}

    def _decode(self, tasks, precision: str, workers: int | None):
        args = [(self.files[self.feed.slots[s][0]], self.module,
                 self.facts, tuple(frames), skip, precision)
                for s, _, frames, skip in tasks]
        n = workers or max(1, min(len(args), (os.cpu_count() or 2) - 1, 8))
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(n, mp_context=ctx) as ex:
            return list(ex.map(reference_pcm, *zip(*args)))

    def verdict(self, readings: dict) -> tuple[bool, dict]:
        """correct, and each number beside its limit."""
        if not readings.get("compared_chunks"):
            return False, {"compared_chunks": {"value": 0, "limit": 1}}
        shown = {k: {"value": readings[k], "limit": self.limits[k]}
                 for k in ("max_lsb", "share_ne")}
        ok = all(readings[k] <= self.limits[k] for k in shown)
        return ok, shown
